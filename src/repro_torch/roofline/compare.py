"""Baseline-vs-changed dry-run comparison, as ``repro.roofline.compare``:
the bound term of every row present and ``ok`` in both directories.

    PYTHONPATH=src python -m repro_torch.roofline.compare build/dryrun_lm \
        build/dryrun_lm_v2
"""
from __future__ import annotations

import sys

from repro_torch.roofline.report import load_all


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    base_dir = argv[0] if len(argv) > 0 else "build/dryrun_lm"
    opt_dir = argv[1] if len(argv) > 1 else "build/dryrun_lm_v2"
    base = {(r["arch"], r["cell"], r["mesh"]): r for r in load_all(base_dir)}
    opt = {(r["arch"], r["cell"], r["mesh"]): r for r in load_all(opt_dir)}
    print("| arch | cell | mesh | bound t before | after | Δ | roofline before | after |")
    print("|---|---|---|---|---|---|---|---|")
    improved = regressed = 0
    for key in sorted(base):
        b, o = base[key], opt.get(key)
        if not o or b.get("status") != "ok" or o.get("status") != "ok":
            continue
        rb, ro = b.get("roofline"), o.get("roofline")
        if not rb or not ro:   # a row without counts has no bound
            continue
        tb = max(rb["t_compute_s"], rb["t_memory_s"], rb["t_collective_s"])
        to = max(ro["t_compute_s"], ro["t_memory_s"], ro["t_collective_s"])
        delta = (to - tb) / tb if tb else 0.0
        if delta < -0.02:
            improved += 1
        elif delta > 0.02:
            regressed += 1
        print(f"| {key[0]} | {key[1]} | {key[2]} | {tb:.3g} | {to:.3g} | "
              f"{delta:+.1%} | {rb['roofline_fraction']:.2%} | "
              f"{ro['roofline_fraction']:.2%} |")
    print(f"\n**{improved} cells improved >2%, {regressed} regressed >2% "
          f"(of {len(base)} baseline cells).**")


if __name__ == "__main__":
    main()
