"""The dry-run and roofline tables from the dry run's JSON, as
``repro.roofline.report`` prints them, for the port's rows:

    PYTHONPATH=src python -m repro_torch.roofline.report build/dryrun_lm > tables.md

The rows are the port's analytic LM rows (``launch.dryrun.run_lm_cell``):
per-rank bytes under the sharding rules on the logical 16x16 and 2x16x16
mesh shapes, fit against an H100's 80 GB, and roofline terms against the
H100's dense bf16 rate (``h100-sxm-bf16``); a row whose roofline is null
(no count in ``roofline.analysis``) is left out of the roofline table.
``--profile`` rescores every stored row against another
:class:`~repro_torch.roofline.analysis.MachineProfile`: the rows carry the
per-rank operations, bytes and collective bytes, so the three terms are
re-divided by that machine's peaks.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.roofline.analysis import H100_SXM_BF16, PROFILES, MachineProfile


def load_all(d: str) -> List[Dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(f) as fh:
            out.append(json.load(fh))
    return out


def _fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def _one_sentence_fix(r: Dict) -> str:
    """What would move the dominant term down (per-cell guidance)."""
    b = r["roofline"]["bottleneck"]
    if b == "compute":
        if r["roofline"]["useful_flop_fraction"] < 0.5:
            return ("shard the replicated attention path (sequence-parallel "
                    "q/k/v) and skip fully-masked causal KV chunks")
        return "already near useful-compute bound; fuse small elementwise ops"
    if b == "memory":
        return ("cut f32 intermediate materialization in the flash/score "
                "chain (bf16 accum tiles via the Pallas path) and enlarge "
                "kv_chunk to amortize operand re-reads")
    return ("reduce wire bytes: reduce-scatter gradients instead of "
            "all-reduce, overlap FSDP gathers with compute, or drop FSDP "
            "for the serving path")


def dryrun_section(rows: List[Dict]) -> str:
    out = ["## §Dry-run\n",
           "Every cell = the step's inputs priced under the sharding rules on "
           "the production mesh shape (single-pod 16x16 = 256 H100s, multi-pod "
           "2x16x16 = 512), analytic: no processes. `ok` = priced; skips are "
           "the documented long_500k full-attention exclusions.\n",
           "| arch | cell | mesh | status | compile s | per-chip args | "
           "analytic resident | fits 80G |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("arch") == "tnn-mnist":
            continue
        mem = r.get("memory", {})
        out.append(
            f"| {r['arch']} | {r['cell']} | {r['mesh']} | {r['status']} | "
            f"{r.get('compile_s', '—')} | "
            f"{_fmt_bytes(mem.get('analytic_args_bytes', 0)) if mem else '—'} | "
            f"{_fmt_bytes(mem.get('analytic_total_bytes', 0)) if mem else '—'} | "
            f"{'yes' if mem.get('fits_80g_hbm') else ('—' if r['status'] != 'ok' else 'NO')} |")
    n_ok = sum(r["status"] == "ok" for r in rows)
    n_skip = sum(r["status"] == "skip" for r in rows)
    n_err = sum(r["status"] == "error" for r in rows)
    out.append(f"\n**{n_ok} compiled, {n_skip} documented skips, {n_err} errors.**\n")
    return "\n".join(out)


def _rescore(rf: Dict, profile: Optional[MachineProfile]) -> Dict:
    """Re-divide one stored roofline row by another machine's peaks
    (``None`` keeps the stored terms)."""
    if profile is None:
        return rf
    t_comp = rf["hlo_flops_per_chip"] / profile.peak_flops
    t_mem = rf["hbm_bytes_per_chip"] / profile.hbm_bw
    t_coll = rf["collective_bytes_per_chip"] / profile.ici_bw
    t_bound = max(t_comp, t_mem, t_coll)
    bottleneck = {t_comp: "compute", t_mem: "memory", t_coll: "collective"}[t_bound]
    out = dict(rf)
    out.update(
        profile=profile.name,
        t_compute_s=t_comp, t_memory_s=t_mem, t_collective_s=t_coll,
        bottleneck=bottleneck,
        roofline_fraction=((rf["model_flops_per_chip"] / profile.peak_flops)
                           / t_bound if t_bound else 0.0))
    return out


def roofline_section(rows: List[Dict], profile: Optional[MachineProfile] = None) -> str:
    peaks = profile or H100_SXM_BF16
    out = ["## §Roofline\n",
           f"Terms in seconds/step/chip against the `{peaks.name}` profile: "
           f"compute = counted operations/{peaks.peak_flops:.3g}; memory = "
           f"counted bytes (this chip's share)/{peaks.hbm_bw:.3g}B/s; collective = "
           "modelled ring wire-bytes over the link bandwidth (the rules' "
           "per-layer FSDP and tensor-parallel collectives). "
           "`useful` = MODEL_FLOPS/counted operations (remat waste); "
           "`roofline` = (MODEL_FLOPS/peak)/max-term. Analytic rows, not "
           "measurements.\n",
           "| arch | cell | mesh | t_comp | t_mem | t_coll | bound | "
           "useful | roofline | what moves the bound |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] != "ok" or not r.get("roofline"):
            continue
        rf = _rescore(r["roofline"], profile)
        out.append(
            f"| {r['arch']} | {r['cell']} | {r['mesh']} | "
            f"{rf['t_compute_s']:.3g} | {rf['t_memory_s']:.3g} | "
            f"{rf['t_collective_s']:.3g} | {rf['bottleneck']} | "
            f"{rf['useful_flop_fraction']:.1%} | {rf['roofline_fraction']:.2%} | "
            f"{_one_sentence_fix(r)} |")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dryrun_dir", nargs="?", default="build/dryrun_lm")
    ap.add_argument("--profile", default=None, choices=sorted(PROFILES),
                    help="rescore the stored rows against this machine "
                         "profile's peaks (default: the stored terms, "
                         "h100-sxm-bf16)")
    args = ap.parse_args(argv)
    rows = load_all(args.dryrun_dir)
    profile = PROFILES[args.profile] if args.profile else None
    print(dryrun_section(rows))
    print()
    print(roofline_section(rows, profile))


if __name__ == "__main__":
    main()
