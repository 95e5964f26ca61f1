#!/usr/bin/env python3
"""Time the port's kernels of several source trees in turns on one CUDA
card, by chip_smoke.py's own method (its ``measure`` and
``measure_layer_kernels``, unchanged).

    python3 kernel_turns.py OLD . . OLD

Each argument is the root of a checkout (the directory holding
``src/repro_torch``), say a parent commit unpacked with ``git archive`` into
a directory ``.gitignore`` lists, and this tree. Each is timed in a process
of its own, in the order given, so that two generations of the kernels are
compared on the same card in turns: old, new, new, old. The process imports
that tree's ``repro_torch`` and then this tree's ``chip_smoke``, whose
functions then run on the tree's kernels; a tree's kernels build into its
own ``build/repro_torch``. Every tree must hold the modules and the five
kernel sources this ``chip_smoke`` imports and builds (``repro_torch.random``,
``kernels/threefry``, ``launch/train``, ``train/tnn_trainer``: trees from
the training slice on).

Shapes are chip_smoke's served ones: ``stdp_update`` layers 1 and 2 at
B = 16 and ``wta`` on (64 * 625, 12); ``tnn_wave`` forward at B = 64 and
learning at B = 16, theta = (24, 8), and ``tnn_column`` layers 1 and 2 at
B = 64, whose sources two generations may share, as a check on the spread
between turns. Prints one JSON line per tree (ms, plain ms and CUDA-event
ms per call of each kernel: the events include the wrapper's host time),
then the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def time_tree(tree: str) -> dict:
    """chip_smoke's timings of the kernels of ``tree`` (run in a fresh
    process: it imports that tree's ``repro_torch``)."""
    root = os.path.abspath(tree)
    sys.path.insert(0, os.path.join(root, "src"))
    import repro_torch
    if not repro_torch.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {repro_torch.__file__}, not the tree {root}")
    sys.path.insert(1, HERE)
    import chip_smoke
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card")
    dev = torch.device("cuda:0")
    chip_smoke._build.build_all(chip_smoke.KERNELS)
    cfg = chip_smoke.network_config(625, 24, 8, impl="fused")
    wave = chip_smoke.measure(cfg, dev)
    layers = chip_smoke.measure_layer_kernels(dev)
    keys = ("ms", "plain_ms", "events_ms")
    out = {"tree": tree}
    for half in ("forward", "learn"):
        out["wave_" + half] = {k: wave[half][k] for k in keys}
    for name, t in layers.items():
        out[name] = {k: t[k] for k in keys}
        for l, tl in enumerate(t.get("per_layer") or [], start=1):
            out[f"{name}_l{l}"] = {k: tl[k] for k in keys}
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(time_tree(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in argv:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: none")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
