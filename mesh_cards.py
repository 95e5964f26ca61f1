#!/usr/bin/env python3
"""The port's (data, model) mesh over NCCL, one card per rank, held to one
process, through the launchers a user runs.

    python3 mesh_cards.py                           # 4 CUDA cards
    python3 mesh_cards.py --device cpu --sites 16 --colpar-batch 8   # CPU, gloo

First in one process, then for each mesh of 2x2, 4x1 and 1x4 under ``torchrun
--standalone --nproc-per-node D*M`` with ``--mesh DxM``:

* the train launcher, one epoch at ``--sites`` (625: 32 waves of 16, a
  checkpoint every 16 waves), ``--impl pallas`` and ``--impl fused
  --superbatch-k 4``;
* the serve launcher learning while serving from the one-process run's
  wave-16 checkpoint (``--online-stdp --superbatch-k 4 --swap-every 4``,
  1,024 requests, 64 slots), its swap checkpoints written into a copy of
  that checkpoint's directory.

Every checkpoint a meshed run writes must equal the one-process run's, file
for file (the weights, key, wave and vote tables, and the metadata). Then
the dry run's column-parallel ``tnn_train_8k`` (640 sites, pallas and
fused) on 1x4 beside the unmeshed 640-site wave. Each run's rate and wall
time are printed beside the cards' ``nvidia-smi`` lines, then one JSON line
with every number. The launchers print only on rank 0, so a rate is rank
0's. Each command has 600 s. Exits 2 when fewer than 4 cards are visible.
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SERVE_RATE = re.compile(r"\[serve-stats\] ([0-9.]+) waves/s +([0-9.]+) images/s +"
                        r"p50 ([0-9.]+) ms +p95 ([0-9.]+) ms")
MESHES = ("2x2", "4x1", "1x4")
RANKS = 4
TIMEOUT_S = 600.0


def run(cmd, ranks: int):
    """``cmd`` (a module and its arguments) in one process, or under
    torchrun with ``ranks`` processes; returns (stdout, wall seconds)."""
    if ranks > 1:
        cmd = ["-m", "torch.distributed.run", "--standalone",
               f"--nproc-per-node={ranks}", "-m", *cmd]
    else:
        cmd = ["-m", *cmd]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, *cmd], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=TIMEOUT_S)
    wall = time.perf_counter() - t0
    if out.returncode:
        raise SystemExit(f"{' '.join(cmd)} failed ({out.returncode}):\n"
                         f"{out.stdout[-3000:]}\n{out.stderr[-5000:]}")
    return out.stdout, wall


def train(args, impl: str, k: int, ckpt: str, mesh: str = ""):
    cmd = ["repro_torch.launch.train", "--arch", "tnn-mnist", "--sites",
           str(args.sites), "--impl", impl, "--superbatch-k", str(k),
           "--ckpt-every", "16", "--ckpt-dir", ckpt, "--device", args.device]
    n = 1
    if mesh:
        d, m = (int(v) for v in mesh.split("x"))
        cmd += ["--mesh", mesh]
        n = d * m
    out, wall = run(cmd, n)
    summary = ast.literal_eval(next(line for line in reversed(out.splitlines())
                                    if line.startswith("{'final_wave'")))
    return {"waves_per_s": summary["waves_per_s"], "wall_s": wall,
            "accuracy": summary["accuracy"]}


def serve(args, ckpt: str, mesh: str = ""):
    cmd = ["repro_torch.launch.serve", "--arch", "tnn-mnist", "--sites",
           str(args.sites), "--slots", "64", "--requests", "1024",
           "--superbatch-k", "4", "--online-stdp", "--swap-every", "4",
           "--from-ckpt", ckpt, "--device", args.device]
    n = 1
    if mesh:
        d, m = (int(v) for v in mesh.split("x"))
        cmd += ["--mesh", mesh]
        n = d * m
    out, wall = run(cmd, n)
    m = SERVE_RATE.search(out)
    return {"waves_per_s": float(m.group(1)), "images_per_s": float(m.group(2)),
            "p50_ms": float(m.group(3)), "p95_ms": float(m.group(4)), "wall_s": wall}


def same_checkpoints(want: str, got: str, what: str) -> int:
    """Every step directory and file of ``want`` equal in ``got``, byte for
    byte; returns the number of files compared."""
    steps = sorted(s for s in os.listdir(want) if s.startswith("step_"))
    if steps != sorted(s for s in os.listdir(got) if s.startswith("step_")):
        raise SystemExit(f"{what}: steps {os.listdir(got)} != {steps}")
    n = 0
    for step in steps:
        for f in sorted(os.listdir(os.path.join(want, step))):
            with open(os.path.join(want, step, f), "rb") as a, \
                    open(os.path.join(got, step, f), "rb") as b:
                if a.read() != b.read():
                    raise SystemExit(f"{what}: {step}/{f} differs")
            n += 1
    return n


def seeded_from(src: str, dst: str) -> str:
    """A fresh directory holding ``src``'s first checkpoint alone (wave 16
    of the 625-site epoch)."""
    shutil.rmtree(dst, ignore_errors=True)
    os.makedirs(dst)
    first = min(s for s in os.listdir(src) if s.startswith("step_"))
    shutil.copytree(os.path.join(src, first), os.path.join(dst, first))
    return dst


def colpar(args, out_dir: str):
    """The unmeshed 640-site tnn_train_8k, then the column-parallel cell on
    1x4; rank 0's (and the one process's) wave ms and collective bytes."""
    cut = ["--batch", str(args.colpar_batch)] if args.colpar_batch else []
    common = ["--arch", "tnn-mnist", "--cell", "tnn_train_8k", "--impl",
              "pallas,fused", "--device", args.device, *cut]
    run(["repro_torch.launch.dryrun", *common, "--sites", "640", "--out",
         os.path.join(out_dir, "one")], 1)
    run(["repro_torch.launch.dryrun", *common, "--colpar", "--colpar-mesh", "1x4",
         "--out", os.path.join(out_dir, "1x4")], RANKS)
    res = {}
    for impl in ("pallas", "fused"):
        with open(os.path.join(out_dir, "one", f"tnn-mnist__tnn_train_8k_{impl}__1.json")) as f:
            one = json.load(f)
        with open(os.path.join(out_dir, "1x4",
                               f"tnn-mnist__tnn_train_8k_{impl}_colpar__1x4.json")) as f:
            mesh = json.load(f)
        for r in (one, mesh):
            if r["status"] != "ok":
                raise SystemExit(f"colpar {impl}: {r.get('error')}")
        res[impl] = {"one_process_wave_ms": one["wave_ms"],
                     "rank0_wave_ms": mesh["wave_ms"],
                     "collectives": {k: v for k, v in mesh["collectives"].items() if v}}
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sites", type=int, default=625)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--colpar-batch", type=int, default=None,
                    help="cut the column-parallel cell's 8,192 images (a rehearsal)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "mesh_cards"))
    args = ap.parse_args()
    import torch

    if args.device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < RANKS:
            print(f"the meshes need {RANKS} CUDA cards, one per rank; {have} visible",
                  file=sys.stderr)
            return 2
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True).stdout.strip()
    else:
        smi = "cpu"
    print(f"cards: {smi.splitlines()}", flush=True)
    shutil.rmtree(args.out, ignore_errors=True)
    os.makedirs(args.out)
    res = {"sites": args.sites, "device": args.device, "cards": smi.splitlines()}
    base = {}
    for impl, k in (("pallas", 1), ("fused", 4)):
        d = os.path.join(args.out, f"one_{impl}")
        base[impl] = d
        res[f"one_train_{impl}"] = train(args, impl, k, d)
        print(f"  one process, train {impl} K={k}: {res[f'one_train_{impl}']}", flush=True)
    one_serve = seeded_from(base["pallas"], os.path.join(args.out, "one_serve"))
    res["one_serve"] = serve(args, one_serve)
    print(f"  one process, online serve: {res['one_serve']}", flush=True)
    for mesh in MESHES:
        for impl, k in (("pallas", 1), ("fused", 4)):
            d = os.path.join(args.out, f"{mesh}_{impl}")
            r = res[f"{mesh}_train_{impl}"] = train(args, impl, k, d, mesh)
            r["files_equal"] = same_checkpoints(base[impl], d, f"{mesh} train {impl}")
            print(f"  mesh {mesh} over {'NCCL' if args.device == 'cuda' else 'gloo'}, "
                  f"train {impl} K={k} ({smi.splitlines()[0]}): {r}", flush=True)
        d = seeded_from(base["pallas"], os.path.join(args.out, f"{mesh}_serve"))
        r = res[f"{mesh}_serve"] = serve(args, d, mesh)
        r["files_equal"] = same_checkpoints(one_serve, d, f"{mesh} serve")
        print(f"  mesh {mesh}, online serve ({smi.splitlines()[0]}): {r}", flush=True)
    res["colpar_1x4"] = colpar(args, os.path.join(args.out, "dry"))
    print(f"  colpar tnn_train_8k on 1x4 ({smi.splitlines()[0]}): "
          f"{res['colpar_1x4']}", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
