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
fused) on 1x4 beside the unmeshed 640-site wave.

Then the LM train launcher on llama3.2-3b at full size (28 layers), bf16
compute, 4 steps at 4 x 512 (``--lm-smoke``: its smoke config, for a CPU
rehearsal): in one process, then under 2x2 and 1x4 (the state DTensors
placed by the reference's rules). Each meshed run's losses are held to the
one process's within 1e-3 relative. Its final checkpoint's params are
compared with the one process's against the f32 tolerances of the CPU
tests (0.25 lr, and 1e-3 of the RMS distance they moved from the draw) and
the result is printed and recorded, not held: in bf16 compute the meshed
sums' order moves AdamW's normalised updates by up to a few lr (llama's
smoke config on the CPU: 2.7 lr, an RMS of 2.9% of the move). Its step ms
(rank 0's ``metrics.jsonl``), tokens/s and MFU by the spec tree (the dense
bf16 peak) are printed. The checkpoints are deleted once compared.

Each run's rate and wall time are printed beside the cards' ``nvidia-smi``
lines, then one JSON line with every number. The launchers print only on
rank 0, so a rate is rank 0's. Each command has 600 s. Exits 2 when fewer
than 4 cards are visible.
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


LM_MESHES = ("2x2", "1x4")
LM_ARGS = ["--arch", "llama3.2-3b", "--steps", "4", "--batch", "4", "--seq", "512"]


def lm_train(args, ckpt: str, mesh: str = ""):
    cmd = ["repro_torch.launch.train", *LM_ARGS, "--ckpt-dir", ckpt, "--device", args.device]
    if args.lm_smoke:
        cmd.append("--smoke")
    n = 1
    if mesh:
        d, m = (int(v) for v in mesh.split("x"))
        cmd += ["--mesh", mesh]
        n = d * m
    _, wall = run(cmd, n)
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return {"losses": [l["loss_total"] for l in lines], "step_s": [l["dt_s"] for l in lines],
            "wall_s": wall}


def lm_params(ckpt: str):
    """The final checkpoint's params, as numpy arrays by path."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.checkpoint.checkpointer import Checkpointer

    ck = Checkpointer(ckpt)
    d = os.path.join(ckpt, f"step_{ck.latest_step():08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    import numpy as np

    return {l["path"]: np.load(os.path.join(d, l["file"]), mmap_mode="r")
            for l in meta["leaves"] if l["path"].startswith("['params']")}


def lm(args, out_dir: str):
    """The LM launcher in one process, then under each of LM_MESHES, held
    to it; numbers by run."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import random as t_random
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_flatten
    from repro_torch.roofline import analysis as RL
    from repro_torch.train import optimizer as OPT

    cfg = smoke_config("llama3.2-3b") if args.lm_smoke else get_config("llama3.2-3b")
    batch, seq, steps = 4, 512, 4
    opt_cfg = OPT.OptConfig(warmup_steps=min(20, steps // 5 + 1), total_steps=steps)
    model_flops = RL.lm_train_work(cfg, opt_cfg, batch, seq)["model_flops"]
    res = {}
    one = os.path.join(out_dir, "one")
    res["one"] = lm_train(args, one)
    # the draw the runs start from, leaf by leaf, for the RMS of each move
    start = {"".join(f"[{k!r}]" for k in ("params",) + p): t.cpu().double().numpy()
             for p, t in tree_flatten(M.init_params(cfg, t_random.PRNGKey(0), args.device))}
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    want = lm_params(one)
    lr = opt_cfg.lr
    for mesh in LM_MESHES:
        d = os.path.join(out_dir, mesh)
        r = res[mesh] = lm_train(args, d, mesh)
        for a, b in zip(r["losses"], res["one"]["losses"]):
            if not abs(a - b) <= 1e-3 * abs(b):
                raise SystemExit(f"LM {mesh}: losses {r['losses']} vs {res['one']['losses']}")
        got, worst_max, worst_rms = lm_params(d), 0.0, 0.0
        for path, w in want.items():
            diff = np.abs(np.asarray(got[path], np.float64) - np.asarray(w, np.float64))
            moved = float(np.sqrt(np.mean((np.asarray(w, np.float64) - start[path]) ** 2)))
            dmax, drms = float(diff.max()), float(np.sqrt(np.mean(diff ** 2)))
            worst_max, worst_rms = max(worst_max, dmax / lr), max(worst_rms, drms / moved)
        r.update(param_max_diff_in_lr=worst_max, param_rms_diff_of_move=worst_rms,
                 params_within_f32_tolerances=worst_max <= 0.25 and worst_rms <= 1e-3)
        shutil.rmtree(d, ignore_errors=True)
    shutil.rmtree(one, ignore_errors=True)
    del start
    for name, r in res.items():
        step_s = float(np.median(r["step_s"][1:])) if len(r["step_s"]) > 1 else r["step_s"][0]
        r.update(step_ms_median=1e3 * step_s, tokens_per_s=batch * seq / step_s,
                 mfu=RL.lm_mfu(model_flops, step_s))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sites", type=int, default=625)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--colpar-batch", type=int, default=None,
                    help="cut the column-parallel cell's 8,192 images (a rehearsal)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "mesh_cards"))
    ap.add_argument("--lm-smoke", action="store_true",
                    help="the LM part at llama3.2-3b's smoke config (a rehearsal)")
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
    res["lm"] = lm(args, os.path.join(args.out, "lm"))
    for name, r in res["lm"].items():
        print(f"  LM train launcher llama3.2-3b{' (smoke)' if args.lm_smoke else ''}, "
              f"{name} ({'NCCL' if args.device == 'cuda' and name != 'one' else '1 process' if name == 'one' else 'gloo'}"
              f", {smi.splitlines()[0]}): losses {r['losses']}, step ms median "
              f"{r['step_ms_median']:.1f}, {r['tokens_per_s']:.0f} tokens/s, MFU "
              f"{r['mfu']:.4f}" + (f", params vs one process: max "
                                  f"{r['param_max_diff_in_lr']:.3g} lr, RMS "
                                  f"{r['param_rms_diff_of_move']:.3g} of the move (within "
                                  f"the f32 tolerances: {r['params_within_f32_tolerances']})"
                                  if name != "one" else ""), flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
