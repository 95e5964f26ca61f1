#!/usr/bin/env python3
"""The port's (data, model) mesh over NCCL, one card per rank, held to one
process, through the launchers a user runs.

    python3 mesh_cards.py                           # 4 CUDA cards
    python3 mesh_cards.py --device cpu --sites 16 --colpar-batch 8 --lm-smoke  # CPU, gloo

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
one process's within 1e-3 relative. Its final checkpoint's params (43.3
GB with both moments) are read into memory and deleted before a meshed run
writes its own, so the part writes one at a time. They are
compared with the one process's against the f32 tolerances of the CPU
tests (0.25 lr, and 1e-3 of the RMS distance they moved from the draw) and
the result is printed and recorded, not held: in bf16 compute the meshed
sums' order moves AdamW's normalised updates by up to a few lr (llama's
smoke config on the CPU: 2.7 lr, an RMS of 2.9% of the move). Its step ms
(rank 0's ``metrics.jsonl``), tokens/s and MFU by the spec tree (the dense
bf16 peak) are printed. The checkpoints are deleted once compared.

Then every LM family's meshed train and serve steps at full width, cut in
depth (``FAMILY_LAYERS``: mixtral-8x22b and grok-1-314b 1 layer,
minicpm3-4b and internvl2-76b 2, zamba2-7b one layout unit and its tail;
xlstm-125m and whisper-tiny whole), float32, an MoE's capacity factor E /
k, over 4 ranks the script starts itself (one card a rank over NCCL;
``sharding/gloo_cuda.py`` is never installed there). For each family rank
0 first runs it in one process on its card while the others wait: the draw
from PRNGKey(0), a 13-token prompt (mixtral-8x22b's runs 2 tokens past its
4,096 window) prefilled and 3 greedy ticks, and two optimizer steps at 4 x
128 (AdamW; Adafactor for grok-1-314b, whose AdamW state would fit no
card), keeping every tree the holds read in its host memory; the ranks
then read each leaf as rank 0 broadcasts it. The train step at 2x2 from
the draw's blocks: step 1's metrics and step 2's loss within 1e-5
relative, the step-1 grads within 1e-4 of each leaf's largest, the params
after step 2 within 0.25 lr and 1e-3 of their RMS move over the elements
AdamW's state determines and, where it sets one aside, within AdamW's own
bound from both runs' g, m and v (``optimizer.adamw_step_bound``); step 2
from its own inputs (its grad norm within 1e-5 of one process's at the
meshed params after step 1); the optimizer on the one-process step-2
inputs, on every element (chip_smoke.py's holds, which this part imports).
The serve steps at 2x2 and 1x4: logits and every cache leaf after the last
tick within 1e-4 of the largest, greedy tokens outside near ties. Rank 0's
step and tick ms, its idle share from one traced step and each rank's peak
are printed. A family that fails is printed with its error, the others
still run, and the script exits 1 at the end. ``--device cpu --lm-smoke``
rehearses it at the smoke configs over gloo (about 80 s).

``--parts`` runs a subset of ``tnn``, ``lm`` and ``families`` (all by
default), and ``--families`` a subset of the family part's archs, so the
script can be split over calls. Each run's rate and wall
time are printed beside the cards' ``nvidia-smi`` lines, then one JSON line
with every number. The launchers print only on rank 0, so a rate is rank
0's. Each launcher command has 600 s; the family part's ranks 1,800 s.
Exits 2 when fewer than 4 cards are visible.
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


PARTS = ("tnn", "lm", "families")
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
    # in memory, and its checkpoint deleted before a meshed run writes its
    # own, so the part's disk use peaks at one full-size checkpoint (params
    # and both moments, float32: 43.3 GB)
    want = {p: np.array(a) for p, a in lm_params(one).items()}
    shutil.rmtree(one, ignore_errors=True)
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
    del start
    for name, r in res.items():
        step_s = float(np.median(r["step_s"][1:])) if len(r["step_s"]) > 1 else r["step_s"][0]
        r.update(step_ms_median=1e3 * step_s, tokens_per_s=batch * seq / step_s,
                 mfu=RL.lm_mfu(model_flops, step_s))
    return res


# ---------------------------------------------------------------------------
# Every LM family's meshed train and serve steps, one card a rank
# ---------------------------------------------------------------------------

# in the order they run: the largest one-process states last
FAMILIES = ("xlstm-125m", "whisper-tiny", "minicpm3-4b", "zamba2-7b", "mixtral-8x22b",
            "internvl2-76b", "grok-1-314b")
# full width cut in depth (the others at full size): zamba2-7b to one layout
# unit and its 3-layer tail
FAMILY_LAYERS = {"mixtral-8x22b": 1, "grok-1-314b": 1, "minicpm3-4b": 2, "internvl2-76b": 2,
                 "zamba2-7b": 9}
FAMILY_ADAFACTOR = ("grok-1-314b",)
FAMILY_B, FAMILY_S, FAMILY_SMOKE_S = 4, 128, 16
FAMILY_TRAIN_MESH = (2, 2)
FAMILY_SERVE_MESHES = ((2, 2), (1, 4))
FAMILY_PROMPT, FAMILY_PAST_WINDOW, FAMILY_TICKS = 13, 2, 3
FAMILY_TIMEOUT_S = 1800.0


def family_cfg(arch: str, smoke: bool, mesh_shape):
    """The family's config (its smoke config with ``smoke``) cut to
    FAMILY_LAYERS, float32, an MoE's capacity factor at E / k (no token
    dropped, so a row's routing does not depend on the others': ROADMAP
    Queue 3 item 7), routing groups tuned to ``mesh_shape``."""
    import dataclasses

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.sharding import partition as PT

    cfg = smoke_config(arch) if smoke else get_config(arch)
    n = FAMILY_LAYERS.get(arch)
    if n and not smoke:
        repeat = 1 if cfg.layout_tail else n // len(cfg.layout_unit)
        cfg = dataclasses.replace(cfg, n_layers=n, layout_repeat=repeat)
    moe = {"moe_capacity_factor": cfg.n_experts / cfg.experts_per_token} if cfg.n_experts else {}
    return PT.tuned_config(dataclasses.replace(cfg, dtype="float32", **moe), mesh_shape)


def family_opt(arch: str):
    """chip_smoke's two-step schedule, under AdamW (whose holds the
    tolerances were set for) wherever the one-process AdamW state fits a
    card, and under Adafactor, the reference launcher's choice over 50B
    parameters, for FAMILY_ADAFACTOR: grok-1-314b's one layer would need
    104.5 GB with AdamW."""
    import chip_smoke as CS
    from repro_torch.train import optimizer as OPT

    return OPT.OptConfig(name="adafactor" if arch in FAMILY_ADAFACTOR else "adamw",
                         **CS.LM_HOLD_OPT)


def _family_inputs(cfg, smoke: bool):
    """Two training batches (host, with the family's seeded frames or
    embeds) and the serve prompt (past the window where there is one) with
    its extras."""
    import chip_smoke as CS
    import torch
    from repro_torch.data.tokens import TokenStream

    S = FAMILY_SMOKE_S if smoke else FAMILY_S
    extras = CS.lm_extras(cfg, FAMILY_B, seed=31)
    stream = TokenStream(cfg.vocab_size, FAMILY_B, S, seed=0)
    batches = [dict(stream.batch_at(i), **{k: v.numpy() for k, v in extras.items()})
               for i in range(2)]
    P = cfg.sliding_window + FAMILY_PAST_WINDOW if cfg.sliding_window else FAMILY_PROMPT
    prompt = torch.randint(0, cfg.vocab_size, (FAMILY_B, P), generator=CS._gen(14))
    return batches, prompt, extras


def _n_cache(cfg, prompt, extras) -> int:
    prefix = extras["embeds"].shape[1] if "embeds" in extras else 0
    return -(-(prefix + prompt.shape[1] + FAMILY_TICKS + 8) // 8) * 8


def _peak_reset(dev) -> int:
    import torch

    if dev.type != "cuda":
        return 0
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def _peak(dev, base: int) -> int:
    import torch

    return torch.cuda.max_memory_allocated(dev) - base if dev.type == "cuda" else 0


def family_reference(arch: str, smoke: bool, dev) -> dict:
    """One process on rank 0's card: the family drawn from PRNGKey(0); the
    serve reference at each of FAMILY_SERVE_MESHES' tuned configs (meshes
    that tune it alike share one); two optimizer steps by hand (the train
    step's own body) keeping, on the host, the draw, the step-1 grads, the
    params and moments after each step, the step-2 grads and clip scale
    (for chip_smoke's holds), and the set-aside rule."""
    import chip_smoke as CS
    import torch
    from repro_torch import random as t_random
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS

    cfg = family_cfg(arch, smoke, {"data": FAMILY_TRAIN_MESH[0], "model": FAMILY_TRAIN_MESH[1]})
    opt_cfg = family_opt(arch)
    moments = ("m", "v") if opt_cfg.name == "adamw" else ("vr", "vc")
    kv = 8 if smoke else 128
    base = _peak_reset(dev)
    t0 = time.perf_counter()
    params = M.init_params(cfg, t_random.PRNGKey(0), dev)   # as TS.init_state draws
    CS._sync(dev)
    out = {"draw_s": time.perf_counter() - t0, "metrics": [], "step_ms": [], "serve": {}}
    start = CS._host(params)
    batches, prompt, extras = _family_inputs(cfg, smoke)
    runs = []   # the serve references before the optimizer state takes its room
    for d, m in FAMILY_SERVE_MESHES:
        c = family_cfg(arch, smoke, {"data": d, "model": m})
        same = [r for cc, r in runs if cc == c]
        out["serve"][f"{d}x{m}"] = same[0] if same else CS.lm_serve_run(
            c, params, prompt, extras, _n_cache(c, prompt, extras), FAMILY_TICKS, kv, dev)
        runs.append((c, out["serve"][f"{d}x{m}"]))
    del runs
    state = {"params": params, "opt": OPT.opt_init(params, opt_cfg),
             "step": torch.zeros((), dtype=torch.int32)}
    del params
    loss_fn = TS.make_loss_fn(cfg, TS.TrainConfig(kv_chunk=kv))
    forced = {}
    for i, b in enumerate(batches):
        CS._sync(dev)
        t0 = time.perf_counter()
        loss, aux, g = TS.value_and_grad(loss_fn, state["params"], TS.device_batch(b, dev))
        CS._sync(dev)
        t1 = time.perf_counter()
        if i == 0:
            out["grads"] = CS._host(g)
        else:
            forced["g2"] = CS._host(g)
        t2 = time.perf_counter()
        _, _, gnorm = OPT.opt_update(g, state["opt"], state["params"], opt_cfg)
        state["step"].add_(1)
        del g
        CS._sync(dev)
        out["step_ms"].append(1e3 * (time.perf_counter() - t2 + t1 - t0))
        out["metrics"].append({"loss": float(aux["loss"]), "loss_total": float(loss),
                               "grad_norm": float(gnorm)})
        forced.update({f"{k}{i + 1}": CS._host(state["opt"][k]) for k in moments})
        if i == 0:
            forced["p1"] = CS._host(state["params"])
        else:
            forced["scale"] = OPT.clip_scale(gnorm, opt_cfg.clip_norm)
            out["end"] = CS._host(state["params"])
    out["peak_bytes"] = _peak(dev, base)
    del state
    CS._free()
    out["forced"] = forced
    out["start"] = start
    adamw = opt_cfg.name == "adamw"
    out["rule"] = CS.lm_rule(start, forced["v1"] if adamw else None, out["end"],
                             forced["v2"] if adamw else None, dev)
    return out


class _Leaves:
    """Rank 0's host tree ``{path: tensor}``, leaf by leaf on every rank:
    indexing by a path broadcasts that leaf from rank 0 (a collective, so
    every rank indexes the same paths in the same order, as chip_smoke's
    holds do) and returns it whole on this rank's device."""

    def __init__(self, host, meta: dict, dev):
        self.host, self.meta, self.dev = host, meta, dev

    def __getitem__(self, path):
        import torch
        import torch.distributed as dist

        shape, dtype = self.meta[path]
        t = (self.host[path].to(self.dev) if self.host is not None
             else torch.empty(shape, dtype=dtype, device=self.dev))
        dist.broadcast(t, 0)
        return t


class _RuleLeaf:
    """One leaf of the set-aside rule: its count and RMS move everywhere,
    its packed bits broadcast from rank 0 when read."""

    def __init__(self, small: dict, det: _Leaves, path):
        self.small, self.det, self.path = small, det, path

    def __getitem__(self, key):
        return self.det[self.path] if key == "det" else self.small[key]


class _Rule:
    def __init__(self, small: dict, det: _Leaves):
        self.small, self.det = small, det

    def __getitem__(self, path):
        return _RuleLeaf(self.small[path], self.det, path)


def _shared(obj, main: bool):
    """Rank 0's small Python object on every rank."""
    import torch.distributed as dist

    box = [obj if main else None]
    dist.broadcast_object_list(box, 0)
    return box[0]


def _meta(tree: dict) -> dict:
    return {p: (tuple(t.shape), t.dtype) for p, t in tree.items()}


def family_ref_on_ranks(ref, main: bool, dev) -> dict:
    """The reference as every rank reads it: its small parts copied, each
    tree a :class:`_Leaves` over rank 0's host copies."""
    trees = ("start", "grads", "end")
    forced_trees = [k for k in (ref["forced"] if main else ()) if k != "scale"]
    small = _shared({
        "metrics": ref["metrics"], "scale": ref["forced"]["scale"], "forced_trees": forced_trees,
        "meta": {k: _meta(ref[k]) for k in trees},
        "forced_meta": {k: _meta(ref["forced"][k]) for k in forced_trees},
        "rule": {p: {"aside": r["aside"], "move": r["move"]} for p, r in ref["rule"].items()},
        "det_meta": {p: (tuple(r["det"].shape), r["det"].dtype) for p, r in ref["rule"].items()},
        "serve": {f: {k: v for k, v in r.items() if k != "cache"} | {
            "cache": [(p, None) for p, _ in r["cache"]]} for f, r in ref["serve"].items()},
    } if main else None, main)
    host = (lambda k: ref[k]) if main else (lambda k: None)
    out = {k: _Leaves(host(k), small["meta"][k], dev) for k in trees}
    out["metrics"] = small["metrics"]
    out["forced"] = {k: _Leaves(ref["forced"][k] if main else None, small["forced_meta"][k], dev)
                     for k in small["forced_trees"]}
    out["forced"]["scale"] = small["scale"]
    det = {p: r["det"] for p, r in ref["rule"].items()} if main else None
    out["rule"] = _Rule(small["rule"], _Leaves(det, small["det_meta"], dev))
    out["serve"] = small["serve"]
    if main:   # rank 0 holds the gathered caches
        for f, r in out["serve"].items():
            r["cache"] = ref["serve"][f]["cache"]
    return out


def _timed(step, state, batch, dev):
    import chip_smoke as CS

    CS._sync(dev)
    t0 = time.perf_counter()
    state, met = step(state, batch)
    met = {k: float(v) for k, v in met.items()}
    CS._sync(dev)
    return state, met, 1e3 * (time.perf_counter() - t0)


def family_train(arch: str, smoke: bool, mesh, ref) -> dict:
    """The family at FAMILY_TRAIN_MESH from the draw's blocks: its step-1
    grads at the draw (chip_smoke ``_hold_grads``), two steps (rank 0's
    second traced on the card) with step 1's metrics and step 2's loss held
    to one process's; the params after step 2 (``_hold_params`` over the
    elements the rule determines and, under AdamW, ``_hold_aside`` over the
    ones it sets aside); step 2 from its own inputs (``_hold_own_step``);
    the optimizer on the one-process step-2 inputs (``_hold_forced``)."""
    import chip_smoke as CS
    import torch
    from repro_torch.sharding import partition as PT
    from repro_torch.sharding.context import use_partitioning
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS

    t0 = time.perf_counter()
    dev, main = mesh.device, mesh.is_main
    cfg = family_cfg(arch, smoke, mesh)
    opt_cfg = family_opt(arch)
    adamw = opt_cfg.name == "adamw"
    kv = 8 if smoke else 128
    what = f"2x2 {arch}{' smoke' if smoke else ''}"
    batches, _, _ = _family_inputs(cfg, smoke)
    sh = TS.state_shardings(cfg, opt_cfg, mesh)
    base = _peak_reset(dev)
    params = CS._sharded_from(ref["start"], sh["params"], dev)
    state = TS.shard_state({"params": params, "opt": OPT.opt_init(params, opt_cfg),
                            "step": torch.zeros((), dtype=torch.int32)}, sh)
    del params
    tc = TS.TrainConfig(kv_chunk=kv)
    prof = PT.RunProfile()
    with use_partitioning(PT.device_mesh(mesh), PT.act_rules(mesh, prof)):
        b = TS.shard_batch(TS.device_batch(batches[0], dev), mesh, prof)
        _, _, g = TS.value_and_grad(TS.make_loss_fn(cfg, tc), state["params"], b)
    res = {"steps": [], "step_ms": [], **CS._hold_grads(g, ref["grads"], what)}
    del g, b
    step = TS.make_train_step(cfg, opt_cfg, tc, mesh=mesh)
    for i, batch in enumerate(batches):
        if i == 1 and main and dev.type == "cuda":
            box = {}
            res["trace"] = CS._trace_once(lambda: box.update(out=step(state, batch)))
            state, met = box["out"]
            met, ms = {k: float(v) for k, v in met.items()}, res["trace"]["wall_ms"]
        else:
            state, met, ms = _timed(step, state, batch, dev)
        res["steps"].append(met)
        res["step_ms"].append(ms)
        for k in ("loss", "loss_total", "grad_norm")[:3 - i]:
            a, w = met[k], ref["metrics"][i][k]
            if not abs(a - w) <= CS.LM_TRAIN_METRIC_REL * abs(w):
                raise AssertionError(f"{what} step {i + 1}: {k} {a} vs one process {w}")
        if i == 0:
            mine1 = ({"params": CS._host_blocks(state["params"]),
                      "m": CS._host_blocks(state["opt"]["m"]),
                      "v": CS._host_blocks(state["opt"]["v"])} if adamw else None)
            p1 = CS._gather_main(state["params"], main)
    res["peak_bytes"] = _peak(dev, base)
    res["own_grad_norm_rel"] = (abs(res["steps"][1]["grad_norm"] - ref["metrics"][1]["grad_norm"])
                                / ref["metrics"][1]["grad_norm"])
    res.update(CS._hold_params(state, ref, what, hold_aside=not adamw))
    if adamw:
        res.update(CS._hold_aside(state, mine1, ref, what))
    del state, step, mine1
    CS._free()
    res.update(CS._hold_own_step(cfg, mesh, p1, batches[1], res["steps"][1], kv, what))
    del p1
    CS._free()
    res.update(CS._hold_forced(cfg, mesh, ref, what, opt_cfg))
    CS._free()
    res["seconds"] = time.perf_counter() - t0
    return res


def family_serve(arch: str, smoke: bool, mesh, ref) -> dict:
    """The draw sharded on ``mesh``, the prompt and extras prefilled into a
    sharded float32 cache and FAMILY_TICKS ticks fed the one-process greedy
    tokens, held as chip_smoke ``_mesh_serve`` and ``_hold_cache`` hold
    them (logits and every cache leaf after the last tick within 1e-4 of
    the largest, greedy tokens outside near ties)."""
    import chip_smoke as CS
    from repro_torch.sharding import partition as PT
    from repro_torch.train import train_step as TS

    t0 = time.perf_counter()
    shape = PT.mesh_shape(mesh)
    f = f"{shape['data']}x{shape['model']}"
    what = f"{f} {arch}{' smoke' if smoke else ''} serve"
    cfg = family_cfg(arch, smoke, mesh)
    _, prompt, extras = _family_inputs(cfg, smoke)
    want = ref["serve"][f]
    base = _peak_reset(mesh.device)
    params = CS._sharded_from(ref["start"], TS.param_shardings(cfg, mesh), mesh.device)
    res, cache = CS._mesh_serve(cfg, mesh, params, _n_cache(cfg, prompt, extras), prompt,
                                extras, want, 8 if smoke else 128, what)
    res.update(CS._hold_cache(cache, want["cache"], mesh.is_main, what))
    res.update(peak_bytes=_peak(mesh.device, base), prompt=prompt.shape[1],
               seconds=time.perf_counter() - t0)
    del params, cache
    CS._free()
    return res


def family_ranks(archs, smoke: bool, device: str) -> dict:
    """What each of the 4 ranks runs: the meshes (NCCL on cards, one card a
    rank; gloo on the CPU), then for each family rank 0's one-process
    reference while the others wait, the meshed train at
    FAMILY_TRAIN_MESH and the serve on each of FAMILY_SERVE_MESHES. A
    family that fails is recorded with its error and the next one runs
    (the holds reduce their statistics over the ranks first, so every rank
    fails alike)."""
    import traceback

    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    import torch
    from repro_torch.launch.mesh import make_mesh_2d
    from repro_torch.sharding import gloo_cuda

    meshes = {f"{d}x{m}": make_mesh_2d(d, m, device=device)   # every rank, one order
              for d, m in dict.fromkeys((FAMILY_TRAIN_MESH, *FAMILY_SERVE_MESHES))}
    main = next(iter(meshes.values())).is_main
    dev = next(iter(meshes.values())).device
    out = {"backend": next(iter(meshes.values())).backend}
    for arch in archs:
        t0 = time.perf_counter()
        res = out[arch] = {}
        ref, err = None, None
        if main:
            try:
                ref = family_reference(arch, smoke, dev)
            except Exception:  # noqa: BLE001 (recorded; every rank skips the family)
                err = traceback.format_exc()
            CS._free()
        err = _shared(err, main)
        if err:
            res["error"] = f"one-process reference: {err}"
            continue
        if main:
            res["one_process"] = {k: ref[k] for k in ("draw_s", "step_ms", "peak_bytes",
                                                         "metrics")}
            res["one_process"]["serve"] = {f: {k: r[k] for k in ("prefill_ms", "decode_tick_ms")}
                                           for f, r in ref["serve"].items()}
        view = family_ref_on_ranks(ref, main, dev)
        parts = [("train", lambda: family_train(arch, smoke, meshes["x".join(
            map(str, FAMILY_TRAIN_MESH))], view))]
        parts += [(f"serve_{d}x{m}", lambda d=d, m=m: family_serve(arch, smoke,
                                                                  meshes[f"{d}x{m}"], view))
                  for d, m in FAMILY_SERVE_MESHES]
        for name, fn in parts:
            try:
                res[name] = fn()
            except Exception:  # noqa: BLE001 (recorded; the other parts still run)
                res[name] = {"error": traceback.format_exc()}
            CS._free()
        del ref, view
        CS._free()
        res["seconds"] = time.perf_counter() - t0
        if dev.type == "cuda":
            res["gloo_cuda_installed"] = gloo_cuda.installed()
            torch.cuda.synchronize()
    return out


def families(args, out_dir: str, smi: str) -> dict:
    """FAMILIES over 4 ranks (:func:`family_ranks`); prints a line a family
    and mesh; returns the numbers and the errors."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    from repro_torch.launch.mesh import spawn_ranks

    t0 = time.perf_counter()
    ranks = spawn_ranks(family_ranks, RANKS, work_dir=os.path.join(out_dir, "ranks"),
                        device=args.device, timeout_s=FAMILY_TIMEOUT_S,
                        threads=2 if args.device == "cpu" else 0,
                        args=(args.families, args.lm_smoke, args.device))
    card = smi.splitlines()[0]
    over = f"{RANKS} ranks over {ranks[0]['backend'].upper()}" + (
        ", one card a rank" if args.device == "cuda" else "")
    res, errors = {"seconds": time.perf_counter() - t0}, []
    for arch in args.families:
        r0 = ranks[0][arch]
        r = res[arch] = {"seconds": r0.get("seconds")}
        if r0.get("gloo_cuda_installed"):
            errors.append(f"{arch}: sharding/gloo_cuda.py was installed on the NCCL path")
        if "error" in r0:
            errors.append(f"{arch}: {r0['error']}")
            print(f"  {arch}: FAILED {r0['error'][-2000:]}", flush=True)
            continue
        one = r0["one_process"]
        r["one_process"] = one
        tag = f"{arch}{' smoke' if args.lm_smoke else ''} (f32)"
        for name in ("train", *(f"serve_{d}x{m}" for d, m in FAMILY_SERVE_MESHES)):
            p = r0[name]
            if "error" in p:
                errors.append(f"{arch} {name}: {p['error']}")
                print(f"  {tag} {name}: FAILED {p['error'][-2000:]}", flush=True)
                r[name] = {"error": p["error"][-2000:]}
                continue
            peaks = [x[arch][name]["peak_bytes"] for x in ranks]
            r[name] = dict(p, peak_bytes_per_rank=peaks)
            if name == "train":
                tr = p.get("trace") or {}
                print(f"  {tag} train at 2x2 ({over}; {card}): step-1 metrics and step-2 "
                      f"loss within 1e-5 of one process ({[round(m['loss'], 6) for m in p['steps']]}); "
                      f"step-1 grads within {p['grad_err_of_max']:.3g} of the leaf's largest; "
                      f"params after step 2: max {p['param_max_diff_in_lr']:.3g} lr, RMS "
                      f"{p['param_rms_diff_of_move']:.3g} of the move over the determined "
                      f"elements; {p['set_aside']:,} set aside (largest {p['set_aside_max_lr']:.3g} "
                      f"lr), AdamW's bound's largest share {p.get('aside_bound_share')}; step 2 "
                      f"from its own inputs {p['own_step2_rel']} (its grad norm "
                      f"{p['own_grad_norm_rel']:.3g} from one process's step 2); forced update "
                      f"ulps {p['forced_ulps']}, of the largest {p['forced_err_of_max']}; rank 0 "
                      f"step ms {[round(v, 1) for v in p['step_ms']]} (one process "
                      f"{[round(v, 1) for v in one['step_ms']]}), idle share "
                      f"{tr.get('device_idle_share')}; peak GB/rank "
                      f"{[round(v / 1e9, 2) for v in peaks]} (one process "
                      f"{one['peak_bytes'] / 1e9:.2f}); one-process draw {one['draw_s']:.1f} s; "
                      f"{p['seconds']:.1f} s", flush=True)
            else:
                f = name[len("serve_"):]
                o = one["serve"][f]
                print(f"  {tag} serve at {f} ({over}; {card}): {p['prompt']} tokens, "
                      f"{FAMILY_TICKS} ticks: logits err/max "
                      f"{[f'{e:.2g}' for e in p['logit_err_of_max']]}, near ties "
                      f"{p['near_ties']}; cache within {p['cache_err_of_max']:.3g} of the leaf's "
                      f"largest (worst {p['worst_cache_leaf']}); rank 0 prefill "
                      f"{p['prefill_ms']:.1f} ms, median tick "
                      f"{float(np.median(p['decode_tick_ms'])):.1f} ms (one process "
                      f"{o['prefill_ms']:.1f} / {float(np.median(o['decode_tick_ms'])):.1f}); "
                      f"peak GB/rank {[round(v / 1e9, 2) for v in peaks]}; {p['seconds']:.1f} s",
                      flush=True)
    res["errors"] = [e[-2000:] for e in errors]
    return res


def tnn(args, smi: str) -> dict:
    """The TNN launchers in one process and under MESHES, held file for
    file, then the column-parallel cell; numbers by run."""
    res = {}
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
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sites", type=int, default=625)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--colpar-batch", type=int, default=None,
                    help="cut the column-parallel cell's 8,192 images (a rehearsal)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "mesh_cards"))
    ap.add_argument("--lm-smoke", action="store_true",
                    help="the LM parts at smoke configs (a rehearsal)")
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated subset of {','.join(PARTS)} (all by default)")
    ap.add_argument("--families", default=",".join(FAMILIES),
                    help="comma-separated subset of the family part's LM archs (all by "
                         "default)")
    args = ap.parse_args()
    parts = args.parts.split(",")
    if not parts or any(p not in PARTS for p in parts):
        ap.error(f"--parts takes a comma-separated subset of {','.join(PARTS)}")
    asked = args.families.split(",")
    if not asked or any(a not in FAMILIES for a in asked):
        ap.error(f"--families takes a comma-separated subset of {','.join(FAMILIES)}")
    args.families = [a for a in FAMILIES if a in asked]
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
    res = {"sites": args.sites, "device": args.device, "cards": smi.splitlines(),
           "parts": parts}
    if "tnn" in parts:
        res.update(tnn(args, smi))
    if "lm" in parts:
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
    if "families" in parts:
        res["families"] = families(args, os.path.join(args.out, "families"), smi)
        print(f"  LM families part {res['families']['seconds']:.1f} s", flush=True)
    print(json.dumps(res, default=str))
    if res.get("families", {}).get("errors"):
        print(f"{len(res['families']['errors'])} LM family part(s) failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
