#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run on error:

1. device   require CUDA; print the card's name and power limit.
2. build    compile every CUDA kernel of the port (nvcc, sm_90a), one nvcc
            per source, all started together.
3. kernels  hold each kernel against its plain PyTorch version on the card,
            bit for bit (integer outputs and float bit patterns, tolerance
            0), at the serving and training paths' shapes and a few more
            (for the column and wave kernels, whose tensor-core tiling
            depends on T, also other wave specs, odd batches and odd
            widths); time kernel and plain version. The fused wave kernel
            (tnn_wave), then the per-layer kernels: column forward
            (tnn_column), STDP update (stdp_update) and the standalone WTA
            (wta); then the threefry STDP uniforms (threefry: the
            known-answer vector, both prototype layers at B = 16, B = 1, 7
            and 1000, one column, odd widths, columns that cross a block; the
            two-level entry at B = 1, 16 and 1000, one column, odd widths),
            and the host draw + copy it replaced, timed beside it.
4. serve    the launcher at full width (625 sites, 64 slots, 512 requests,
            4 STDP warm-up waves) on the card, with every kernel launch
            counted from 0 for each path: first ``--impl pallas`` (the
            per-layer kernels, the launcher's default), then ``--impl fused``
            (the wave kernel). The fused run must equal the same launcher
            on the CPU (plain path, same seeds), and the pallas run must
            equal the fused run: warmed weights, vote table and the class id
            of every request. Then each engine serves the same requests in
            steady state and once under torch.profiler.
5. fallback a "fused" network the wave kernel cannot hold (layer-1 fan-in
            600) runs forward and one learning wave on the card through the
            per-layer kernels, and equals its plain version.
6. train    the train launcher at full width (625 sites, 1 epoch = 32 waves
            of 16 images, a vote-table eval, checkpoints every 16 waves) on
            the card, counts from 0 for each run: A ``--impl pallas``, B
            ``--impl fused --superbatch-k 4``, C a new trainer resuming from
            A's wave-16 checkpoint alone; then the same epoch on the CPU
            (plain path). All four end with the same weights, key, wave,
            vote table and accuracy. Then a span of training waves per
            backend untraced (waves/s) and traced (device idle share).
7. firing   the serve launcher's sequence at theta = (12, 3), where layer 2
            fires at full width, through the engine: pallas (card), fused
            (card) and the CPU give one warmed weight set, one non-zero vote
            table and the same class ids (a differing id is allowed only on a
            near tie, a row whose top-two vote margin is below the largest
            card-CPU sum difference, and is printed).
8. online   learning while serving at theta = (12, 3): 512 requests, 64
            slots, K = 4 superbatches, a hot swap every 4 learning waves;
            pallas (card), fused (card), the CPU and fused lock-step at K = 1
            give every uid the same class id and version, one shadow state
            (equal to 8 train steps on the same volleys) and the same
            published vote tables; launches as the code says; a traced pass
            per backend.
9. ckpt     train A's wave-16 checkpoint served online for waves 16-31 ends
            at A's wave-32 state.
10. loadgen the port's loadgen, online: closed loop, then 2 s of open loop at
            half the closed loop's images/s; every request served, versions
            never decrease along the retire order.
11. flagship ``repro_torch.launch.tnn_mnist`` with its defaults, --impl fused,
            on the card and the CPU: equal weights, vote table, centroids and
            both accuracies; the PPA tables.
12. modes   a "seq" and a "gauss" learning wave at 625 sites, B = 16, theta
            (24, 8) and (12, 3): pallas and fused on the card equal the CPU's
            plain path (spike times and weights, bit for bit), and launch
            tnn_column and threefry, never tnn_wave or stdp_update; the
            card's normals equal the CPU's (1,240,000 draws).
13. cells   the reference's dry-run cells through ``launch.dryrun``'s
            ``run_tnn_cell`` at 625 sites, nothing cut: tnn_infer_64k
            (pallas, fused) and tnn_train_8k (pallas, fused, fused+gauss),
            each timed (one wave, CUDA events) with its Roofline.report() and
            peak memory, launches counted, and held against the plain version
            on the card chunk by chunk, bit for bit.
14. mesh    the (data, model) mesh at 625 sites: the threefry window entry
            against its plain version and the padded slice of the global
            draw (every rank's window under 2x2, 4x1 and 1x4 at B = 16, a
            pad-only window, odd widths, B = 8,192 windows), timed; then 4
            ranks sharing the card over gloo (chosen here; NCCL refuses two
            ranks on one card) run, under 2x2, 4x1 and 1x4, the train
            launcher (pallas; fused K = 4) and online serving (theta (12, 3),
            64 slots, K = 4, swaps every 4), each equal to the unmeshed card
            run (weights, key, wave, vote tables, accuracy, every uid's class
            id and version); the 2x2 checkpoint equals train A's file for
            file and restores under 1x4 and unmeshed; the column-parallel
            tnn_train_8k cell (640 sites) on 1x4 equals the unmeshed 640-site
            wave (pallas, fused); one rank over NCCL (1x1) repeats the train
            and online runs. Times from ranks sharing one card are labelled
            so.
15. lm      LM serving (slice 9; no hand-written kernel: the LM path reaches
            no Pallas kernel in the reference): llama3.2-3b at full width and
            depth drawn from PRNGKey(0) on the card, the first and last 2**20
            floats of its embedding and of a stacked weight bit-equal to the
            CPU's draw of the same counter windows; the serve launcher (8
            requests, 4 slots, 32 new tokens, 256 positions) timed, then the
            same requests served again recording logits and trunk increments,
            every request held, teacher-forced, to a one-slot run of its tokens
            (argmax equal outside near ties, increments within tolerance); a
            traced decode tick (idle share, top ops) against the decode
            step's byte bound; llama at 2 layers on the card and the CPU
            (bf16 and f32, logits and increments); minicpm3-4b at full size
            and mixtral-8x22b cut to 2 layers served with the same checks.
            Slice 10: zamba2-7b at full size (81 layers, 5,737,416,000
            parameters) served, a float32 re-serve held to float32 one-slot
            runs (in bf16 its depth amplifies rounding past the hold's
            tolerance), its draw windows
            (embedding, stacked Mamba input projection, shared attention,
            an unstacked tail leaf) bit-equal to the CPU's, and one unit
            plus the tail card against the CPU; xlstm-125m at
            full size served and held, then card against the CPU;
            whisper-tiny at full size with seeded frames (2, 1500, 384),
            prefill + 16 decode steps card against the CPU; internvl2-76b
            at full width cut to 2 layers, a 256-position seeded embeds
            prefix, serving held to training in float32; the TNN-frontend
            entry point (``launch.tnn_frontend_lm``) --impl pallas and
            direct on the card and direct on the CPU, equal spike times,
            winners and weights, launches counted (pallas: the column,
            STDP and threefry kernels; direct: threefry); all ten smoke
            configs card against the CPU, with frames or embeds where the
            family takes them. No TNN kernel may launch on the LM serve
            paths.
16. lm_train LM training (slice 11; no hand-written kernel: the reference's
            LM training reaches no Pallas kernel) on llama3.2-3b: (1) at
            full width cut to 2 layers, float32, AdamW, B = 1, S = 32, two
            train steps on the card and on the CPU from the same state,
            per-step loss and grad norm and the params after step 2 at the
            CPU tests' float32 tolerances; (2) the train launcher (--steps 4
            --batch 8 --seq 512) on the 2-layer cut in bf16, each step's
            loss, ms and tokens/s, its final checkpoint (11.9 GB) restored
            through lm_abstract_state bit-equal to the trainer's state, then
            deleted; (3) the launcher at the smoke config (--steps 8) stopped
            by SIGTERM after step 5 and run again, bit-equal to an
            uninterrupted run (state and metrics.jsonl; if not, both again
            under deterministic algorithms, naming the ops that have no
            deterministic kernel); (4) the full-size step (28 layers,
            3,606,752,256 parameters, bf16 compute, float32 masters, remat
            "full", B x S = 4 x 512): median step ms, tokens/s, MFU against
            the spec count, the bound of roofline.analysis.lm_train_work,
            one traced step and the peak memory; then one step of the same
            rows as two micro-steps, its ms and its own peak. No TNN kernel
            may launch.
17. lm_mesh LM sharding (slice 12; no hand-written kernel) on llama3.2-3b at
            full width cut to LM_MESH_LAYERS = 2 layers (989,346,816
            parameters), float32,
            AdamW: one process on the card takes two steps at B x S = 4 x
            128 (timed, one more traced) and serves its end params (a
            64-token prefill into a float32 cache and 4 greedy decode
            ticks); then 4 ranks sharing the card over gloo, under 2x2 and
            1x4, draw the state sharded by the reference's param rules
            (DTensors), take the same two steps (per-step loss and grad
            norm within 1e-5 relative, params after step 2 at lm_train's
            tolerances, step ms, peak, rank 0's traced step and its idle
            share), serve the one-process end params sharded (logits within
            1e-4 of the largest, greedy tokens equal outside near ties);
            under 2x2 the sharded checkpoint (each rank's sharded restore
            equal to its blocks; restored in one process (rank 0, no
            shardings) equal to the gathered state, leaf by leaf; then
            deleted), the collective
            probe's LM table of the train step, and pipeline_apply over the
            4 ranks as stages against its sequential form. No TNN kernel may
            launch.
18. report  one JSON line with the serve, train, slice-6 to slice-13 and
            shape numbers and every phase's seconds, one with every
            kernel's numbers, the card's nvidia-smi line, then the result
            line.

Slice 13 adds, after the wave kernel's checks, the autotune phase: the
checked-in tuned cache (src/repro_torch/kernels/tuned_blocks.json) passes
``--check``; at each of its seven default geometries every (rows, warps)
launch candidate's forward output is bit-equal to the static launch's and
that to the plain version, and the static and cached launches are timed
in turns; serving at 625 sites and 8 slots launches every forward wave
with the cached extents (a spy on the launch arguments), and again with
an altered copy of the cache, with the same class ids. To lm it adds
qwen1.5-4b and mistral-nemo-12b at full size served and held, their draw
windows (qwen's QKV bias, mistral's (5,120, 32, 128) query projection)
and their 2-layer cuts against the CPU; grok-1-314b cut to 2 of 64
layers (capacity factor E / k) served, held in float32 (in bf16 a router
near-tie flips between the batched and one-row runs), its draw windows
(the (8, 6,144, 32,768) expert input). To lm_mesh it adds the smoke train
steps of minicpm3-4b, xlstm-125m, whisper-tiny (frames) and
internvl2-76b (embeds) at 2x2, held to one process on the card (zamba2-7b
joins them in slice 15), their step-1 grads and their params after two
steps, each with its worst leaf named. So that the
run stays under 1,200 s, slice 13 cuts two earlier LM checks in depth:
minicpm3-4b is served at 16 of its 62 layers, zamba2-7b at 4 of its 13
units and the tail (27 of 81 layers). The forward waves that the TNN
phases launch are counted by geometry key: each took the cache's extents
where it has an entry (the 64-slot serve must have one). A phase's
seconds print as the next starts. (Slice 15 cuts qwen1.5-4b to 4 and
mistral-nemo-12b to 2 of their 40 layers, grok-1-314b to 1 of its 64,
minicpm3-4b to 8 of its 62 layers, zamba2-7b's serve to 1 of its 13
units and the tail, 9 layers, and lm_mesh's llama3.2-3b serve to 2 decode
ticks, so that the run stays under 1,200 s with the hybrid's meshed
training in lm_mesh.)

Slice 14 adds to lm_mesh, after llama3.2-3b's serve under each of 2x2 and
1x4, the meshed serve of the six other families' smoke configs in float32
(mixtral-8x22b past its sliding window, minicpm3-4b, xlstm-125m,
zamba2-7b, whisper-tiny with seeded frames, internvl2-76b with seeded
prefix embeds): a sharded prefill of 13 tokens (mixtral's 18) into a
24-position cache and 3 ticks fed the one-process greedy tokens, held to
the same family's one-process run on the card (logits within
LM_MESH_LOGITS, the greedy token outside near ties, every cache leaf after
the last tick within LM_MESH_CACHE_HOLD of its largest |value|), each family's
rank-0 prefill and median tick ms printed; and under 2x2 the collective
probe's whisper-tiny and internvl2-76b prefill cells on the inputs the
reference's specs declare, their logits equal to the meshed serve's
prefill on the same inputs.

Slice 15 adds the hybrid's meshed training to lm_mesh. The smoke train
steps at 2x2 take zamba2-7b too. Every params hold (llama3.2-3b's at 2x2
and 1x4, the families', the hybrid's) holds each element within 0.25 lr
and runs its RMS tolerance over the elements the one-process run's AdamW
state determines (optimizer.adamw_determined: the bias-corrected sqrt(v /
(1 - b2^count)) at least 10 eps after steps 1 and 2; where it is below,
AdamW's denominator is eps and a grad that is zero in exact arithmetic
moves its param by rounding); each line prints how many elements the rule
sets aside and their largest difference in lr. For each family and the
full-width hybrid the AdamW update on the ranks, fed the one-process run's
params and moments after step 1, its step-2 grads and its step-2 clip
scale, lies within LM_MESH_ULPS float32 ulps of its step 2 on every
element, each rank reading its own blocks. zamba2-7b at full width cut to
one layout unit and the tail (LM_MESH_HYBRID_LAYERS = 9 layers,
1,058,732,160 parameters, f32, AdamW, 4 x 128) trains two steps in one
process on the card, then sharded at 2x2, held to it. Its meshed grads,
within LM_MESH_GRAD of each leaf's largest, differ by more than eps at
elements whose grads are below eps, and there the first AdamW step moves a
param by up to lr / eps times the difference (0.82 lr apart on the H100),
and the next step's grads with it. So the elements the rule sets aside are
held by AdamW's own bound (optimizer.adamw_step_bound) on both runs' g, m
and v after each step, at LM_MESH_ULPS, and the meshed step 2 from its own
inputs: its own grad norm within LM_TRAIN_METRIC_REL of one process's at
the meshed params after step 1 (ROADMAP Queue 3 item 17, closed). The
train launcher trains
smoke zamba2-7b for one step under --mesh 2x2, its checkpoint the state it
holds.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint.checkpointer import (  # noqa: E402
    Checkpointer, LeafSpec, lm_abstract_state, restore_tnn,
)
from repro_torch import random as t_random  # noqa: E402
from repro_torch.configs.tnn_mnist import (  # noqa: E402
    deep_config, launcher_network_config, network_config,
)
from repro_torch.core.column import ColumnConfig  # noqa: E402
from repro_torch.core.layer import LayerConfig  # noqa: E402
from repro_torch.core.network import (  # noqa: E402
    NetworkConfig, _uses_fused_wave, encode_images, forward_all_padded,
    init_network, init_train_state, make_superbatch_step, make_train_step,
    network_forward, network_train_wave, params_to_tree, prototype_config,
    train_stream_start, vote_sums,
)
from repro_torch.core.stdp import (  # noqa: E402
    apply_net, default_stabilize_table, gauss_update, stdp_net_from_uniforms,
)
from repro_torch.core.temporal import SPIKE_DTYPE, WaveSpec  # noqa: E402
from repro_torch.data.mnist_like import digits  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build, autotune, padding, stdp_update, threefry, tnn_column, tnn_wave, wta,
)
from repro_torch.kernels.padding import network_plan  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import loadgen as t_loadgen  # noqa: E402
from repro_torch.launch.mesh import make_mesh_2d, spawn_ranks  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import tnn_mnist as t_flagship  # noqa: E402
from repro_torch.launch import tnn_frontend_lm as t_frontend  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.configs import ARCHS as LM_ARCHS  # noqa: E402
from repro_torch.configs import get_config as get_lm_config  # noqa: E402
from repro_torch.configs import smoke_config as lm_smoke_config  # noqa: E402
from repro_torch.models import model as lm_model  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    draw_normal as lm_draw_normal, is_spec as lm_is_spec, materialize as lm_materialize,
    tree_flatten as lm_tree_flatten, tree_map as lm_tree_map,
)
from repro_torch.serve.engine import Engine as LMEngine  # noqa: E402
from repro_torch.serve.tnn_engine import ClassifyRequest, TNNEngine  # noqa: E402
from repro_torch.roofline import analysis as RL  # noqa: E402
from repro_torch.sharding import partition as PT  # noqa: E402
from repro_torch.sharding.context import use_partitioning  # noqa: E402
from repro_torch.train import optimizer as lm_opt  # noqa: E402
from repro_torch.train import train_step as lm_ts  # noqa: E402
from repro_torch.train.tnn_trainer import WaveStream  # noqa: E402
from repro_torch.utils.tracing import (  # noqa: E402
    collectives_recorded, kernel_launch_count, read_counts, reset_counts,
)

# Every kernel's bytes and operations, and the H100 SXM peaks they are priced
# at (NVIDIA's data sheet, dense, 700 W), are repro_torch.roofline.analysis's:
# the dry run reads the same counts.
KERNELS = ("tnn_wave", "tnn_column", "stdp_update", "wta", "threefry")
SERVE_ARGS = ["--arch", "tnn-mnist", "--sites", "625", "--slots", "64",
              "--requests", "512", "--train-waves", "4"]
TRAIN_WAVES, SLOTS, REQUESTS, FIT_IMAGES = 4, 64, 512, 256
# the train phase: the launcher's full-width epoch (train_config(625))
EPOCH_WAVES, WAVE_BATCH, TRAIN_IMAGES, EVAL_IMAGES = 32, 16, 512, 256
TRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_train")  # .gitignore lists build/
T, W_MAX = 8, 7
STDP_TABLE = default_stabilize_table(W_MAX)
MU = dict(mu_capture=10 / 16, mu_backoff=6 / 16, mu_search=2 / 16)


def sass_mix(name: str, kernel: str) -> dict:
    """Opcode counts of the kernel function ``kernel`` in the built library
    ``name``, from ``cuobjdump -sass`` beside nvcc ({} without it)."""
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=120).stdout
    counts, inside = {}, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            m = re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


PHASES = []   # (short name, start time) of each phase, in order


def phase(name: str) -> None:
    """Start a phase: print the one before's seconds, then the name."""
    now = time.perf_counter()
    if PHASES:
        print(f"  [{PHASES[-1][0]}: {now - PHASES[-1][1]:.1f} s]", flush=True)
    short = re.split(r"[:(]", name)[0].strip()
    n = sum(p == short or p.startswith(short + " #") for p, _ in PHASES)
    PHASES.append((f"{short} #{n + 1}" if n else short, now))
    print(f"== {name}", flush=True)


def phase_seconds() -> dict:
    """Every phase's seconds so far (the running one to now)."""
    ends = [t for _, t in PHASES[1:]] + [time.perf_counter()]
    return {name: round(end - t, 1) for (name, t), end in zip(PHASES, ends)}


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _rand_inputs(cfg: NetworkConfig, B: int, seed: int, dev: torch.device):
    """Seeded volleys, weights and STDP uniforms, drawn on the host."""
    g = _gen(seed)
    T_ = cfg.layers[0].column.wave.T
    C, p1 = cfg.layers[0].n_cols, cfg.layers[0].column.p
    x = torch.randint(0, T_ + 1, (B, C, p1), generator=g, dtype=torch.uint8)
    ws = [torch.randint(0, l.column.wave.w_max + 1,
                        (l.n_cols, l.column.p, l.column.q), generator=g,
                        dtype=torch.int8) for l in cfg.layers]
    us = [torch.rand((l.n_cols, 2, B, l.column.p, l.column.q), generator=g)
          for l in cfg.layers]
    return (x.to(dev), [w.to(dev) for w in ws], [u.to(dev) for u in us])


def _max_err(a, b) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def _require_exact(name: str, err: int) -> int:
    if err:
        raise AssertionError(f"{name}: kernel disagrees with the plain version "
                             f"(max_abs_err={err})")
    return err


# ---------------------------------------------------------------------------
# The fused wave kernel (port slice 1)
# ---------------------------------------------------------------------------


def check_case(name, cfg, B, seed, dev):
    """Kernel vs plain version on the card, forward and learn, bit for bit;
    returns the largest absolute difference (0, or it raises)."""
    x, ws, us = _rand_inputs(cfg, B, seed, dev)
    plan = network_plan(cfg, B)
    pairs = [(u[:, 0], u[:, 1]) for u in us]
    zk = tnn_wave.wave_forward(x, ws, plan=plan)
    zp = tnn_wave.wave_forward_plain(x, ws, plan=plan)
    (zlk, nk) = tnn_wave.wave_train(x, ws, pairs, plan=plan)
    (zlp, np_) = tnn_wave.wave_train_plain(x, ws, pairs, plan=plan)
    torch.cuda.synchronize()
    err = 0
    for a, b in list(zip(zk, zp)) + list(zip(zlk, zlp)) + list(zip(nk, np_)):
        err = max(err, _max_err(a, b))
    spikes = [int((z < plan.T).sum()) for z in zk]
    nets = [int(n.abs().sum()) for n in nk]
    print(f"  {name}: B={B} thetas={plan.thetas} spikes/layer={spikes} "
          f"|net|/layer={nets} max_abs_err={err}", flush=True)
    return _require_exact(name, err)


def time_cuda(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` back-to-back calls (CUDA events, after
    a warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def on_card(events):
    """The card's own events (kernels, copies) of a profile: a host op's
    entry repeats the device time of the kernels it launched."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, iters: int) -> float:
    """Mean device time per call over ``iters`` calls, after a warm-up call:
    the card's own events under torch.profiler. Unlike CUDA events around
    back-to-back calls it leaves out the host's time between launches,
    which for a ~30 us kernel behind a Python wrapper is of the same size."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in on_card(prof.key_averages()))
    if busy_us <= 0:
        raise AssertionError("the profile shows no device time")
    return busy_us / 1e3 / iters


def in_turns(kernel, plain, iters: int, plain_iters: int = 5):
    """(kernel ms, plain ms, readings): device ms per call in turns, plain,
    kernel, kernel, plain, each the best of its two; then the kernel's
    CUDA-event ms per call (host gaps included)."""
    plain_a = device_ms(plain, plain_iters)
    ms_a = device_ms(kernel, iters)
    ms_b = device_ms(kernel, iters)
    plain_b = device_ms(plain, plain_iters)
    events = time_cuda(kernel, iters)
    return (min(ms_a, ms_b), min(plain_a, plain_b),
            (plain_a, ms_a, ms_b, plain_b, events))


def _timing(name, B, kernel_ms, plain_ms, readings, work: RL.Work):
    """One kernel's timings beside its bound (``work``'s, from
    repro_torch.roofline.analysis)."""
    nbytes, ops, t_ops = work.bytes, work.ops, work.ops_ms
    bms, by, bytes_ms = work.bound()
    print(f"  {name} B={B}: kernel {readings[1]:.4f}/{readings[2]:.4f} ms on the "
          f"card ({readings[4]:.4f} ms per call by CUDA events), plain "
          f"{readings[0]:.3f}/{readings[3]:.3f} ms, bound {bms:.5f} ms ({by}; "
          f"{nbytes} bytes = {bytes_ms:.6f} ms, {ops} ops = {t_ops:.6f} ms)",
          flush=True)
    return dict(B=B, ms=kernel_ms, plain_ms=plain_ms, events_ms=readings[4],
                bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops,
                bytes_ms=bytes_ms, ops_ms=t_ops)


def measure(cfg, dev):
    """Wave kernel and plain ms at the fused path's shapes: forward at B=64
    and learn at B=16, full width, the served thresholds."""
    out = {}
    for half, B, iters in (("forward", 64, 200), ("learn", 16, 100)):
        x, ws, us = _rand_inputs(cfg, B, seed=11, dev=dev)
        plan = network_plan(cfg, B)
        pairs = [(u[:, 0], u[:, 1]) for u in us]
        if half == "forward":
            k = lambda: tnn_wave.wave_forward(x, ws, plan=plan)  # noqa: E731
            p = lambda: tnn_wave.wave_forward_plain(x, ws, plan=plan)  # noqa: E731
        else:
            k = lambda: tnn_wave.wave_train(x, ws, pairs, plan=plan)  # noqa: E731
            p = lambda: tnn_wave.wave_train_plain(x, ws, pairs, plan=plan)  # noqa: E731
        ms, plain_ms, readings = in_turns(k, p, iters)
        work = RL.forward_work(x, ws, plan.thetas, plan.T)
        if half == "learn":  # uniforms in, nets out, two Bernoulli compares
            work = work + RL.learn_epilogue_work(
                plan.n_cols, B, [p_ * q_ for p_, q_ in zip(plan.ps, plan.qs)])
        out[half] = _timing(half, B, ms, plain_ms, readings, work)
    return out


# ---------------------------------------------------------------------------
# The wave kernel's tuned launch geometry (port slice 13)
# ---------------------------------------------------------------------------

AUTOTUNE_SERVE = ["--arch", "tnn-mnist", "--sites", "625", "--slots", "8",
                  "--requests", "64", "--impl", "fused", "--device", "cuda"]


def _wave_plain_chunked(x, params, plan):
    """``wave_forward_plain`` in site chunks of CELL_CHUNK (a 65,536-row
    batch's planes do not fit whole), joined along the sites."""
    outs = [tnn_wave.wave_forward_plain(x[:, c0:c1], [w[c0:c1] for w in params], plan=plan)
            for c0, c1 in _plain_chunks(x.shape[1])]
    return [torch.cat([o[l] for o in outs], dim=1).to(SPIKE_DTYPE)
            for l in range(plan.n_layers)]


def autotune_geometry(cfg, B: int, seed: int, dev) -> dict:
    """One default geometry: the static launch against the plain version,
    every candidate launch against the static one, bit for bit; then the
    static and the cached launches timed in turns (static, tuned, tuned,
    static; device ms a wave by ``autotune.device_ms``, best of each pair)."""
    key = padding.plan_geometry_key(cfg, B)
    T_ = cfg.layers[0].column.wave.T
    g = torch.Generator(device=dev).manual_seed(seed)   # no uniforms: 126 GB at B = 65,536
    x = torch.randint(0, T_ + 1, (B, cfg.layers[0].n_cols, cfg.layers[0].column.p),
                      generator=g, device=dev, dtype=torch.uint8)
    ws = [torch.randint(0, l.column.wave.w_max + 1, (l.n_cols, l.column.p, l.column.q),
                        generator=g, device=dev, dtype=torch.int8) for l in cfg.layers]
    static = network_plan(cfg, B, launch=padding.STATIC)
    want = tnn_wave.wave_forward(x, ws, plan=static)
    err = max(_max_err(a, b) for a, b in zip(want, _wave_plain_chunked(x, ws, static)))
    for cand in autotune.candidates(T_, B):
        got = tnn_wave.wave_forward(x, ws, plan=network_plan(cfg, B, launch=cand))
        err = max(err, max(_max_err(a, b) for a, b in zip(got, want)))
    torch.cuda.synchronize()
    _require_exact(f"autotune {key}", err)
    tuned = network_plan(cfg, B)
    cached = autotune.lookup(key)
    if cached is None or tuned.launch != cached:
        raise AssertionError(f"{key}: the plan carries {tuned.launch}, the cache {cached}")
    one = autotune.device_ms(lambda: tnn_wave.wave_forward(x, ws, plan=static), 1)
    iters = max(5, min(200, int(2.0 / max(one, 1e-3))))
    reads = [autotune.device_ms(lambda p=p: tnn_wave.wave_forward(x, ws, plan=p), iters)
             for p in (static, tuned, tuned, static)]
    static_ms, tuned_ms = min(reads[0], reads[3]), min(reads[1], reads[2])
    print(f"  {key}: {len(autotune.candidates(T_, B))} candidates and the static launch "
          f"bit-equal to the plain version; cached rows={cached[0]} warps={cached[1]}: "
          f"static {static_ms:.5f} ms, tuned {tuned_ms:.5f} ms a wave ({reads}, "
          f"{iters} waves a reading)", flush=True)
    return {"key": key, "candidates": len(autotune.candidates(T_, B)), "max_abs_err": err,
            "rows": cached[0], "warps": cached[1], "static_ms": static_ms,
            "tuned_ms": tuned_ms, "readings": reads, "iters": iters}


def _spied_serve():
    """The fused launcher at 625 sites and 8 slots with every wave launch's
    (learn, B, rows, warps) recorded; plans built afresh."""
    seen = []
    real = tnn_wave._launch

    def spy(a, device):
        seen.append((a.learn, a.B, a.rows, a.threads // 32))
        real(a, device)

    network_plan.cache_clear()
    tnn_wave._launch = spy
    try:
        rep = launch_serve.main(AUTOTUNE_SERVE)
        torch.cuda.synchronize()
    finally:
        tnn_wave._launch = real
        network_plan.cache_clear()
    return rep, [s for s in seen if not s[0]], [s for s in seen if s[0]]


def autotune_serve_spy(dev) -> dict:
    """Serve 64 requests at 625 sites and 8 slots through the fused launcher
    with every wave launch's arguments recorded: each forward launch takes
    the checked-in cache's (rows, warps), the learning ones the static rule
    (all 8 warps). Then the same with a copy of the cache whose entry for
    this geometry names another candidate (its own environment variable):
    the launches follow the copy, and every request gets the same class."""
    key = padding.plan_geometry_key(launcher_network_config(625, impl="fused"), 8)
    out = {"key": key}
    other = None
    for name in ("checked-in", "altered"):
        if name == "altered":
            other = next(c for c in autotune.candidates(T, 8) if c != tuple(out["rows_warps"]))
            path = os.path.join(ROOT, "build", "tuned_blocks_altered.json")
            data = json.load(open(autotune.cache_path()))
            data["geometries"][key] = dict(data["geometries"][key], rows=other[0],
                                           warps=other[1])
            with open(path, "w") as f:
                json.dump(data, f)
            os.environ["REPRO_TORCH_TUNED_BLOCKS"] = path
        try:
            want = autotune.lookup(key)
            rep, fwd, learn = _spied_serve()
        finally:
            os.environ.pop("REPRO_TORCH_TUNED_BLOCKS", None)
        if name == "altered" and want != other:
            raise AssertionError(f"the altered cache reads {want}, not {other}")
        if not fwd or any(s[1:] != (8, *want) for s in fwd):
            raise AssertionError(f"serving at 8 slots ({name} cache) launched "
                                 f"{sorted(set(fwd))}, the cache says {want}")
        if any(s[3] != tnn_wave.MAX_THREADS // 32 for s in learn):
            raise AssertionError(f"a learning launch took the tuned warps: {sorted(set(learn))}")
        if name == "checked-in":
            out.update(rows_warps=list(want), forward_launches=len(fwd),
                       learn_launches=len(learn))
            results = rep.results
        elif rep.results != results:
            raise AssertionError("serving with the altered cache classified differently")
        print(f"  serving (625 sites, 8 slots, {rep.stats.requests} requests, {name} cache): "
              f"{len(fwd)} forward launches, every one at rows={want[0]} warps={want[1]} "
              f"({key}); {len(learn)} learning launches at the static rule", flush=True)
    out["altered_rows_warps"] = list(other)
    print(f"  the altered cache's launches give the checked-in run's class ids for all "
          f"{len(results)} requests", flush=True)
    return out


def autotune_phase(dev, smi: str) -> dict:
    """The checked-in cache passes ``--check``; every default geometry's
    candidates bit-equal; static against tuned ms; the serving spy."""
    if autotune.main(["--check"]) != 0:
        raise AssertionError("the tuned cache lacks a default geometry")
    tuned_on = autotune.cache_device().get("nvidia_smi")
    print(f"  the cache was tuned on {tuned_on}; this card: {smi}", flush=True)
    geoms = [autotune_geometry(cfg, B, 40 + i, dev)
             for i, (cfg, B) in enumerate(autotune.default_geometries())]
    return {"tuned_on": tuned_on, "geometries": geoms, "serve": autotune_serve_spy(dev)}


FWD_SEEN = {}   # geometry key -> [launches, the (rows, warps) its plans carried]
_WAVE_FORWARD = tnn_wave.wave_forward


def _recorded_wave_forward(x, params, *, plan):
    if x.is_cuda:
        key = (f"C{plan.n_cols}_p{'x'.join(map(str, plan.ps))}_q{'x'.join(map(str, plan.qs))}"
               f"_T{plan.T}_B{x.shape[0]}_packed{int(plan.packed)}")
        seen = FWD_SEEN.setdefault(key, [0, set()])
        seen[0] += 1
        seen[1].add(plan.launch)
    return _WAVE_FORWARD(x, params, plan=plan)


def record_forward_geometries(on: bool) -> None:
    """While on, count every forward wave that ``core.network`` launches on
    the card (it calls ``tnn_wave.wave_forward`` through the module) by its
    geometry key (``padding.plan_geometry_key``'s string), with the launch
    extents its plans carried."""
    tnn_wave.wave_forward = _recorded_wave_forward if on else _WAVE_FORWARD


def forward_geometries_report() -> dict:
    """The main path's forward geometries in this process: each plan
    carried the cache's extents where it has an entry and the static rule
    (None) where it has none; printed with which is which."""
    out = {}
    for key, (n, launches) in sorted(FWD_SEEN.items()):
        cached = autotune.lookup(key)
        if launches != {cached}:
            raise AssertionError(f"{key}: the main path's plans carried {launches}, "
                                 f"the cache says {cached}")
        out[key] = {"launches": n, "cached": list(cached) if cached else None}
        how = f"cached rows={cached[0]} warps={cached[1]}" if cached else "static rule"
        print(f"  forward geometry {key}: {n} launches, {how}", flush=True)
    serve_key = padding.plan_geometry_key(launcher_network_config(625, impl="fused"), SLOTS)
    if out.get(serve_key, {}).get("cached") is None:
        raise AssertionError(f"the {SLOTS}-slot serve ({serve_key}) launched without a "
                             f"cache entry")
    return out


def caps_config(C: int) -> NetworkConfig:
    """The largest layer-1 the fused plan takes (p1=512, q=128) and a
    128-wide second layer: exercises shared memory above 48 KB."""
    wave = WaveSpec()
    l1 = LayerConfig(C, ColumnConfig(p=512, q=128, theta=300, wave=wave, impl="fused"))
    l2 = LayerConfig(C, ColumnConfig(p=128, q=128, theta=3, wave=wave, impl="fused"))
    return NetworkConfig(layers=(l1, l2))


# ---------------------------------------------------------------------------
# The per-layer kernels (port slice 2)
# ---------------------------------------------------------------------------


def _spikes(g, shape, dev, T_=T):
    return torch.randint(0, T_ + 1, shape, generator=g, dtype=torch.uint8).to(dev)


def _weights(g, shape, dev, w_max=W_MAX):
    return torch.randint(0, w_max + 1, shape, generator=g, dtype=torch.int8).to(dev)


def check_column(name, x, w, theta, wta_on=True, T_=T):
    """Column kernel vs plain on the card; returns (err, z as uint8)."""
    zk = tnn_column.column_forward_layer(x, w, theta=theta, T=T_, wta=wta_on)
    zp = tnn_column.column_forward_layer_plain(x, w, theta=theta, T=T_, wta=wta_on)
    torch.cuda.synchronize()
    err = _max_err(zk, zp)
    if zk.dtype != torch.int32:
        raise AssertionError(f"{name}: z is {zk.dtype}, not int32")
    print(f"  column {name}: x {tuple(x.shape)} w {tuple(w.shape)} T={T_} "
          f"theta={theta} wta={wta_on} spikes={int((zk < T_).sum())} "
          f"max_abs_err={err}", flush=True)
    return _require_exact(f"column {name}", err), zk.to(SPIKE_DTYPE)


# (time_bits, weight_bits) beside the paper's (3, 3): the tensor-core tiling
# depends on T (16/T rows per m16 tile, or T/16 tiles per row) and on the
# ramp steps per synapse (T - 1 rounded up to 4)
OTHER_SPECS = ((1, 1), (4, 2), (7, 7))


def spec_theta(p: int, T_: int, w_max: int) -> int:
    """A layer-1 threshold at which some neurons cross and some do not."""
    return max(1, p * min(T_ - 1, w_max) // 8)


def odd_config(C: int) -> NetworkConfig:
    """32x11 -> 11x9 at T = 8: a layer-2 fan-in off the multiple of 4 the
    tensor-core body's T = 8 form takes, and uniform planes (11*9 floats)
    that are not 16-byte multiples, so the learning half stages them 4 bytes
    at a time."""
    wave = WaveSpec()
    l1 = LayerConfig(C, ColumnConfig(p=32, q=11, theta=12, wave=wave, impl="fused"))
    l2 = LayerConfig(C, ColumnConfig(p=11, q=9, theta=2, wave=wave, impl="fused"))
    return NetworkConfig(layers=(l1, l2))


def spec_config(time_bits: int, weight_bits: int, C: int) -> NetworkConfig:
    """The prototype's 32x12 -> 12x10 topology at another wave spec."""
    wave = WaveSpec(time_bits=time_bits, weight_bits=weight_bits)
    th1 = spec_theta(32, wave.T, wave.w_max)
    l1 = LayerConfig(C, ColumnConfig(p=32, q=12, theta=th1, wave=wave, impl="fused"))
    l2 = LayerConfig(C, ColumnConfig(p=12, q=10, theta=1, wave=wave, impl="fused"))
    return NetworkConfig(layers=(l1, l2))


def check_columns(dev):
    err = 0
    for th1, th2 in ((24, 8), (12, 3)):
        g = _gen(100 + th1)
        x = _spikes(g, (64, 625, 32), dev)
        w1, w2 = _weights(g, (625, 32, 12), dev), _weights(g, (625, 12, 10), dev)
        e, z1 = check_column(f"full layer 1 B=64 theta=({th1},{th2})", x, w1, th1)
        err = max(err, e)
        e, _ = check_column(f"full layer 2 B=64 theta=({th1},{th2})", z1, w2, th2)
        err = max(err, e)
    g = _gen(110)
    w1 = _weights(g, (625, 32, 12), dev)
    for B in (13, 300):
        e, _ = check_column(f"full layer 1 B={B}", _spikes(g, (B, 625, 32), dev), w1, 12)
        err = max(err, e)
    e, _ = check_column("full layer 1 no WTA", _spikes(g, (64, 625, 32), dev), w1, 12,
                        wta_on=False)
    err = max(err, e)
    # an odd batch: the last m16 tile holds one live row of two
    e, z1 = check_column("full layer 1 B=7", _spikes(g, (7, 625, 32), dev), w1, 12)
    err = max(err, e)
    e, _ = check_column("full layer 2 B=7", z1, _weights(g, (625, 12, 10), dev), 3)
    err = max(err, e)
    for tb, wb in OTHER_SPECS:
        T_, w_max = 1 << tb, (1 << wb) - 1
        for B in (5, 64):
            x = _spikes(g, (B, 24, 32), dev, T_)
            e, z1 = check_column(f"24 sites layer 1 (time_bits, weight_bits)=({tb},{wb}) "
                                 f"B={B}", x, _weights(g, (24, 32, 12), dev, w_max),
                                 spec_theta(32, T_, w_max), T_=T_)
            err = max(err, e)
            e, _ = check_column(f"24 sites layer 2 ({tb},{wb}) B={B} no WTA", z1,
                                _weights(g, (24, 12, 10), dev, w_max), 1,
                                wta_on=False, T_=T_)
            err = max(err, e)
    for label, (C, B, p, q, theta) in (
            ("one column p=1024 q=16", (1, 64, 1024, 16, 600)),
            ("q=128", (132, 40, 32, 128, 24)),
            ("p=2048 q=128 (weights from device memory)", (4, 8, 2048, 128, 4000))):
        x = _spikes(g, (B, C, p), dev)
        x = x.transpose(0, 1).contiguous().transpose(0, 1) if C > 1 else x  # strided
        e, _ = check_column(label, x, _weights(g, (C, p, q), dev), theta)
        err = max(err, e)
    return err


def check_stdp_one(name, w, x, z, u_up, u_dn, out):
    kw = dict(T=T, w_max=W_MAX, table=STDP_TABLE, out=out, **MU)
    rk = stdp_update.stdp_update_layer(w, x, z, u_up, u_dn, **kw)
    rp = stdp_update.stdp_update_layer_plain(w, x, z, u_up, u_dn, **kw)
    torch.cuda.synchronize()
    err = _max_err(rk, rp)
    moved = rk if out == "net" else rk - w.to(torch.int32)
    pl = stdp_update.plan(x.shape[0], w.shape[1], w.shape[2])
    fill = "bulk" if stdp_update.bulk_fill(u_up, u_dn) else "cp.async"
    print(f"  stdp {name} out={out}: w {tuple(w.shape)} B={x.shape[0]} "
          f"({pl.tiles} tile(s) of {pl.n}, {pl.rows} rows/stage, {fill} fill) "
          f"|moved|={int(moved.abs().sum())} max_abs_err={err}", flush=True)
    return _require_exact(f"stdp {name}", err)


def _stdp_inputs(g, C, B, dev, th1=12):
    """Both layers' STDP inputs: random volleys into layer 1, layer 1's
    post-WTA output into layer 2, as the warm-up wave has them."""
    x = _spikes(g, (B, C, 32), dev)
    w1, w2 = _weights(g, (C, 32, 12), dev), _weights(g, (C, 12, 10), dev)
    z1 = tnn_column.column_forward_layer_plain(x, w1, theta=th1, T=T, wta=True).to(SPIKE_DTYPE)
    z2 = tnn_column.column_forward_layer_plain(z1, w2, theta=3, T=T, wta=True).to(SPIKE_DTYPE)
    u1 = torch.rand((C, 2, B, 32, 12), generator=g).to(dev)
    u2 = torch.rand((C, 2, B, 12, 10), generator=g).to(dev)
    return [(w1, x, z1, u1), (w2, z1, z2, u2)]


def _stdp_random(g, C, B, p, q, dev):
    """Random weights, volleys and a (C, 2, B, p, q) draw at any widths."""
    return (_weights(g, (C, p, q), dev), _spikes(g, (B, C, p), dev),
            _spikes(g, (B, C, q), dev),
            torch.rand((C, 2, B, p, q), generator=g).to(dev))


def _shifted(u):
    """A copy of ``u`` whose storage starts 4 bytes past an aligned one:
    every plane is off the 16-byte grid, so the ring fills by cp.async."""
    flat = torch.empty(u.numel() + 1, dtype=u.dtype, device=u.device)
    flat[1:] = u.flatten()
    return flat[1:].view(u.shape)


def check_stdps(dev):
    """The STDP kernel against its plain version: both served layers at full
    width (every uniform case, both outputs, the draw's views, two separate
    tensors and a misaligned copy), few sites (C = 1, 8: fewer items than
    persistent blocks), odd and long batches (B = 7, 1000: many chunks, the
    last partial), odd widths (p*q = 99: the cp.async fill), and planes
    split into several tiles."""
    err = 0
    g = _gen(200)
    for l, (w, x, z, u) in enumerate(_stdp_inputs(g, 625, 16, dev), start=1):
        for out in ("weights", "net"):
            for kind, uu in (("random", u), ("all-0", torch.zeros_like(u)),
                             ("all-1", torch.ones_like(u))):
                err = max(err, check_stdp_one(f"full layer {l} B=16 {kind}",
                                              w, x, z, uu[:, 0], uu[:, 1], out))
            err = max(err, check_stdp_one(
                f"full layer {l} B=16 separate u_up/u_dn", w, x, z,
                u[:, 0].contiguous(), u[:, 1].contiguous(), out))
        us = _shifted(u)
        err = max(err, check_stdp_one(f"full layer {l} B=16 misaligned draw",
                                      w, x, z, us[:, 0], us[:, 1], "weights"))
    for C, B in ((1, 16), (8, 16), (8, 7), (8, 1000), (1, 1000)):
        for l, (w, x, z, u) in enumerate(_stdp_inputs(g, C, B, dev), start=1):
            for out in ("weights", "net"):
                err = max(err, check_stdp_one(f"{C} site(s) layer {l} B={B}",
                                              w, x, z, u[:, 0], u[:, 1], out))
    for label, (C, B, p, q) in (
            ("odd widths 11x9", (48, 37, 11, 9)),
            ("odd widths 11x9, one site", (1, 7, 11, 9)),
            ("odd widths 11x9, long batch", (8, 1000, 11, 9)),
            ("2048x128 (tiles of 7 rows)", (3, 7, 2048, 128)),
            ("4x2500 (tiles that are pieces of a row)", (4, 9, 4, 2500)),
            ("3x1025 (pieces of a row, unaligned)", (2, 5, 3, 1025)),
            ("33x31 (two tiles, unaligned)", (20, 33, 33, 31))):
        w, x, z, u = _stdp_random(g, C, B, p, q, dev)
        for out in ("weights", "net"):
            err = max(err, check_stdp_one(label, w, x, z, u[:, 0], u[:, 1], out))
        err = max(err, check_stdp_one(f"{label} separate u_up/u_dn", w, x, z,
                                      u[:, 0].contiguous(), u[:, 1].contiguous(),
                                      "net"))
    # volleys read through strides on every axis (views of (p, B, C) tensors)
    w, x, z, u = _stdp_random(g, 625, 16, 32, 12, dev)
    xs = x.permute(2, 0, 1).contiguous().permute(1, 2, 0)
    zs = z.permute(2, 0, 1).contiguous().permute(1, 2, 0)
    err = max(err, check_stdp_one("full layer 1 B=16 strided volleys", w, xs, zs,
                                  u[:, 0], u[:, 1], "net"))
    return err


def check_wtas(dev):
    """The WTA kernel against its plain version: q = 1, 12, 13, 128 at 1,
    40,000 and 40,001 rows (a partial last tile), views that start off the
    16-byte grid (the cp.async fill and plain stores), ties and all-T
    rows."""
    err = 0
    g = _gen(300)
    cases = [(f"({rows}, {q})", torch.randint(0, T + 1, (rows, q), generator=g,
                                              dtype=torch.int32).to(dev))
             for q in (1, 12, 13, 128) for rows in (1, 40_000, 40_001)]
    for rows, q in ((4097, 13), (40_001, 13), (40_001, 12), (4097, 1)):
        z = torch.randint(0, T + 1, (rows, q), generator=g, dtype=torch.int32).to(dev)
        cases.append((f"z[1:] of ({rows}, {q}), {4 * q} bytes in", z[1:]))
    ties = torch.randint(T - 2, T + 1, (4096, 12), generator=g, dtype=torch.int32)
    silent = torch.full((4096, 12), T, dtype=torch.int32)
    silent[::3, 5] = T - 1
    cases += [("ties", ties.to(dev)), ("all-T rows", silent.to(dev))]
    for name, z in cases:
        zk, zp = wta.wta(z, T=T), wta.wta_plain(z, T=T)
        torch.cuda.synchronize()
        e = _max_err(zk, zp)
        winners = int((zk < T).sum())
        if int(((zk < T).sum(-1) > 1).sum()):
            raise AssertionError(f"wta {name}: a row kept two spikes")
        tile = wta.tile_rows(z.shape[0], z.shape[1], _sm_count(dev))
        print(f"  wta {name}: tile {tile} rows, {-(-z.shape[0] // tile)} blocks, "
              f"winners={winners} max_abs_err={e}", flush=True)
        err = max(err, _require_exact(f"wta {name}", e))
    return err


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def measure_layer_kernels(dev):
    """Per-layer kernels and plain versions at the pallas path's shapes.
    Column: one served wave, layer 1 + layer 2 at B=64 and the served
    thresholds (24, 8). STDP: one warm-up wave, both layers at B=16,
    out="weights". WTA: one (64*625, 12) call. The pallas path launches
    the two layers equally often, so a kernel's ms, plain ms and bound are
    the mean over its two layers' launches: launches x ms is its device
    time on the path, and twice the ms is one wave's worth."""
    g = _gen(400)
    out = {}
    # column forward
    x = _spikes(g, (64, 625, 32), dev)
    w1, w2 = _weights(g, (625, 32, 12), dev), _weights(g, (625, 12, 10), dev)
    z1 = tnn_column.column_forward_layer(x, w1, theta=24, T=T, wta=True).to(SPIKE_DTYPE)
    layers = [(x, w1, 24), (z1, w2, 8)]
    per, tot = [], dict(ms=0.0, plain_ms=0.0, bytes=0, ops=0)
    for l, (xl, wl, th) in enumerate(layers, start=1):
        k = lambda: tnn_column.column_forward_layer(xl, wl, theta=th, T=T, wta=True)  # noqa: E731
        p = lambda: tnn_column.column_forward_layer_plain(xl, wl, theta=th, T=T, wta=True)  # noqa: E731
        ms, plain_ms, readings = in_turns(k, p, 200)
        per.append(_timing(f"column layer {l}", 64, ms, plain_ms, readings,
                           RL.column_work(xl, wl, th, T)))
    out["tnn_column"] = _mean_timing(per)
    # STDP update
    per = []
    for l, (w, xl, z, u) in enumerate(_stdp_inputs(g, 625, 16, dev, th1=24), start=1):
        kw = dict(T=T, w_max=W_MAX, table=STDP_TABLE, out="weights", **MU)
        k = lambda: stdp_update.stdp_update_layer(w, xl, z, u[:, 0], u[:, 1], **kw)  # noqa: E731
        p = lambda: stdp_update.stdp_update_layer_plain(w, xl, z, u[:, 0], u[:, 1], **kw)  # noqa: E731
        ms, plain_ms, readings = in_turns(k, p, 100)
        C, pp, q = w.shape
        B = xl.shape[0]
        per.append(_timing(f"stdp layer {l}", B, ms, plain_ms, readings,
                           RL.stdp_work(C, B, pp, q)))
    out["stdp_update"] = _mean_timing(per)
    # WTA
    z = torch.randint(0, T + 1, (64 * 625, 12), generator=g, dtype=torch.int32).to(dev)
    ms, plain_ms, readings = in_turns(lambda: wta.wta(z, T=T),
                                      lambda: wta.wta_plain(z, T=T), 200)
    out["wta"] = _timing("wta (64*625, 12)", z.shape[0], ms, plain_ms, readings,
                         RL.wta_work(z.numel()))
    return out


def _mean_timing(per):
    """One launch's numbers, averaged over equally frequent launches."""
    n = len(per)
    nbytes, ops = sum(t["bytes"] for t in per) / n, sum(t["ops"] for t in per) / n
    t_ops = sum(t["ops_ms"] for t in per) / n
    bms, by, bytes_ms = RL.bound(nbytes, t_ops)
    return dict(B=per[0]["B"], ms=sum(t["ms"] for t in per) / n,
                plain_ms=sum(t["plain_ms"] for t in per) / n,
                events_ms=sum(t["events_ms"] for t in per) / n, bound_ms=bms,
                bound_by=by, bytes=nbytes, ops=ops, bytes_ms=bytes_ms,
                ops_ms=t_ops, per_layer=per)


# ---------------------------------------------------------------------------
# Serving paths
# ---------------------------------------------------------------------------


def serve_path(impl: str, dev):
    """One launcher run on the card with every count set to 0 just before
    it and read just after."""
    reset_counts()
    t0 = time.perf_counter()
    rep = launch_serve.main(SERVE_ARGS + ["--impl", impl, "--device", "cuda"])
    torch.cuda.synchronize()
    counts = read_counts()
    wall = time.perf_counter() - t0
    st = rep.stats
    print(f"  {impl} launcher wall {wall:.2f} s; launches {counts}", flush=True)
    if st.requests != REQUESTS or len(rep.results) != REQUESTS:
        raise AssertionError(f"{impl}: served {st.requests} of {REQUESTS} requests")
    if not all(0 <= c < 10 for c in rep.results.values()):
        raise AssertionError(f"{impl}: class id out of range")
    if not torch.isfinite(rep.vote_table).all():
        raise AssertionError(f"{impl}: vote table is not finite")
    return rep, counts, wall


def expected_launches(n_layers: int, served_waves: int) -> dict:
    """Per-layer launches of one launcher run: a forward per layer for each
    warm-up wave, fit chunk, served wave and the spike-count pass; an STDP
    update and a threefry draw per layer for each warm-up wave."""
    forwards = TRAIN_WAVES + FIT_IMAGES // SLOTS + served_waves + 1
    return {"tnn_column": n_layers * forwards,
            "stdp_update": n_layers * TRAIN_WAVES,
            "threefry": n_layers * TRAIN_WAVES}


def same_result(a, b, what: str) -> None:
    for l, (wa, wb) in enumerate(zip(a.params, b.params)):
        if not torch.equal(wa.cpu(), wb.cpu()):
            raise AssertionError(f"{what}: warmed layer-{l} weights differ")
    if not torch.equal(a.vote_table.cpu(), b.vote_table.cpu()):
        raise AssertionError(f"{what}: vote tables differ")
    diff = [u for u in b.results if a.results[u] != b.results[u]]
    if diff or len(a.results) != len(b.results):
        raise AssertionError(f"{what}: {len(diff)} class ids differ")


def profile_serve(rep, dev, impl: str, repeats: int = 5):
    """Steady-state serving with the launcher's warmed weights: the same 512
    requests served ``repeats`` times untraced (images/s, p50/p95 of each),
    then once under torch.profiler for where the time goes: device busy
    time by kernel, host time by op, and the device's idle share of the
    wall time. Every pass must give the launcher's class ids."""
    cfg = launcher_network_config(625, impl=impl)
    eng = TNNEngine(cfg, rep.params, n_slots=SLOTS, impl=impl, device=dev)
    eng.fit(*digits(FIT_IMAGES, seed=1))
    imgs = digits(REQUESTS, seed=2)[0]

    def run():
        eng.reset()
        for uid in range(REQUESTS):
            eng.submit(ClassifyRequest(uid=uid, image=imgs[uid]))
        t0 = time.perf_counter()
        done = eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if {u: r.result for u, r in done.items()} != rep.results:
            raise AssertionError(f"{impl}: steady-state serve changed a class id")
        return wall, eng.stats()

    run()  # warm-up pass
    steady = [run() for _ in range(repeats)]
    for wall, st in steady:
        print(f"  {impl} steady: {st.images_per_s:.1f} images/s, {st.waves_per_s:.1f} "
              f"waves/s, p50 {st.p50_ms:.3f} ms, p95 {st.p95_ms:.3f} ms", flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall, st = run()
    events = prof.key_averages()
    card = on_card(events)
    busy_us = sum(e.self_device_time_total for e in card)
    if busy_us <= 0:
        raise AssertionError(f"{impl}: the traced pass shows no device time")
    print(f"  {impl} traced pass: wall {1e3 * wall:.3f} ms for {st.waves} waves; "
          f"device busy {busy_us / 1e3:.3f} ms, idle share "
          f"{1 - busy_us / (1e6 * wall):.3f}", flush=True)
    top = sorted(card, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"    device {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:70]}")
    for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:8]:
        print(f"    host   {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:70]}")
    return {"steady_images_per_s": [s.images_per_s for _, s in steady],
            "steady_p50_ms": [s.p50_ms for _, s in steady],
            "steady_p95_ms": [s.p95_ms for _, s in steady],
            "traced_wall_ms": 1e3 * wall, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1 - busy_us / (1e6 * wall),
            "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top[:4]}}


def wide_config(C: int) -> NetworkConfig:
    """A "fused" network the wave kernel cannot hold: layer-1 fan-in 600
    is over its p1 cap, so it runs layer by layer on the per-layer
    kernels, as the reference's does."""
    wave = WaveSpec()
    l1 = LayerConfig(C, ColumnConfig(p=600, q=12, theta=300, wave=wave, impl="fused"))
    l2 = LayerConfig(C, ColumnConfig(p=12, q=10, theta=3, wave=wave, impl="fused"))
    return NetworkConfig(layers=(l1, l2))


def fallback_path(dev):
    """Forward and one learning wave of the wide "fused" network on the card
    (counts from 0) against the same calls on the CPU (the plain path)."""
    cfg = wide_config(16)
    if _uses_fused_wave(cfg):
        raise AssertionError("the wide network should not fit the wave kernel")
    x, ws, us = _rand_inputs(cfg, 32, seed=500, dev=torch.device("cpu"))
    reset_counts()
    zk = network_forward(x.to(dev), [w.to(dev) for w in ws], cfg)
    zlk, nwk = network_train_wave(x.to(dev), [w.to(dev) for w in ws], cfg,
                                  uniforms=[u.to(dev) for u in us])
    torch.cuda.synchronize()
    counts = read_counts()
    zp = network_forward(x, ws, cfg)
    zlp, nwp = network_train_wave(x, ws, cfg, uniforms=us)
    err = 0
    for a, b in list(zip(zk, zp)) + list(zip(zlk, zlp)) + list(zip(nwk, nwp)):
        err = max(err, _max_err(a.cpu(), b))
    print(f"  fused p1=600, 16 sites, B=32: launches {counts}; spikes/layer="
          f"{[int((z < T).sum()) for z in zk]} weights moved="
          f"{sum(int((a.cpu() != b).sum()) for a, b in zip(nwk, ws))} "
          f"max_abs_err={err}", flush=True)
    _require_exact("fallback network", err)
    want = {"tnn_wave[forward]": 0, "tnn_wave[learn]": 0, "tnn_column": 4,
            "stdp_update": 2, "wta": 0, "threefry": 0}
    if counts != want:
        raise AssertionError(f"fallback launches {counts}, expected {want}")
    return err, counts


# ---------------------------------------------------------------------------
# The threefry STDP uniforms (port slice 5)
# ---------------------------------------------------------------------------


def check_threefry_one(name, key, C, B, p, q, dev) -> float:
    """Kernel vs plain draw on the card, bit for bit; returns max_abs_err."""
    shape = (2, B, p, q)
    uk = threefry.layer_uniforms(key, C, shape, device=dev)
    up = threefry.layer_uniforms_plain(key, C, shape, device=dev)
    torch.cuda.synchronize()
    same = torch.equal(uk.view(torch.int32), up.view(torch.int32))
    err = float((uk - up).abs().max())
    n = 2 * B * p * q
    print(f"  threefry {name}: {C} column(s) of {shape} = {n} floats "
          f"({-(-n // (4 * threefry.THREADS))} block(s) a column), "
          f"min {float(uk.min()):.6f} max {float(uk.max()):.6f}, bits equal "
          f"{same}, max_abs_err={err}", flush=True)
    if not same or err:
        raise AssertionError(f"threefry {name}: kernel disagrees with the plain "
                             f"version (max_abs_err={err})")
    return err


def check_threefrys(dev) -> float:
    """The known-answer vector through the kernel's own hash, 100,000 random
    counter pairs against the plain hash, then the uniform draw at the
    training path's shapes and its edges."""
    y = threefry.hash_pairs((0x13198A2E, 0x03707344),
                            torch.tensor([0x243F6A88], device=dev),
                            torch.tensor([0x85A308D3], device=dev))
    got = tuple(int(v) for v in y)
    print(f"  threefry known-answer vector: {got[0]:#010x} {got[1]:#010x} "
          f"(want 0xc4923a9c 0x483df7a0)", flush=True)
    if got != (0xC4923A9C, 0x483DF7A0):
        raise AssertionError(f"threefry known-answer vector: {got}")
    g = _gen(600)
    x0, x1 = (torch.randint(0, 2**32, (100_000,), generator=g, dtype=torch.int64)
              for _ in range(2))
    key = t_random.PRNGKey(600)
    hk = threefry.hash_pairs(key, x0.to(dev), x1.to(dev))
    hp = threefry.hash_pairs(key, x0, x1)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(hk, hp)):
        raise AssertionError("threefry hash disagrees with the plain version")
    err = 0.0
    layer_key = t_random.split(t_random.PRNGKey(1), 2)
    for name, key, (C, B, p, q) in (
            ("layer 1 B=16", layer_key[0], (625, 16, 32, 12)),
            ("layer 2 B=16", layer_key[1], (625, 16, 12, 10)),
            ("layer 1 B=1", layer_key[0], (625, 1, 32, 12)),
            ("layer 2 B=7", layer_key[1], (625, 7, 12, 10)),
            ("layer 1 B=1000, 8 sites", layer_key[0], (8, 1000, 32, 12)),
            ("one column", t_random.PRNGKey(5), (1, 16, 32, 12)),
            ("odd widths 32x11 B=7", t_random.PRNGKey(6), (48, 7, 32, 11)),
            ("odd widths 11x9 B=1 (columns off the 16-byte grid)",
             t_random.PRNGKey(7), (3, 1, 11, 9)),
            ("1092 floats a column (crosses a 1024-float block)",
             t_random.PRNGKey(8), (5, 3, 13, 14)),
            ("1026 floats a column (crosses, unaligned)", t_random.PRNGKey(9),
             (4, 1, 27, 19)),
            ("70,000 columns of 2 (more columns than the grid's y)",
             t_random.PRNGKey(10), (70_000, 1, 1, 1))):
        err = max(err, check_threefry_one(name, key, C, B, p, q, dev))
    return max(err, check_nested_threefrys(dev))


def check_nested_threefrys(dev) -> float:
    """The two-level entry (the "seq" mode's per-image draws: row (c, b) from
    split(split(key, C)[c], B)[b]) against its plain version on the card,
    bit for bit: the prototype's layers at B = 1, 16 and 1000, one column,
    odd widths, and more rows than the grid's y."""
    err = 0.0
    key = t_random.PRNGKey(21)
    for name, (C, B, p, q) in (
            ("layer 1 B=16", (625, 16, 32, 12)),
            ("layer 2 B=16", (625, 16, 12, 10)),
            ("layer 1 B=1", (625, 1, 32, 12)),
            ("layer 2 B=1000, 8 sites", (8, 1000, 12, 10)),
            ("one column B=16", (1, 16, 32, 12)),
            ("odd widths 11x9 B=7", (48, 7, 11, 9)),
            ("odd widths 3x3 B=1000, one column", (1, 1000, 3, 3)),
            ("70,000 rows of 2 (more rows than the grid's y)", (70, 1000, 1, 1))):
        uk = threefry.nested_uniforms(key, C, B, (2, p, q), device=dev)
        up = threefry.nested_uniforms_plain(key, C, B, (2, p, q), device=dev)
        torch.cuda.synchronize()
        same = torch.equal(uk.view(torch.int32), up.view(torch.int32))
        e = float((uk - up).abs().max())
        print(f"  threefry nested {name}: ({C}, {B}, 2, {p}, {q}), bits equal "
              f"{same}, max_abs_err={e}", flush=True)
        if not same or e:
            raise AssertionError(f"threefry nested {name}: kernel disagrees with "
                                 f"the plain version (max_abs_err={e})")
        err = max(err, e)
    return err


def measure_threefry(dev):
    """Kernel and plain ms at the training path's shapes: both layers of one
    learning wave at B = 16, 625 sites. A wave launches each layer once, so
    the row's ms, plain ms and bound are the mean over the two launches and
    twice the ms is one wave's worth. Bytes: the floats written (the key is
    two kernel arguments); operations: RL.THREEFRY_INT_OPS per float at the
    INT32 rate."""
    key = t_random.PRNGKey(11)
    per = []
    for l, (p, q) in enumerate(((32, 12), (12, 10)), start=1):
        shape = (2, WAVE_BATCH, p, q)
        k = lambda: threefry.layer_uniforms(key, 625, shape, device=dev)  # noqa: E731
        pl = lambda: threefry.layer_uniforms_plain(key, 625, shape, device=dev)  # noqa: E731
        ms, plain_ms, readings = in_turns(k, pl, 200)
        n = 625 * 2 * WAVE_BATCH * p * q
        per.append(_timing(f"threefry layer {l}", WAVE_BATCH, ms, plain_ms, readings,
                           RL.threefry_work(n)))
    return _mean_timing(per)


def measure_draw_host_time(dev, reps: int = 5):
    """Host time (perf_counter, ending in a synchronize) of one learning
    wave's draw at B = 16: the parent's (``torch.rand`` of both layers'
    (625, 2, 16, p, q) on the host, copied to the card) against the
    threefry kernel's two launches. Best of ``reps`` each, in turns."""
    g = _gen(700)
    key = t_random.PRNGKey(12)
    shapes = [(2, WAVE_BATCH, p, q) for p, q in ((32, 12), (12, 10))]

    def parent():
        return [torch.rand((625, *sh), generator=g).to(dev) for sh in shapes]

    def kernel():
        return [threefry.layer_uniforms(k, 625, sh, device=dev)
                for k, sh in zip(t_random.split(key, 2), shapes)]

    out = {"parent_host_draw_ms": [], "kernel_draw_ms": []}
    for _ in range(reps):
        for name, fn in (("parent_host_draw_ms", parent), ("kernel_draw_ms", kernel)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out[name].append(1e3 * (time.perf_counter() - t0))
    print(f"  one learning wave's uniforms (B=16, both layers, 40,320,000 "
          f"bytes): parent's host draw + copy {min(out['parent_host_draw_ms']):.3f} "
          f"ms, threefry kernel {min(out['kernel_draw_ms']):.3f} ms (host clock "
          f"to a synchronize, best of {reps})", flush=True)
    return out


# ---------------------------------------------------------------------------
# Training path (port slice 5)
# ---------------------------------------------------------------------------


def train_args(impl: str, ckpt_dir: str, device: str, k: int = 1):
    return ["--arch", "tnn-mnist", "--sites", "625", "--impl", impl,
            "--ckpt-every", "16", "--superbatch-k", str(k), "--ckpt-dir", ckpt_dir,
            "--device", device]


def train_path(name: str, args):
    """One train-launcher run on the card with every count set to 0 just
    before it and read just after."""
    reset_counts()
    t0 = time.perf_counter()
    out = launch_train.main(args)
    torch.cuda.synchronize()
    counts = read_counts()
    wall = time.perf_counter() - t0
    print(f"  {name}: wall {wall:.2f} s, waves/s {out['waves_per_s']:.1f} "
          f"(median wave, each ending in a sync), accuracy {out['accuracy']}; "
          f"launches {counts}", flush=True)
    return out, counts, wall


def expected_train_launches(impl: str, waves: int, evals: int) -> dict:
    """Launches of a 2-layer train run of ``waves`` learning waves and
    ``evals`` eval passes (each a forward over the 512 training images for
    the vote table and the 256 held-out images, in 16-image chunks)."""
    forwards = evals * (TRAIN_IMAGES + EVAL_IMAGES) // WAVE_BATCH
    want = {"tnn_wave[forward]": 0, "tnn_wave[learn]": 0, "tnn_column": 0,
            "stdp_update": 0, "wta": 0, "threefry": 2 * waves}
    if impl == "fused":
        want.update({"tnn_wave[forward]": forwards, "tnn_wave[learn]": waves})
    else:
        want.update({"tnn_column": 2 * (waves + forwards), "stdp_update": 2 * waves})
    return want


def same_training(a, b, what: str) -> None:
    """Two trainers' final weights, key, wave, vote table and accuracy."""
    sa, sb = convert.state_to_numpy(a.state), convert.state_to_numpy(b.state)
    for k in sa["params"]:
        if not (sa["params"][k] == sb["params"][k]).all():
            raise AssertionError(f"{what}: {k} differs")
    if not ((sa["rng"] == sb["rng"]).all() and sa["wave"] == sb["wave"]):
        raise AssertionError(f"{what}: key or wave differs")
    if not torch.equal(a.vote_table.cpu(), b.vote_table.cpu()):
        raise AssertionError(f"{what}: vote tables differ")
    if a.accuracy != b.accuracy:
        raise AssertionError(f"{what}: accuracy {a.accuracy} != {b.accuracy}")


def profile_train(impl: str, k: int, dev, waves: int = 32, traced: int = 16):
    """A span of learning waves on the card through the train steps the
    trainer calls (``make_train_step``, or ``make_superbatch_step`` by K):
    ``waves`` untraced, ending in one synchronize (waves/s with the waves
    queued back to back), then ``traced`` under torch.profiler (device busy
    time by kernel and the device's idle share of the wall time)."""
    cfg = launcher_network_config(625, impl=impl)
    state = init_train_state(t_random.PRNGKey(0), cfg, dev)
    stream = WaveStream(cfg, TRAIN_IMAGES, WAVE_BATCH, seed=1, device=dev)
    step = make_superbatch_step(cfg) if k > 1 else make_train_step(cfg)

    def span(w0: int, n: int):
        nonlocal state
        for w in range(w0, w0 + n, k):
            x = stream.superbatch_at(w, k) if k > 1 else stream.batch_at(w)
            state, _ = step(state, x)
        torch.cuda.synchronize()

    span(0, 4 * k)  # warm-up
    t0 = time.perf_counter()
    span(4 * k, waves)
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        span(4 * k + waves, traced)
        traced_wall = time.perf_counter() - t1
    events = prof.key_averages()
    card = on_card(events)
    busy_us = sum(e.self_device_time_total for e in card)
    if busy_us <= 0:
        raise AssertionError(f"train {impl}: the traced span shows no device time")
    idle = 1 - busy_us / (1e6 * traced_wall)
    print(f"  train {impl} K={k}: {waves / wall:.1f} waves/s untraced ({waves} "
          f"waves in {1e3 * wall:.3f} ms); traced {traced} waves: wall "
          f"{1e3 * traced_wall:.3f} ms, device busy {busy_us / 1e3:.3f} ms, idle "
          f"share {idle:.3f}", flush=True)
    top = sorted(card, key=lambda e: -e.self_device_time_total)[:6]
    for e in top:
        print(f"    device {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:70]}")
    for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:6]:
        print(f"    host   {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:70]}")
    return {"waves_per_s": waves / wall, "traced_wall_ms": 1e3 * traced_wall,
            "device_busy_ms": busy_us / 1e3, "device_idle_share": idle,
            "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top[:4]}}


def train_phase(dev):
    """A (pallas), B (fused, K = 4), C (resume from A's wave 16) on the card
    and the CPU epoch; all must end in one state. Returns the numbers."""
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    dirs = {n: os.path.join(TRAIN_DIR, n) for n in ("a", "b", "c", "cpu")}
    out_a, counts_a, wall_a = train_path(
        "A --impl pallas", train_args("pallas", dirs["a"], "cuda"))
    out_b, counts_b, wall_b = train_path(
        "B --impl fused --superbatch-k 4", train_args("fused", dirs["b"], "cuda", k=4))
    os.makedirs(dirs["c"])
    shutil.copytree(os.path.join(dirs["a"], "step_00000016"),
                    os.path.join(dirs["c"], "step_00000016"))
    out_c, counts_c, wall_c = train_path(
        "C resume from A's step_00000016", train_args("pallas", dirs["c"], "cuda"))
    for name, counts, want in (
            ("A", counts_a, expected_train_launches("pallas", EPOCH_WAVES, 1)),
            ("B", counts_b, expected_train_launches("fused", EPOCH_WAVES, 1)),
            ("C", counts_c, expected_train_launches("pallas", EPOCH_WAVES // 2, 1))):
        if counts != want:
            raise AssertionError(f"train {name} launches {counts}, expected {want}")
    if not out_c["resumed"] or out_a["resumed"] or out_b["resumed"]:
        raise AssertionError("only C should resume")
    t0 = time.perf_counter()
    out_cpu = launch_train.main(train_args("fused", dirs["cpu"], "cpu", k=4))
    wall_cpu = time.perf_counter() - t0
    print(f"  cpu (plain path, --impl fused --superbatch-k 4): wall {wall_cpu:.2f} s",
          flush=True)
    ta = out_a["trainer"]
    same_training(ta, out_b["trainer"], "A (pallas) vs B (fused, K=4)")
    same_training(ta, out_c["trainer"], "A vs C (resumed)")
    same_training(ta, out_cpu["trainer"], "A (card) vs the CPU")
    vt = ta.vote_table
    if not (torch.isfinite(vt).all() and tuple(vt.shape) == (625, 10, 10)
            and float(vt.sum()) >= 0 and ta.wave == EPOCH_WAVES):
        raise AssertionError("the trained state is malformed")
    init = init_train_state(t_random.PRNGKey(0), ta.cfg, "cpu")["params"]
    moved = {k: int((w.cpu() != init[k]).sum()) for k, w in ta.state["params"].items()}
    if not moved["layer_00"]:
        raise AssertionError("an epoch of STDP left layer 1's weights as initialised")
    print(f"  A == B == C == cpu at wave {ta.wave}: weights (moved from their "
          f"initial values: {moved}), key, vote table (sum {float(vt.sum())}: "
          f"layer 2 stays silent at 625 sites, as in the reference) and "
          f"accuracy {ta.accuracy}", flush=True)
    spans = {"pallas": profile_train("pallas", 1, dev),
             "fused": profile_train("fused", 4, dev)}

    def numbers(out, counts, wall):
        return {"wall_s": wall, "waves_per_s": out["waves_per_s"],
                "accuracy": out["accuracy"], "launches": counts}

    return {"a_pallas": numbers(out_a, counts_a, wall_a),
            "b_fused_k4": numbers(out_b, counts_b, wall_b),
            "c_resumed": numbers(out_c, counts_c, wall_c),
            "cpu_wall_s": wall_cpu, "final_wave": ta.wave, "weights_moved": moved,
            "vote_table_sum": float(vt.sum()), "spans": spans}, counts_a, (dirs["a"], ta)


# ---------------------------------------------------------------------------
# The rest of serving (port slice 6): a firing readout, learning while
# serving, a checkpoint served online, loadgen and the flagship run
# ---------------------------------------------------------------------------

FIRING = (12, 3)  # network_config(625, 12, 3): layer 2 fires at full width
# 512 requests: 8 learning waves, 2 drains of K = 4, 2 swaps (1,024 until
# slice 13: the CPU's plain learning waves took a minute of the run's 1,200 s)
ONLINE_REQUESTS, SWAP_EVERY, ONLINE_K = 512, 4, 4
ONLINE_WAVES = ONLINE_REQUESTS // SLOTS
ONLINE_CKPT_DIR = os.path.join(ROOT, "build", "chip_smoke_online")  # .gitignore lists build/
NO_LAUNCHES = {"tnn_wave[forward]": 0, "tnn_wave[learn]": 0, "tnn_column": 0,
               "stdp_update": 0, "wta": 0, "threefry": 0}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def firing_path(impl: str, dev):
    """The launcher's sequence at theta = (12, 3) through the port engine on
    ``dev``, counts from 0 just before it: weights from PRNGKey(0) and 4
    warm-up waves, ``fit`` on digits(256, seed=1), 512 requests of
    digits(512, seed=2) at 64 slots. Then (not counted) the requests' vote
    sums."""
    cfg = network_config(625, *FIRING, impl=impl)
    lab_imgs, lab_labs = digits(FIT_IMAGES, seed=1)
    imgs = digits(REQUESTS, seed=2)[0]
    reset_counts()
    t0 = time.perf_counter()
    params, spikes = launch_serve.warm_up(cfg, lab_imgs, TRAIN_WAVES, dev)
    eng = TNNEngine(cfg, params, n_slots=SLOTS, impl=impl, device=dev)
    eng.fit(lab_imgs, lab_labs)
    for uid in range(REQUESTS):
        eng.submit(ClassifyRequest(uid=uid, image=imgs[uid]))
    done = eng.run_until_done()
    _sync(dev)
    counts, wall = read_counts(), time.perf_counter() - t0
    x = torch.cat([eng._encode(imgs[o:o + SLOTS]) for o in range(0, REQUESTS, SLOTS)])
    z = forward_all_padded(eng._forward, eng.params, x, SLOTS, T)
    sums = vote_sums(z, eng.vote_table, T).cpu()
    print(f"  {dev.type} {impl}: wall {wall:.2f} s, warm-up spikes/layer {spikes[-1]}, "
          f"vote table sum {float(eng.vote_table.sum())}, launches {counts}", flush=True)
    return {"params": [w.cpu() for w in eng.params], "vote_table": eng.vote_table.cpu(),
            "ids": [done[u].result for u in range(REQUESTS)], "sums": sums,
            "counts": counts, "wall_s": wall, "spikes": spikes}


def firing_phase(dev):
    """pallas (card) == fused (card) == CPU at theta = (12, 3): warmed
    weights, a non-zero vote table bit for bit, and every class id; a row
    whose ids differ is allowed only where its top-two vote margin is below
    the largest |card - CPU| sum difference (a near tie), and is printed."""
    runs = {"pallas": firing_path("pallas", dev), "fused": firing_path("fused", dev),
            "cpu": firing_path("fused", torch.device("cpu"))}
    cpu = runs["cpu"]
    if not float(cpu["vote_table"].sum()) > 0:
        raise AssertionError("theta=(12, 3): the vote table is all zero")
    fwd = FIT_IMAGES // SLOTS + REQUESTS // SLOTS  # fit chunks, served waves
    want = {"pallas": {**NO_LAUNCHES, "tnn_column": 2 * (TRAIN_WAVES + fwd),
                       "stdp_update": 2 * TRAIN_WAVES, "threefry": 2 * TRAIN_WAVES},
            "fused": {**NO_LAUNCHES, "tnn_wave[forward]": fwd,
                      "tnn_wave[learn]": TRAIN_WAVES, "threefry": 2 * TRAIN_WAVES}}
    top2 = cpu["sums"].topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    diff = max(float((runs[k]["sums"] - cpu["sums"]).abs().max()) for k in ("pallas", "fused"))
    near_rows = []
    for name in ("pallas", "fused"):
        r = runs[name]
        if r["counts"] != want[name]:
            raise AssertionError(f"firing {name} launches {r['counts']}, expected {want[name]}")
        for l, (a, b) in enumerate(zip(r["params"], cpu["params"])):
            if not torch.equal(a, b):
                raise AssertionError(f"firing {name}: warmed layer-{l} weights differ")
        if not torch.equal(r["vote_table"], cpu["vote_table"]):
            raise AssertionError(f"firing {name}: the vote table differs from the CPU's")
        for u, (a, b) in enumerate(zip(r["ids"], cpu["ids"])):
            if a != b:
                if float(margin[u]) >= diff:
                    raise AssertionError(f"firing {name}: request {u} class {a} != CPU {b} "
                                         f"with margin {float(margin[u])} >= {diff}")
                near_rows.append((name, u, a, b, cpu["sums"][u].tolist()))
    nz = margin[margin > 0]
    labels = digits(REQUESTS, seed=2)[1]
    acc = float((torch.tensor(cpu["ids"]) == torch.from_numpy(labels)).float().mean())
    print(f"  pallas (card) == fused (card) == cpu at theta=(12, 3): weights, vote table "
          f"(sum {float(cpu['vote_table'].sum())}) and {REQUESTS - len(near_rows)} of "
          f"{REQUESTS} class ids; accuracy {acc}; vote sums: smallest top-two margin "
          f"{float(margin.min())} (smallest non-zero {float(nz.min()) if nz.numel() else None}; "
          f"{int((margin < diff).sum())} rows below the difference, "
          f"{int((top2[:, 0] == 0).sum())} with every sum 0), largest |card - cpu| "
          f"{diff}; near-tie rows whose id differs: {near_rows}", flush=True)
    return {"accuracy": acc, "vote_table_sum": float(cpu["vote_table"].sum()),
            "min_margin": float(margin.min()),
            "min_nonzero_margin": float(nz.min()) if nz.numel() else None,
            "max_sum_diff": diff, "rows_below_diff": int((margin < diff).sum()),
            "near_tie_rows_differing": near_rows,
            "launches": {k: runs[k]["counts"] for k in ("pallas", "fused")},
            "wall_s": {k: r["wall_s"] for k, r in runs.items()},
            "warmup_spikes": cpu["spikes"]}, cpu["params"]


def online_engine(impl: str, dev, params0, k: int):
    cfg = network_config(625, *FIRING, impl=impl)
    eng = TNNEngine(cfg, [w.to(dev) for w in params0], n_slots=SLOTS, impl=impl,
                    device=dev, superbatch_k=k, online_stdp=True,
                    swap_every=SWAP_EVERY, seed=0)
    eng.fit(*digits(FIT_IMAGES, seed=1))
    return eng


def online_path(impl: str, dev, params0, k: int = ONLINE_K, pipelined: bool = True):
    """ONLINE_REQUESTS requests through an online engine (64 slots, swaps every 4
    learning waves), counts from 0 just before the first submit and read
    after the last retire; every published vote table is kept."""
    eng = online_engine(impl, dev, params0, k)
    imgs = digits(ONLINE_REQUESTS, seed=2)[0]
    _sync(dev)
    reset_counts()
    for uid in range(ONLINE_REQUESTS):
        eng.submit(ClassifyRequest(uid=uid, image=imgs[uid]))
    tables = {eng.version: eng.vote_table}
    while eng.pending:
        eng.poll() if pipelined else eng.step()
        tables[eng.version] = eng.vote_table
    _sync(dev)
    counts = read_counts()
    st = eng.stats()
    return {"eng": eng, "counts": counts, "stats": st,
            "map": {u: (r.result, r.version) for u, r in eng.done.items()},
            "tables": {v: t.cpu() for v, t in tables.items()},
            "state": convert.state_to_numpy(eng.learn_state)}


def expected_online_launches(impl: str, waves: int, swaps: int) -> dict:
    """Per online wave: fused 1 learn + 1 forward, pallas 4 column (2 layers
    learning, 2 serving) + 2 STDP; 2 threefry either way. Per swap the
    re-labelling forwards over the 256 fit images in 64-row chunks."""
    relabel = FIT_IMAGES // SLOTS
    want = dict(NO_LAUNCHES, threefry=2 * waves)
    if impl == "fused":
        want.update({"tnn_wave[learn]": waves, "tnn_wave[forward]": waves + swaps * relabel})
    else:
        want.update({"tnn_column": 4 * waves + 2 * swaps * relabel, "stdp_update": 2 * waves})
    return want


def _same_np_state(a, b, what: str) -> None:
    for key in a["params"]:
        if not (a["params"][key] == b["params"][key]).all():
            raise AssertionError(f"{what}: {key} differs")
    if not ((a["rng"] == b["rng"]).all() and int(a["wave"]) == int(b["wave"])):
        raise AssertionError(f"{what}: key or wave differs")


def traced_online(impl: str, dev, params0):
    """One more online pass on the card under torch.profiler: device busy
    time by kernel and the device's idle share of the wall time."""
    eng = online_engine(impl, dev, params0, ONLINE_K)
    imgs = digits(ONLINE_REQUESTS, seed=2)[0]
    _sync(dev)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for uid in range(ONLINE_REQUESTS):
            eng.submit(ClassifyRequest(uid=uid, image=imgs[uid]))
        eng.run_until_done()
        _sync(dev)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    card = on_card(events)
    busy_us = sum(e.self_device_time_total for e in card)
    if busy_us <= 0:
        raise AssertionError(f"online {impl}: the traced pass shows no device time")
    idle = 1 - busy_us / (1e6 * wall)
    print(f"  online {impl} traced pass: wall {1e3 * wall:.3f} ms for {eng.stats().waves} "
          f"waves and {eng.swaps} swaps; device busy {busy_us / 1e3:.3f} ms, idle share "
          f"{idle:.3f}", flush=True)
    top = sorted(card, key=lambda e: -e.self_device_time_total)[:6]
    for e in top:
        print(f"    device {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:70]}")
    for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:6]:
        print(f"    host   {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:70]}")
    return {"traced_wall_ms": 1e3 * wall, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": idle,
            "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top[:4]}}


def online_phase(dev, params0):
    """pallas (card) == fused (card) == CPU, K = 4 pipelined, and the fused
    engine lock-step at K = 1: every uid's class id and version, the final
    shadow state and each published vote table; the card's shadow equals 16
    ``make_train_step`` calls on the same volleys; launches as the code
    says."""
    runs = {"pallas": online_path("pallas", dev, params0),
            "fused": online_path("fused", dev, params0)}
    t0 = time.perf_counter()
    runs["cpu"] = online_path("fused", torch.device("cpu"), params0)
    cpu_wall = time.perf_counter() - t0
    runs["lockstep"] = online_path("fused", dev, params0, k=1, pipelined=False)
    ref = runs["cpu"]
    # a swap every SWAP_EVERY waves; lock-step publishes the last one after
    # its final wave, outside the run
    pipelined = ONLINE_WAVES // SWAP_EVERY
    swaps = {"pallas": pipelined, "fused": pipelined, "cpu": pipelined,
             "lockstep": pipelined - 1}
    for name, r in runs.items():
        eng = r["eng"]
        if eng.swaps != swaps[name] or eng.stats().waves != ONLINE_WAVES:
            raise AssertionError(f"online {name}: {eng.swaps} swaps, {eng.stats().waves} waves")
        if name != "cpu":
            want = expected_online_launches("pallas" if name == "pallas" else "fused",
                                            ONLINE_WAVES, swaps[name])
            if r["counts"] != want:
                raise AssertionError(f"online {name} launches {r['counts']}, expected {want}")
        if r["map"] != ref["map"]:
            diff = [u for u in ref["map"] if r["map"][u] != ref["map"][u]]
            raise AssertionError(f"online {name}: {len(diff)} uids differ in class id or "
                                 f"version from the CPU's (first {diff[:5]})")
        _same_np_state(r["state"], ref["state"], f"online {name} vs cpu")
        for ver, vt in r["tables"].items():
            if ver in ref["tables"] and not torch.equal(vt, ref["tables"][ver]):
                raise AssertionError(f"online {name}: published v{ver} vote table differs")
    if not all(float(vt.sum()) > 0 for vt in ref["tables"].values()):
        raise AssertionError("online: a published vote table is all zero")
    # the shadow against the trainer's step on the same volleys
    cfg = network_config(625, *FIRING, impl="fused")
    state = {"params": params_to_tree([w.to(dev).clone() for w in params0]),
             **train_stream_start(t_random.PRNGKey(0))}
    step = make_train_step(cfg)
    eng = runs["fused"]["eng"]
    imgs = digits(ONLINE_REQUESTS, seed=2)[0]
    for w in range(ONLINE_WAVES):
        state, _ = step(state, eng._encode(imgs[w * SLOTS:(w + 1) * SLOTS]))
    _same_np_state(convert.state_to_numpy(state), ref["state"],
                   f"online shadow vs {ONLINE_WAVES} train steps")
    labels = digits(ONLINE_REQUESTS, seed=2)[1]
    out = {}
    for name, r in runs.items():
        st, eng = r["stats"], r["eng"]
        by_ver = {}
        for ver, sv in eng.stats_by_version().items():
            hits = [r["map"][u][0] == labels[u] for u in r["map"] if r["map"][u][1] == ver]
            by_ver[ver] = {"requests": sv.requests, "waves": sv.waves,
                           "p50_ms": sv.p50_ms, "p95_ms": sv.p95_ms,
                           "accuracy": float(sum(hits) / len(hits))}
        out[name] = {"waves_per_s": st.waves_per_s, "images_per_s": st.images_per_s,
                     "p50_ms": st.p50_ms, "p95_ms": st.p95_ms, "wall_s": st.wall_s,
                     "swaps": eng.swaps, "versions": sorted(by_ver),
                     "launches": r["counts"], "by_version": by_ver}
        print(f"  online {name}: {st.waves} waves, {eng.swaps} swaps, "
              f"{st.waves_per_s:.1f} waves/s, {st.images_per_s:.1f} images/s, p50 "
              f"{st.p50_ms:.3f} ms, p95 {st.p95_ms:.3f} ms; launches {r['counts']}", flush=True)
        for ver, v in by_ver.items():
            print(f"    v{ver}: {v['requests']} requests / {v['waves']} waves, p50 "
                  f"{v['p50_ms']:.3f} ms, p95 {v['p95_ms']:.3f} ms, accuracy {v['accuracy']}")
    out["cpu"]["phase_wall_s"] = cpu_wall
    print(f"  pallas (card) == fused (card) == cpu == fused lock-step K=1: every uid's class "
          f"id and version, shadow (wave {int(ref['state']['wave'])}) == {ONLINE_WAVES} train steps, "
          f"published vote tables v0..v{max(ref['tables'])} (sums "
          f"{[float(t.sum()) for t in ref['tables'].values()]})", flush=True)
    for impl in ("pallas", "fused"):
        out[impl]["traced"] = traced_online(impl, dev, params0)
    fused = runs["fused"]
    return out, {"map": fused["map"], "state": fused["state"],
                 "tables": {v: t.numpy() for v, t in fused["tables"].items()}}


def online_ckpt_phase(dev, ckpt_a: str, final_a):
    """Train phase A's wave-16 checkpoint served online (16 slots, fused):
    the trainer's stream for waves 16-31 leaves the shadow at A's final
    state (wave 32)."""
    shutil.rmtree(ONLINE_CKPT_DIR, ignore_errors=True)
    os.makedirs(ONLINE_CKPT_DIR)
    shutil.copytree(os.path.join(ckpt_a, "step_00000016"),
                    os.path.join(ONLINE_CKPT_DIR, "step_00000016"))
    cfg = launcher_network_config(625, impl="fused")
    stream = WaveStream(cfg, TRAIN_IMAGES, WAVE_BATCH, seed=1, device=dev)
    label = (stream.images[:EVAL_IMAGES], stream.labels[:EVAL_IMAGES])
    reset_counts()
    t0 = time.perf_counter()
    eng = TNNEngine.from_checkpoint(ONLINE_CKPT_DIR, cfg, n_slots=WAVE_BATCH, impl="fused",
                                    label_data=label, online_stdp=True, device=dev)
    start = int(eng.learn_state["wave"])
    for uid, row in enumerate(range(start * WAVE_BATCH, EPOCH_WAVES * WAVE_BATCH)):
        eng.submit(ClassifyRequest(uid=uid, image=stream.images[row]))
    eng.run_until_done()
    _sync(dev)
    counts, wall = read_counts(), time.perf_counter() - t0
    waves = EPOCH_WAVES - start
    want = dict(NO_LAUNCHES, threefry=2 * waves, **{
        "tnn_wave[learn]": waves, "tnn_wave[forward]": waves + EVAL_IMAGES // WAVE_BATCH})
    if start != 16 or counts != want:
        raise AssertionError(f"online from a checkpoint: start {start}, launches {counts}, "
                             f"expected {want}")
    _same_np_state(convert.state_to_numpy(eng.learn_state), convert.state_to_numpy(final_a),
                   "online from A's wave 16 vs A at wave 32")
    print(f"  from A's step_00000016: {waves} online waves end at A's wave-32 state "
          f"(weights, key, wave); wall {wall:.2f} s; launches {counts}", flush=True)
    return {"start_wave": start, "final_wave": int(eng.learn_state["wave"]),
            "wall_s": wall, "launches": counts}


def loadgen_phase(dev):
    """The port's loadgen, online (swaps every 4 learning waves) at
    theta = (12, 3): closed loop over ONLINE_REQUESTS requests, then an open loop of
    2 s at half the images/s the closed loop measured, counts from 0 before
    each. Gate: every request served, versions never decrease along the
    retire order, launches as the engine's waves and swaps say."""
    eng = t_loadgen.build_engine(sites=625, slots=SLOTS, impl="fused", online_stdp=True,
                                 swap_every=SWAP_EVERY, thetas=FIRING, device=dev)
    imgs, labs = t_loadgen.labelled_images(625, ONLINE_REQUESTS)
    t_loadgen.run_closed_loop(eng, imgs, SLOTS)  # warm-up
    eng.reset()

    def check(n: int, what: str, swaps0: int):
        _sync(dev)
        counts, waves = read_counts(), eng.stats().waves
        want = expected_online_launches("fused", waves, eng.swaps - swaps0)
        if counts != want:
            raise AssertionError(f"loadgen {what}: launches {counts}, expected {want}")
        order = sorted(eng.done.values(), key=lambda r: (r.t_done, r.uid))
        if len(eng.done) != n or any(r.result is None for r in order):
            raise AssertionError(f"loadgen {what}: served {len(eng.done)} of {n}")
        if any(a.version > b.version for a, b in zip(order, order[1:])):
            raise AssertionError(f"loadgen {what}: a version decreased along the retire order")
        ab = t_loadgen.ab_accuracy(eng.done, labs, window=256)
        print(f"  loadgen {what}: {t_loadgen.fmt(eng.stats())}; {eng.swaps - swaps0} "
              f"swaps, now v{eng.version}; ab (last 256) {ab}; launches {counts}", flush=True)
        return {"ab": ab, "swaps": eng.swaps - swaps0, "launches": counts}

    swaps0 = eng.swaps
    reset_counts()
    closed = t_loadgen.run_closed_loop(eng, imgs, ONLINE_REQUESTS)
    closed_check = check(ONLINE_REQUESTS, "closed", swaps0)
    eng.reset()
    rate = closed.images_per_s / 2
    arrivals = t_loadgen.poisson_arrivals(rate, 2.0, seed=0)
    swaps0 = eng.swaps
    reset_counts()
    opened = t_loadgen.run_open_loop(eng, imgs, arrivals)
    open_check = check(len(arrivals), f"open @ {rate:.1f}/s x 2 s ({len(arrivals)} "
                       f"arrivals)", swaps0)

    def nums(st):
        return {"requests": st.requests, "waves": st.waves, "wall_s": st.wall_s,
                "waves_per_s": st.waves_per_s, "images_per_s": st.images_per_s,
                "p50_ms": st.p50_ms, "p95_ms": st.p95_ms, "occupancy": st.occupancy}

    return {"closed": {**nums(closed), **closed_check},
            "open": {**nums(opened), "rate": rate, **open_check}}


def flagship_phase(dev):
    """``repro_torch.launch.tnn_mnist`` with its defaults (theta = (12, 3),
    60 waves of 16) and ``--impl fused`` on the card, counts from 0, then on
    the CPU: equal weights, vote tables, centroids and both accuracies."""
    reset_counts()
    card = t_flagship.main(["--impl", "fused", "--device", "cuda"])
    _sync(dev)
    counts = read_counts()
    t0 = time.perf_counter()
    cpu = t_flagship.main(["--impl", "fused", "--device", "cpu"])
    cpu_wall = time.perf_counter() - t0
    want = dict(NO_LAUNCHES, threefry=120, **{"tnn_wave[learn]": 60, "tnn_wave[forward]": 2})
    if counts != want:
        raise AssertionError(f"flagship launches {counts}, expected {want}")
    for l, (a, b) in enumerate(zip(card["params"], cpu["params"])):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"flagship: layer-{l} weights differ from the CPU's")
    for key in ("vote_table", "centroids"):
        if not torch.equal(card[key].cpu(), cpu[key]):
            raise AssertionError(f"flagship: {key} differs from the CPU's")
    for key in ("accuracy", "centroid_accuracy"):
        if card[key] != cpu[key]:
            raise AssertionError(f"flagship: {key} {card[key]} != CPU {cpu[key]}")
    if not float(card["vote_table"].sum()) > 0:
        raise AssertionError("flagship: the vote table is all zero")
    print(f"  card == cpu: weights, vote table, centroids; vote accuracy "
          f"{card['accuracy']}, centroid accuracy {card['centroid_accuracy']}; "
          f"{card['ms_per_wave']:.3f} ms a wave on the card, "
          f"{cpu['ms_per_wave']:.3f} on the CPU (cpu run {cpu_wall:.2f} s); launches "
          f"{counts}", flush=True)
    return {"accuracy": card["accuracy"], "centroid_accuracy": card["centroid_accuracy"],
            "rails": card["rails"], "ms_per_wave": card["ms_per_wave"],
            "cpu_ms_per_wave": cpu["ms_per_wave"], "launches": counts, "ppa": card["ppa"]}


# ---------------------------------------------------------------------------
# The "seq" and "gauss" STDP modes and the reference's production cells
# (port slice 7)
# ---------------------------------------------------------------------------

MODES_THETAS = ((24, 8), (12, 3))   # the served theta; one where layer 2 fires
MODES_BATCH = 16
MODE_LAUNCHES = {"tnn_wave[forward]": 0, "tnn_wave[learn]": 0, "tnn_column": 2,
                 "stdp_update": 0, "wta": 0, "threefry": 2}


def with_mode(cfg: NetworkConfig, mode: str, impl: str) -> NetworkConfig:
    layers = tuple(dataclasses.replace(l, column=dataclasses.replace(
        l.column, impl=impl,
        stdp=dataclasses.replace(l.column.stdp, batch_reduce=mode)))
        for l in cfg.layers)
    return dataclasses.replace(cfg, layers=layers)


def check_normals(dev) -> int:
    """The card's normals (the threefry kernel's unit floats through
    repro_torch.random's erf_inv on the card) against the CPU's plain
    normals of the same keys, bit for bit: a gauss layer-1 draw and one of
    1,000,000 (the tails)."""
    n_diff = 0
    for name, key, (C, p, q) in (("layer 1", t_random.PRNGKey(31), (625, 32, 12)),
                                 ("1000 x 1000", t_random.PRNGKey(32), (1000, 40, 25))):
        g_card = t_random.unit_to_normal(threefry.layer_uniforms(key, C, (p, q), device=dev))
        g_cpu = t_random.normal(t_random.split(key, C), (p, q))
        d = int((g_card.cpu().view(torch.int32) != g_cpu.view(torch.int32)).sum())
        print(f"  normals {name}: {g_cpu.numel()} draws, min {float(g_cpu.min()):.4f} "
              f"max {float(g_cpu.max()):.4f}, card != cpu in {d}", flush=True)
        if d:
            raise AssertionError(f"normals {name}: {d} card draws differ from the CPU's")
        n_diff += d
    return n_diff


def modes_phase(dev):
    """A "seq" and a "gauss" learning wave at 625 sites, B = 16, theta (24, 8)
    and (12, 3): pallas and fused on the card (counts from 0 for each wave)
    and the plain path on the CPU give the same spike times and weights bit
    for bit; each card wave launches tnn_column and threefry twice (the
    "seq" draws through the two-level entry) and no tnn_wave or
    stdp_update."""
    imgs = digits(MODES_BATCH, seed=3)[0]
    out = {}
    for th in MODES_THETAS:
        base = network_config(625, *th)
        x = encode_images(torch.from_numpy(imgs), base)
        params = init_network(t_random.PRNGKey(0), base, "cpu")
        key = t_random.split(t_random.PRNGKey(7))[1]
        for mode in ("seq", "gauss"):
            t0 = time.perf_counter()
            zs_c, ws_c = network_train_wave(x, params, with_mode(base, mode, "fused"), key)
            cpu_s = time.perf_counter() - t0
            row = {"cpu_s": cpu_s,
                   "spikes": [int((z < T).sum()) for z in zs_c],
                   "weights_moved": [int((a != b).sum()) for a, b in zip(ws_c, params)]}
            for impl in ("pallas", "fused"):
                cfg = with_mode(base, mode, impl)
                counts, (zs, ws) = kernel_launch_count(
                    network_train_wave, x.to(dev), [w.to(dev) for w in params], cfg, key)
                torch.cuda.synchronize()
                err = max(_max_err(a.cpu(), b) for a, b in
                          list(zip(zs, zs_c)) + list(zip(ws, ws_c)))
                nested = threefry.LAUNCHES.nested
                print(f"  theta={th} {mode} {impl}: spikes/layer {row['spikes']}, "
                      f"weights moved {row['weights_moved']}, card vs cpu "
                      f"max_abs_err={err}; launches {counts} (nested {nested}); "
                      f"cpu {cpu_s:.2f} s", flush=True)
                _require_exact(f"{mode} {impl} theta={th}", err)
                if counts != MODE_LAUNCHES or nested != (2 if mode == "seq" else 0):
                    raise AssertionError(f"{mode} {impl}: launches {counts} (nested "
                                         f"{nested}), expected {MODE_LAUNCHES}")
                row[impl] = {"launches": counts, "nested": nested, "max_abs_err": err}
            out[f"{mode} theta={th}"] = row
    out["normals_differing"] = check_normals(dev)
    out["nested_threefry"] = measure_nested_threefry(dev)
    return out


def measure_nested_threefry(dev):
    """The two-level threefry entry at the "seq" waves' shapes (625 sites,
    B = 16, both layers): device ms per call under torch.profiler beside
    its bound (the floats it writes, the INT32 operations of their
    hashes)."""
    key = t_random.PRNGKey(41)
    out = {}
    for l, (p, q) in enumerate(((32, 12), (12, 10)), start=1):
        ms = device_ms(lambda: threefry.nested_uniforms(key, 625, MODES_BATCH, (2, p, q),
                                                        device=dev), 100)
        bms, by, _ = RL.threefry_work(625 * MODES_BATCH * 2 * p * q).bound()
        print(f"  threefry nested layer {l} (625, {MODES_BATCH}, 2, {p}, {q}): "
              f"{ms:.4f} ms on the card, bound {bms:.5f} ms ({by})", flush=True)
        out[f"layer {l}"] = {"ms": ms, "bound_ms": bms, "bound_by": by}
    return out


CELL_CHUNK = 16   # columns per plain chunk: a few GB of planes at B = 8,192


def _plain_chunks(C: int):
    return [(c, min(C, c + CELL_CHUNK)) for c in range(0, C, CELL_CHUNK)]


def check_infer_cell(runs, dev) -> int:
    """Every run's spike times against the plain forward on the card, chunk
    by chunk (all columns and rows), bit for bit."""
    x, params = runs[0][1]["x"], runs[0][1]["params"]
    cfg = prototype_config(sites=x.shape[1], theta1=dryrun.THETA[0],
                           theta2=dryrun.THETA[1])
    B, rows = x.shape[0], 8192
    err = 0
    for c0, c1 in _plain_chunks(x.shape[1]):
        for r0 in range(0, B, rows):
            v = x[r0:r0 + rows, c0:c1]
            for l, (w, lcfg) in enumerate(zip(params, cfg.layers)):
                v = tnn_column.column_forward_layer_plain(
                    v, w[c0:c1], theta=lcfg.column.theta, T=T, wta=True).to(SPIKE_DTYPE)
                for _, out in runs:
                    err = max(err, _max_err(out["zs"][l][r0:r0 + rows, c0:c1], v))
    return _require_exact("tnn_infer_64k", err)


def check_train_cell(runs, gauss: bool, dev) -> int:
    """Every run's spike times and new weights against the plain wave on the
    card, chunk by chunk (all columns and rows): the plain column forward;
    "sum": the plain draw (held against the threefry kernel's own draw of
    the layer) and the plain counters; "gauss": the plain normals and the
    plain update."""
    ref = runs[0][1]
    x, params, key = ref["x"], ref["params"], ref["key"]
    C, B = x.shape[1], x.shape[0]
    cfg = dryrun._tnn_variant_cfg(prototype_config(
        sites=C, theta1=dryrun.THETA[0], theta2=dryrun.THETA[1]), "direct", gauss)
    err = 0
    v = x
    for l, (w, lcfg, k) in enumerate(zip(params, cfg.layers, t_random.split(key, 2))):
        spec, stdp = lcfg.column.wave, lcfg.column.stdp
        p, q = lcfg.column.p, lcfg.column.q
        col_keys = t_random.split(k, C)
        u_kernel = (None if gauss else
                    threefry.layer_uniforms(k, C, (2, B, p, q), device=dev))
        z_all = torch.empty((B, C, q), dtype=SPIKE_DTYPE, device=dev)
        for c0, c1 in _plain_chunks(C):
            vc, wc = v[:, c0:c1], w[c0:c1]
            z = tnn_column.column_forward_layer_plain(
                vc, wc, theta=lcfg.column.theta, T=T, wta=True).to(SPIKE_DTYPE)
            z_all[:, c0:c1] = z
            if gauss:
                g = t_random.normal(col_keys[c0:c1], (p, q), dev)
                w_new = gauss_update(wc, vc.transpose(0, 1), z.transpose(0, 1), g,
                                     spec, stdp)
            else:
                u = t_random.uniform(col_keys[c0:c1], (2, B, p, q), dev)
                err = max(err, int((u.view(torch.int32)
                                    != u_kernel[c0:c1].view(torch.int32)).sum()))
                net = stdp_net_from_uniforms(wc, vc.transpose(0, 1), z.transpose(0, 1),
                                             u[:, 0], u[:, 1], spec, stdp)
                w_new = apply_net(wc, net, spec)
            for _, out in runs:
                err = max(err, _max_err(out["zs"][l][:, c0:c1], z),
                          _max_err(out["new_params"][l][c0:c1], w_new))
        del u_kernel
        v = z_all
    return _require_exact(f"tnn_train_8k{'+gauss' if gauss else ''}", err)


def trace_cell_wave(tag: str, wave, repeats: int = 3, attempts: int = 3) -> dict:
    """``repeats`` more waves of a cell under torch.profiler: per wave, the
    wall time, the card's busy time by kernel (the card's own events) and
    the idle share. The profiler misses a trace's first kernels, so each
    trace waits 50 ms and opens with spin kernels, left out of the sums.
    A trace that still records no device event is taken again, up to
    ``attempts`` times; after that the waves are timed with CUDA events
    and the breakdown is recorded as not measured."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, attempts + 1):
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(0.05)
            for _ in range(3):
                torch.cuda._sleep(1_000_000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(repeats):
                wave()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / repeats
        card = [e for e in on_card(prof.key_averages()) if "spin" not in e.key]
        busy_us = sum(e.self_device_time_total for e in card) / repeats
        if busy_us > 0:
            break
        print(f"    trace {attempt} of {tag} recorded no device event", flush=True)
    else:
        ms = time_cuda(wave, repeats)
        print(f"    {tag}: {ms:.3f} ms a wave by CUDA events; the breakdown by "
              f"kernel is not measured (no trace recorded a device event)", flush=True)
        return {"wall_ms": ms, "device_busy_ms": None, "device_idle_share": None,
                "device_kernels": None, "top_device_ms": "not measured"}
    top = sorted(card, key=lambda e: -e.self_device_time_total)[:8]
    print(f"    traced ({repeats} waves): per wave wall {1e3 * wall:.3f} ms, device "
          f"busy {busy_us / 1e3:.3f} ms, idle share {1 - busy_us / (1e6 * wall):.3f}",
          flush=True)
    for e in top:
        print(f"    device {e.self_device_time_total / 1e3 / repeats:9.3f} ms a wave  "
              f"x{e.count // repeats:<4d} {e.key[:70]}", flush=True)
    return {"wall_ms": 1e3 * wall, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1 - busy_us / (1e6 * wall),
            "device_kernels": sum(e.count for e in card) / repeats,
            "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3 / repeats
                              for e in top}}


def cells_phase(dev):
    """The reference's production cells at 625 sites, nothing cut, through
    the dry run's ``run_tnn_cell`` (warm-up wave, then one timed wave with
    counts from 0): tnn_infer_64k under pallas and fused, tnn_train_8k under
    pallas, fused and fused+gauss; each run's outputs held against the plain
    version on the card, chunk by chunk, bit for bit. Prints each run's
    Roofline.report(), peak memory and wave ms."""
    want = {
        ("tnn_infer_64k", "pallas", False): {"tnn_column": 2},
        ("tnn_infer_64k", "fused", False): {"tnn_wave[forward]": 1},
        ("tnn_train_8k", "pallas", False): {"tnn_column": 2, "stdp_update": 2,
                                             "threefry": 2},
        ("tnn_train_8k", "fused", False): {"tnn_wave[learn]": 1, "threefry": 2},
        ("tnn_train_8k", "fused", True): {"tnn_column": 2, "threefry": 2},
    }
    results, runs = {}, {}
    for (cell, impl, gauss), launches in want.items():
        outputs = {}
        res = dryrun.run_tnn_cell(cell, impl=impl, gauss=gauss, device=dev,
                                  outputs=outputs)
        tag = f"{cell}{dryrun.variant_suffix(impl, gauss)}"
        if res["status"] != "ok":
            raise AssertionError(f"{tag}: {res.get('error', res['status'])}\n"
                                 f"{res.get('traceback', '')}")
        expected = dict(NO_LAUNCHES, **launches)
        if res["launches"] != expected:
            raise AssertionError(f"{tag}: launches {res['launches']}, expected {expected}")
        print(f"  {tag}: wave {res['wave_ms']:.3f} ms, kernels' bound "
              f"{res['kernel_bound_ms']:.3f} ms, peak {res['memory']['max_memory_allocated']:,.0f} "
              f"bytes, spikes/layer {res['spikes']}; roofline {json.dumps(res['roofline'])}",
              flush=True)
        results[tag] = {k: res[k] for k in ("wave_ms", "compile_s", "kernel_bound_ms",
                                              "kernels", "roofline", "memory",
                                              "launches", "spikes")}
        results[tag]["traced"] = trace_cell_wave(tag, outputs["wave"])
        runs.setdefault((cell, gauss), []).append((impl, outputs))
    t0 = time.perf_counter()
    errs = {"tnn_infer_64k": check_infer_cell(runs[("tnn_infer_64k", False)], dev),
            "tnn_train_8k": check_train_cell(runs[("tnn_train_8k", False)], False, dev),
            "tnn_train_8k_gauss": check_train_cell(runs[("tnn_train_8k", True)], True,
                                                   dev)}
    print(f"  every cell == its plain version on the card, all columns and rows "
          f"({time.perf_counter() - t0:.1f} s): {errs}", flush=True)
    return results


# ---------------------------------------------------------------------------
# The (data, model) mesh (port slice 8): 4 ranks sharing the card over gloo,
# one rank over NCCL, the windowed threefry draw
# ---------------------------------------------------------------------------

MESH_DIR = os.path.join(ROOT, "build", "chip_smoke_mesh")  # .gitignore lists build/
MESH_FACTORS = ((2, 2), (4, 1), (1, 4))
MESH_ARGS = ["--backend", "gloo"]   # 4 ranks on one card: gloo, chosen here


def check_window_one(name, key, n_cols, B, pq, window, dev, global_u=None) -> float:
    """The window entry against its plain version on the card and, given
    the layer's global kernel draw, against its padded slice; bit for bit."""
    col0, n_local, row0, b_local = window
    uk = threefry.window_uniforms(key, n_cols, B, pq, window, device=dev)
    up = threefry.window_uniforms_plain(key, n_cols, B, pq, window, device=dev)
    torch.cuda.synchronize()
    bad = int((uk.view(torch.int32) != up.view(torch.int32)).sum())
    err = float((uk - up).abs().max())
    vs_global = "-"
    if global_u is not None:
        g = global_u[col0:col0 + n_local, :, row0:row0 + b_local]
        pad = n_local - g.shape[0]
        g = torch.cat([g, torch.ones((pad, *g.shape[1:]), device=dev)]) if pad else g
        nb = int((uk.view(torch.int32) != g.view(torch.int32)).sum())
        bad += nb
        vs_global = f"{nb} floats differ from the global draw's slice"
    pads = max(0, col0 + n_local - max(n_cols, col0))
    print(f"  threefry window {name}: ({n_local}, 2, {b_local}, {pq[0]}, {pq[1]}) of "
          f"({n_cols}, 2, {B}, ...) from column {col0}, row {row0} ({pads} pad "
          f"columns); vs plain max_abs_err={err}; {vs_global}", flush=True)
    if bad or err:
        raise AssertionError(f"threefry window {name}: {bad} floats differ")
    return err


def check_window_threefrys(dev) -> float:
    """Every rank's window of both prototype layers at B = 16 under 2x2, 4x1
    and 1x4 (the last column pads), a pad-only window, odd widths, and the
    tnn_train_8k shapes (B = 8,192: a 640-site rank window, a 2x2 window,
    and a partly padded window of 625 sites against the plain draw)."""
    err = 0.0
    key = t_random.PRNGKey(31)
    for pq in ((32, 12), (12, 10)):
        g = threefry.layer_uniforms(key, 625, (2, WAVE_BATCH, *pq), device=dev)
        for d, m in MESH_FACTORS:
            for r in range(d * m):
                s = padding.MeshSpec(n_data=d, n_model=m, n_cols=625,
                                     data_index=r // m, model_index=r % m)
                w = s.uniform_window(625, WAVE_BATCH // d)
                err = max(err, check_window_one(f"{d}x{m} rank {r} {pq}", key, 625,
                                                WAVE_BATCH, pq, w, dev, g))
        del g
    for name, n_cols, B, pq, w in (
            ("pad only", 625, 16, (32, 12), (625, 3, 0, 16)),
            ("odd widths 11x9, one row", 48, 7, (11, 9), (40, 13, 3, 1)),
            ("B=8192, 625 sites, 2 real + 2 pad columns", 625, 8192, (32, 12),
             (623, 4, 2048, 2048))):
        err = max(err, check_window_one(name, key, n_cols, B, pq, w, dev))
    g = threefry.layer_uniforms(key, 640, (2, 8192, 12, 10), device=dev)
    for w in ((160, 160, 0, 8192), (320, 320, 4096, 4096)):
        err = max(err, check_window_one(f"tnn_train_8k 640 sites layer 2 {w}", key,
                                        640, 8192, (12, 10), w, dev, g))
    del g
    g = threefry.layer_uniforms(key, 625, (2, 8192, 12, 10), device=dev)
    err = max(err, check_window_one("tnn_train_8k 625 sites 1x4 last rank (3 pad)",
                                    key, 625, 8192, (12, 10), (471, 157, 0, 8192), dev, g))
    del g
    torch.cuda.empty_cache()
    return err


def measure_window_threefry(dev):
    """The window entry at the 2x2 mesh's training shape (625 sites, B = 16:
    a rank's (313, 2, 8, p, q) of each layer; rank 3's, whose last column is
    a pad site): device ms per call in turns with the plain version, beside
    its bound (the floats written; the INT32 operations of the 312 real
    columns' hashes). The row is the mean of the two layers' launches."""
    key = t_random.PRNGKey(32)
    spec = padding.MeshSpec(n_data=2, n_model=2, n_cols=625, data_index=1,
                            model_index=1)
    w = spec.uniform_window(625, WAVE_BATCH // 2)
    per = []
    for l, pq in enumerate(((32, 12), (12, 10)), start=1):
        k = lambda: threefry.window_uniforms(key, 625, WAVE_BATCH, pq, w, device=dev)  # noqa: E731
        pl = lambda: threefry.window_uniforms_plain(key, 625, WAVE_BATCH, pq, w,  # noqa: E731
                                                     device=dev)
        ms, plain_ms, readings = in_turns(k, pl, 200)
        per_col = 2 * (WAVE_BATCH // 2) * pq[0] * pq[1]
        work = RL.threefry_work(312 * per_col, pad_floats=per_col)
        per.append(_timing(f"threefry window layer {l} {w}", WAVE_BATCH // 2, ms,
                           plain_ms, readings, work))
    return _mean_timing(per)


def _mesh_train(mesh, ref, impl: str, k: int):
    """The train launcher with --mesh on this rank, counts from 0 just before
    it and the collectives recorded; its gathered final state, vote table and
    accuracy must equal train A's (the unmeshed card run)."""
    name = f"{mesh.n_data}x{mesh.n_model}"
    ckpt = os.path.join(MESH_DIR, f"train_{name}_{impl}")
    reset_counts()
    t0 = time.perf_counter()
    with collectives_recorded() as entries:
        out = launch_train.main(train_args(impl, ckpt, "cuda", k)
                                + ["--mesh", name] + (ref["mesh_args"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, window = read_counts(), threefry.LAUNCHES.window
    tr = out["trainer"]
    st = convert.state_from_local(tr.state, tr.cfg, tr.mesh)
    _same_np_state(st, ref["train"]["state"], f"mesh {name} train {impl}")
    if not np.array_equal(tr.vote_table.cpu().numpy(), ref["train"]["vote_table"]):
        raise AssertionError(f"mesh {name} train {impl}: vote table differs")
    if tr.accuracy != ref["train"]["accuracy"]:
        raise AssertionError(f"mesh {name} train {impl}: accuracy differs")
    if not window or counts["threefry"] != window:
        raise AssertionError(f"mesh {name} train {impl}: {window} window draws of "
                             f"{counts['threefry']} threefry launches")
    stats = RL.collective_stats(entries)
    return {"wall_s": wall, "wave_ms_median": 1e3 * float(np.median(tr.wave_times)),
            "launches": counts, "window_launches": window,
            "collective_bytes": dict(stats.bytes_by_kind),
            "collective_counts": dict(stats.count_by_kind)}


def _mesh_online(mesh, ref):
    """Online serving at theta = (12, 3) on the mesh (fused, 64 slots, K = 4,
    swaps every 4): every uid's class id and version, the published vote
    tables and the gathered shadow equal the unmeshed card run's."""
    name = f"{mesh.n_data}x{mesh.n_model}"
    cfg = network_config(625, *FIRING, impl="fused")
    params0 = [torch.from_numpy(w) for w in ref["params0"]]
    eng = TNNEngine(cfg, params0, n_slots=SLOTS, impl="fused", superbatch_k=ONLINE_K,
                    online_stdp=True, swap_every=SWAP_EVERY, seed=0, mesh=mesh)
    eng.fit(*digits(FIT_IMAGES, seed=1))
    imgs = digits(ONLINE_REQUESTS, seed=2)[0]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with collectives_recorded() as entries:
        for uid in range(ONLINE_REQUESTS):
            eng.submit(ClassifyRequest(uid=uid, image=imgs[uid]))
        tables = {eng.version: eng.vote_table}
        while eng.pending:
            eng.poll()
            tables[eng.version] = eng.vote_table
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, window = read_counts(), threefry.LAUNCHES.window
    got = {u: (r.result, r.version) for u, r in eng.done.items()}
    if got != ref["online"]["map"]:
        diff = [u for u in ref["online"]["map"] if got.get(u) != ref["online"]["map"][u]]
        raise AssertionError(f"mesh {name} online: {len(diff)} uids differ (first {diff[:5]})")
    for v, t in ref["online"]["tables"].items():
        if not np.array_equal(tables[v].cpu().numpy(), t):
            raise AssertionError(f"mesh {name} online: published v{v} vote table differs")
    _same_np_state(convert.state_from_local(eng.learn_state, cfg, mesh),
                  ref["online"]["state"], f"mesh {name} online shadow")
    st = eng.stats()
    stats = RL.collective_stats(entries)
    return {"wall_s": wall, "waves_per_s": st.waves_per_s, "swaps": eng.swaps,
            "launches": counts, "window_launches": window,
            "collective_bytes": dict(stats.bytes_by_kind),
            "collective_counts": dict(stats.count_by_kind)}


def _mesh_colpar(mesh, impl: str):
    """The column-parallel tnn_train_8k cell (640 sites) on this 1x4 mesh:
    its gathered spike times and new weights equal the unmeshed 640-site
    wave's (saved by the parent), bit for bit."""
    outputs = {}
    res = dryrun.run_tnn_colpar_cell("tnn_train_8k", mesh, impl=impl, outputs=outputs)
    if res["status"] != "ok":
        raise AssertionError(f"colpar {impl}: {res.get('error')}\n{res.get('traceback', '')}")
    spec = outputs["spec"]
    want = torch.load(os.path.join(MESH_DIR, f"colpar_{impl}.pt"), weights_only=False)
    for l in range(2):
        z = mesh.gather_grid(outputs["zs"][l], spec, row_axis=0, site_axis=1)
        w = mesh.gather_sites(outputs["new_params"][l], spec)
        if not (torch.equal(z, want["zs"][l].to(z.device))
                and torch.equal(w, want["new_params"][l].to(w.device))):
            raise AssertionError(f"colpar {impl} layer {l}: differs from the "
                                 f"unmeshed 640-site wave")
    del outputs
    torch.cuda.empty_cache()
    return {k: res[k] for k in ("wave_ms", "collectives", "collective_counts",
                                "launches", "kernel_bound_ms", "roofline")}


def mesh_ranks():
    """What each of the 4 ranks runs: for 2x2, 4x1 and 1x4 the train
    launcher (pallas; fused K = 4) and online serving, each against the
    unmeshed card run; under 1x4 the 2x2 pallas checkpoint restored, and the
    column-parallel tnn_train_8k cell (pallas, fused) against the unmeshed
    640-site wave."""
    ref = torch.load(os.path.join(MESH_DIR, "ref.pt"), weights_only=False)
    ref["mesh_args"] = MESH_ARGS
    out = {}
    for d, m in MESH_FACTORS:
        mesh = make_mesh_2d(d, m, device="cuda", backend="gloo")
        res = {"pallas": _mesh_train(mesh, ref, "pallas", 1),
               "fused_k4": _mesh_train(mesh, ref, "fused", 4),
               "online": _mesh_online(mesh, ref)}
        if (d, m) == (1, 4):
            cfg = launcher_network_config(625)
            state, extra = restore_tnn(
                Checkpointer(os.path.join(MESH_DIR, "train_2x2_pallas")), cfg,
                mesh=mesh)
            _same_np_state(convert.state_from_local(state, cfg, mesh),
                          ref["train"]["state"], "2x2 checkpoint restored under 1x4")
            if not np.array_equal(state["vote_table"].cpu().numpy(),
                                  ref["train"]["vote_table"]):
                raise AssertionError("2x2 checkpoint under 1x4: vote table differs")
            res["colpar"] = {impl: _mesh_colpar(mesh, impl) for impl in ("pallas", "fused")}
        out[f"{d}x{m}"] = res
    return out


def nccl_rank():
    """One rank over NCCL (the launchers' default backend on the card): the
    train launcher (fused, K = 4) with --mesh 1x1 and online serving,
    against the unmeshed card runs."""
    ref = torch.load(os.path.join(MESH_DIR, "ref.pt"), weights_only=False)
    ref["mesh_args"] = ["--backend", "nccl"]
    mesh = make_mesh_2d(1, 1, device="cuda", backend="nccl")
    return {"fused_k4": _mesh_train(mesh, ref, "fused", 4),
            "online": _mesh_online(mesh, ref)}


def mesh_phase(dev, final_a, online_ref, params0, card: str):
    """The unmeshed references to files, the 640-site waves, the window
    draw's checks, then 4 gloo ranks on the card and 1 NCCL rank. Every
    rank's failure fails the run. ``card`` (the nvidia-smi line) is printed
    beside every time."""
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    t0 = time.perf_counter()
    err = check_window_threefrys(dev)
    timing = measure_window_threefry(dev)
    train_a = {"state": convert.state_to_numpy(final_a.state),
               "vote_table": final_a.vote_table.cpu().numpy(),
               "accuracy": final_a.accuracy}
    torch.save({"train": train_a, "online": online_ref,
                "params0": [w.cpu().numpy() for w in params0]},
               os.path.join(MESH_DIR, "ref.pt"))
    for impl in ("pallas", "fused"):
        outputs = {}
        res = dryrun.run_tnn_cell("tnn_train_8k", sites=dryrun.COLPAR_SITES, impl=impl,
                                  device=dev, outputs=outputs, verbose=False)
        if res["status"] != "ok":
            raise AssertionError(f"640-site tnn_train_8k {impl}: {res.get('error')}")
        torch.save({"zs": [z.cpu() for z in outputs["zs"]],
                    "new_params": [w.cpu() for w in outputs["new_params"]],
                    "wave_ms": res["wave_ms"]},
                   os.path.join(MESH_DIR, f"colpar_{impl}.pt"))
        print(f"  unmeshed 640-site tnn_train_8k {impl}: wave {res['wave_ms']:.3f} ms "
              f"(one process, the card alone: {card})", flush=True)
        del outputs
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ranks = spawn_ranks(mesh_ranks, 4, work_dir=os.path.join(MESH_DIR, "ranks"),
                        device="cuda", backend="gloo", timeout_s=600)
    t_gloo = time.perf_counter() - t1
    t1 = time.perf_counter()
    nccl = spawn_ranks(nccl_rank, 1, work_dir=os.path.join(MESH_DIR, "nccl"),
                       device="cuda", backend="nccl", timeout_s=300)[0]
    t_nccl = time.perf_counter() - t1
    cfg = launcher_network_config(625)
    state, _ = restore_tnn(Checkpointer(os.path.join(MESH_DIR, "train_2x2_pallas")), cfg,
                           device=dev)
    _same_np_state(convert.state_to_numpy(state), train_a["state"],
                  "2x2 checkpoint restored unmeshed")
    for step in ("step_00000016", "step_00000032"):   # file for file train A's
        a_dir = os.path.join(TRAIN_DIR, "a", step)
        m_dir = os.path.join(MESH_DIR, "train_2x2_pallas", step)
        for f in sorted(os.listdir(a_dir)):
            if f.endswith(".npy") and not np.array_equal(
                    np.load(os.path.join(a_dir, f)), np.load(os.path.join(m_dir, f))):
                raise AssertionError(f"2x2 checkpoint {step}/{f} differs from train A's")
    window_launches = sum(r[f][p]["window_launches"] for r in ranks
                          for f in r for p in ("pallas", "fused_k4", "online"))
    wall = time.perf_counter() - t0
    print(f"  mesh: 4 ranks sharing ONE card over gloo, 2x2, 4x1 and 1x4 == the "
          f"unmeshed card run (train pallas and fused K=4: weights, key, wave, vote "
          f"table, accuracy; online: every uid's class id and version, the published "
          f"vote tables, the shadow); the 2x2 checkpoint == train A's file for file "
          f"and restores under 1x4 and unmeshed; colpar tnn_train_8k on 1x4 == the "
          f"unmeshed 640-site wave; 1x1 over NCCL == the unmeshed run. Phase wall "
          f"{wall:.1f} s (gloo ranks {t_gloo:.1f} s, NCCL rank {t_nccl:.1f} s) on {card}",
          flush=True)
    per_rank = {}
    for f in ranks[0]:
        per_rank[f] = {}
        for part in ("pallas", "fused_k4", "online"):
            p = per_rank[f][part] = {
                "wall_s": [r[f][part]["wall_s"] for r in ranks],
                "collective_bytes": {k: v for k, v in ranks[0][f][part]["collective_bytes"].items() if v},
                "collective_counts": {k: v for k, v in ranks[0][f][part]["collective_counts"].items() if v}}
            if part == "online":
                p["waves_per_s"] = ranks[0][f][part]["waves_per_s"]
                rate = f"{p['waves_per_s']:.1f} waves/s (rank 0's clock)"
            else:
                p["wave_ms_median"] = [r[f][part]["wave_ms_median"] for r in ranks]
                rate = f"median wave ms/rank {[round(v, 3) for v in p['wave_ms_median']]}"
            print(f"  {f} {part}, 4 ranks sharing one card ({card}): wall/rank "
                  f"{[round(v, 3) for v in p['wall_s']]} s, {rate}; rank 0's collectives "
                  f"(ring-model wire bytes) {p['collective_bytes']} counts "
                  f"{p['collective_counts']}", flush=True)
    colpar = {impl: {"wave_ms": [r["1x4"]["colpar"][impl]["wave_ms"] for r in ranks],
                     "collectives": {k: v for k, v in ranks[0]["1x4"]["colpar"][impl]["collectives"].items() if v},
                     "launches_rank0": ranks[0]["1x4"]["colpar"][impl]["launches"]}
              for impl in ("pallas", "fused")}
    for impl, c in colpar.items():
        print(f"  colpar tnn_train_8k {impl} on 1x4, 4 ranks sharing one card ({card}): wave "
              f"ms/rank {[round(v, 3) for v in c['wave_ms']]}, collective wire bytes "
              f"{c['collectives']}, rank 0 launches {c['launches_rank0']}", flush=True)
    print(f"  nccl 1x1 ({card}): train fused K=4 wall {nccl['fused_k4']['wall_s']:.2f} s, "
          f"median wave {nccl['fused_k4']['wave_ms_median']:.3f} ms; online "
          f"{nccl['online']['waves_per_s']:.1f} waves/s", flush=True)
    return {"phase_wall_s": wall, "gloo_ranks_s": t_gloo, "nccl_rank_s": t_nccl,
            "shared_card_ranks": per_rank, "colpar_1x4": colpar,
            "nccl_1x1": {"train_fused_k4_wave_ms_median": nccl["fused_k4"]["wave_ms_median"],
                         "online_waves_per_s": nccl["online"]["waves_per_s"]},
            "window_launches": window_launches, "window_err": err,
            "window_timing": timing}


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# LM serving (port slice 9): the slot engine on the attention decoders
# ---------------------------------------------------------------------------

LM_WINDOW = 1 << 20          # floats of each draw window checked against the CPU
# new tokens a request: 32 until slice 15, which cut them to stay under
# 1,200 s with the hybrid's meshed training in lm_mesh
LM_MAX_NEW, LM_MAX_LEN = 16, 256
LM_SERVE = ["--requests", "8", "--slots", "4", "--max-new", str(LM_MAX_NEW),
            "--max-len", str(LM_MAX_LEN)]
LM_SMOKE_ARCHS = tuple(LM_ARCHS)   # all ten, with frames or embeds where taken
# the draw windows held to the CPU's: the embedding and one stacked weight,
# and for zamba2 also the shared block and an unstacked tail leaf
LM_WINDOWS = {
    "llama3.2-3b": (("embed", "embedding"), ("trunk", "0_dense", "attn", "wo")),
    "zamba2-7b": (("embed", "embedding"), ("trunk", "0_mamba", "mamba", "win"),
                  ("shared", "attn", "wq"), ("tail", "2_mamba", "mamba", "wout")),
    # slice 13: and the leaf particular to the arch: qwen's QKV bias (drawn
    # as zeros), mistral-nemo's (5,120, 32, 128) query projection (32 x 128
    # = 4,096 is not d = 5,120), grok's (8, 6,144, 32,768) expert input
    "qwen1.5-4b": (("embed", "embedding"), ("trunk", "0_dense", "mlp", "wo"),
                   ("trunk", "0_dense", "attn", "bq")),
    "mistral-nemo-12b": (("embed", "embedding"), ("trunk", "0_dense", "mlp", "wi"),
                         ("trunk", "0_dense", "attn", "wq")),
    "grok-1-314b": (("embed", "embedding"), ("trunk", "0_moe", "attn", "wq"),
                    ("trunk", "0_moe", "moe", "wi")),
}
# stated tolerances. Card against card (batched engine vs a one-slot run of
# the same tokens, bf16): argmax equal wherever the top-two margin exceeds
# the largest |dlogit|; trunk increments within 0.1 RMS of their RMS (the
# CPU tests' bf16 bound). Card against the CPU: float32 logits within 1e-4
# and increments within 1e-4 of their largest value; bfloat16 logits no
# further apart than bf16 is from float32 on either side (the larger of the
# card's and the CPU's max |bf16 - f32| logit difference on the same
# tokens: each side rounds every product and the residual stream to bf16
# in its own order), increments within 0.1 RMS.
LM_INC_RMS = 0.1
LM_F32 = dict(logits=1e-4, inc_max=1e-4)
# Logits of the tied-embedding archs (xlstm-125m, whisper-tiny) reach a few
# hundred (a d-term dot product with the std-1.0 embedding), where the
# float32 rounding of one logit is above 1e-4 and one bf16 ulp is 1 or 2.
# So the float32 logit tolerance is 1e-4 or LM_F32_REL of the largest
# |logit|, whichever is larger (the same for the untied archs, whose logits
# stay under 10), and the bf16 one is never below one bf16 ulp of the
# largest |logit| (two bf16 results cannot be closer than a rounding step).
LM_F32_REL = 1e-5


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 0.0


def _rms_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.sqrt(((a - b) ** 2).mean() / (b ** 2).mean().clamp_min(1e-30)))


def lm_draw_windows(cfg, params) -> dict:
    """(a) The first and last LM_WINDOW floats of each leaf of
    ``LM_WINDOWS[cfg.name]``, drawn on the card, against the CPU's draw of
    the same counter windows, bit for bit."""
    keys = lm_model.param_keys(cfg, t_random.PRNGKey(0))
    specs = dict(lm_tree_flatten(lm_model.build_specs(cfg), lm_is_spec))
    out = {}
    for path in LM_WINDOWS[cfg.name]:
        leaf = params
        for k in path:
            leaf = leaf[k]
        flat = leaf.reshape(-1)
        spec = specs[path]
        n = min(LM_WINDOW, flat.numel())   # a leaf under a window is held whole
        for lo in sorted({0, flat.numel() - n}):
            if spec.init == "normal":
                std = torch.tensor(spec.std, dtype=torch.float32)
                cpu = lm_draw_normal(keys[path], n, "cpu", offset=lo).mul_(std)
            else:   # zeros or ones: the CPU's whole leaf
                cpu = lm_materialize(spec, keys[path], "cpu").reshape(-1)[lo:lo + n]
            card = flat[lo:lo + n].cpu()
            bad = int((card.view(torch.int32) != cpu.view(torch.int32)).sum())
            name = f"{'/'.join(path)}[{lo}:{lo + n}]"
            print(f"  draw window {name} ({spec.init}): {bad} of {n} floats differ from "
                  f"the CPU's", flush=True)
            if bad:
                raise AssertionError(f"{name}: the card's draw differs from the CPU's")
            out[name] = bad
    return out


def lm_one_slot(cfg, params, req, dev, cache_dtype=torch.bfloat16):
    """Teacher-forced one-slot run of a served request's tokens: its prompt
    prefilled, then each output token but the last decoded at its position.
    Returns the (logits, increment) rows of each output token, float32."""
    cache = lm_model.init_cache(cfg, 1, LM_MAX_LEN, cache_dtype, dev)
    prompt = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int64, device=dev)[None]
    logits, cache, inc = lm_model.prefill(params, cfg, prompt, cache, increment=True)
    rows = [(logits[0].float().cpu(), inc[0, -1].cpu())]
    for i, tok in enumerate(req.out_tokens[:-1]):
        t = torch.tensor([tok], device=dev)
        logits, cache, inc = lm_model.decode_step(params, cfg, t, len(req.prompt) + i, cache,
                                                  increment=True)
        rows.append((logits[0].float().cpu(), inc[0].cpu()))
    return rows


def lm_hold(cfg, params, done, dev, what: str, cache_dtype=torch.bfloat16) -> dict:
    """Check (b): every recorded request held to a one-slot run of the same
    tokens on ``dev`` (its params): the largest |dlogit|; the argmax equal
    wherever the one-slot top-two margin exceeds it (else a near tie,
    counted); the trunk increments' largest RMS difference, relative."""
    rows = {u: lm_one_slot(cfg, params, r, dev, cache_dtype) for u, r in done.items()}
    d_logit = max(float((a - lg).abs().max())
                  for u, r in done.items() for a, (lg, _) in zip(r.logits, rows[u]))
    ties = disagree = flips = steps = 0
    inc_rel = 0.0
    for u, r in done.items():
        for a, ia, (lg, inc) in zip(r.logits, r.increments, rows[u]):
            steps += 1
            top2 = torch.topk(lg, 2).values
            margin = float(top2[0] - top2[1])
            flipped = int(torch.argmax(a)) != int(torch.argmax(lg))
            flips += flipped
            if margin <= d_logit:
                ties += 1
            elif flipped:
                disagree += 1
            inc_rel = max(inc_rel, _rms_rel(ia, inc))
    print(f"  {what}: {len(done)} requests, {steps} steps held to one-slot runs: "
          f"max |dlogit| {d_logit:.4g}, {ties} near ties (margin <= it), {flips} argmax "
          f"differences in all, {disagree} outside the near ties; trunk increment max RMS "
          f"diff {inc_rel:.4g} of its RMS (tolerance {LM_INC_RMS})", flush=True)
    if disagree:
        raise AssertionError(f"{what}: {disagree} argmax disagreements outside near ties")
    if inc_rel > LM_INC_RMS:
        raise AssertionError(f"{what}: trunk increments differ by {inc_rel:.4g} RMS")
    return {"steps": steps, "max_abs_dlogit": d_logit, "near_ties": ties,
            "argmax_differences": flips, "inc_rms_rel": inc_rel}


def lm_recorded(cfg, params, n: int, slots: int, dev, cache_dtype=torch.bfloat16):
    """The launcher's requests served again with the engine recording its
    logits and increments (same shapes and dtypes: the same tokens)."""
    eng = LMEngine(cfg, params, n_slots=slots, max_len=LM_MAX_LEN, device=dev, record=True,
                   cache_dtype=cache_dtype)
    for req in launch_serve.lm_requests(cfg, n, LM_MAX_NEW):
        eng.submit(req)
    return eng.run_until_done(), eng


def lm_trace_decode(eng, cfg, lengths) -> dict:
    """One traced pass of decode ticks (a batched decode_step and its argmax
    to the host) on the engine's cache, and their CUDA-event time."""
    n = eng.n_slots
    tok = torch.as_tensor(eng.last_token, device=eng.device)
    pos = torch.as_tensor([L - 1 for L in lengths][:n], device=eng.device)

    def tick():
        logits, _ = lm_model.decode_step(eng.params, cfg, tok, pos, eng.cache)
        torch.argmax(logits, dim=-1).cpu()

    ev_ms = time_cuda(tick, 10)
    tr = trace_cell_wave("decode tick", tick, repeats=3)
    return {"events_ms": ev_ms, **tr}


def lm_serve_case(name: str, argv, dev, smi: str, cfg=None, hold_dtype=None) -> dict:
    """Serve through the launcher (weights drawn on the card), trace a
    decode pass of its engine and price it, then hold every request to a
    one-slot run (check (b)). ``hold_dtype="float32"`` holds a float32
    re-serve of the same requests (float32 cache) to float32 one-slot runs
    instead of the launcher's bf16 tokens: for a model whose depth
    amplifies bf16 rounding until the batched and one-row bf16 runs are
    apart everywhere (zamba2-7b, PERF.md), the hold can only show that the
    rows do not couple where rounding is small. Returns the numbers and the
    report (its weights)."""
    args = launch_serve.parse_args(argv)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    rep = launch_serve.serve_lm(args, cfg=cfg)
    launcher_s = time.perf_counter() - t0
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"{name}: the LM path launched TNN kernels {counts}")
    peak = torch.cuda.max_memory_allocated(dev) - base
    cfg = rep.cfg
    tokens = {u: list(r.out_tokens) for u, r in rep.done.items()}
    n_ticks, slots = len(rep.engine.decode_ms), rep.engine.n_slots
    mean_len = int(np.mean([len(r.prompt) for r in rep.done.values()])) + LM_MAX_NEW // 2
    lengths = [mean_len] * slots
    bound_ms, bound_by, _ = RL.lm_decode_bound(cfg, lengths)
    nbytes, ops = RL.lm_decode_work(cfg, lengths)
    trace = lm_trace_decode(rep.engine, cfg, lengths)
    rep.engine = None
    gc.collect()
    torch.cuda.empty_cache()
    if hold_dtype is None:
        done, eng = lm_recorded(cfg, rep.params, args.requests, slots, dev)
        if {u: r.out_tokens for u, r in done.items()} != tokens:
            raise AssertionError(f"{name}: the recorded run's tokens differ from the launcher's")
        held = lm_hold(cfg, eng.params, done, dev, name)
    else:
        dt = lm_model.as_dtype(hold_dtype)
        cfg_h = dataclasses.replace(cfg, dtype=hold_dtype)
        done, eng = lm_recorded(cfg_h, rep.params, args.requests, slots, dev, dt)
        same = sum(a == b for u, r in done.items() for a, b in zip(r.out_tokens, tokens[u]))
        print(f"  {name}: the {hold_dtype} re-serve shares {same} of "
              f"{sum(map(len, tokens.values()))} tokens with the launcher's bf16 serve",
              flush=True)
        held = lm_hold(cfg_h, eng.params, done, dev, f"{name} ({hold_dtype} hold)", dt)
    print(f"  {name} ({smi}): {rep.tokens} tokens in {rep.wall_s:.3f} s = "
          f"{rep.tokens_per_s:.1f} tokens/s; decode tick median {rep.decode_ms:.3f} ms "
          f"({n_ticks} ticks of {slots} slots), {trace['events_ms']:.3f} ms by CUDA events; "
          f"prefill median {rep.prefill_ms:.3f} ms; bound {bound_ms:.4f} ms by {bound_by} "
          f"({nbytes / 1e9:.3f} GB at {slots} rows of {mean_len} positions); peak "
          f"{peak / 2**30:.2f} GiB over the {base / 2**30:.2f} GiB held before; "
          f"launcher {launcher_s:.2f} s with the draw", flush=True)
    del eng
    return {"params": lm_model.param_count(cfg), "requests": len(done), "tokens": rep.tokens,
            "wall_s": rep.wall_s, "tokens_per_s": rep.tokens_per_s,
            "decode_ms": rep.decode_ms, "decode_events_ms": trace["events_ms"],
            "prefill_ms": rep.prefill_ms, "ticks": n_ticks, "slots": slots,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes,
            "bound_lengths": lengths, "peak_gib": peak / 2**30,
            "launcher_s": launcher_s, "trace": {k: v for k, v in trace.items()
                                                if k != "events_ms"},
            "held": held}, rep


def lm_extras(cfg, B: int, seed: int) -> dict:
    """The family's extra inputs, drawn from a numpy seed (never zeros: a
    zero input would hide a broken cross-attention or projector): ``frames``
    (B, enc_seq, d) for the encoder-decoder, ``embeds`` (B, frontend_len, d)
    for the VLM prefix; float32 on the host."""
    rng = np.random.default_rng(seed)
    if cfg.n_enc_layers:
        shape, name = (B, cfg.enc_seq, cfg.d_model), "frames"
    elif cfg.frontend == "vision_stub":
        shape, name = (B, cfg.frontend_len, cfg.d_model), "embeds"
    else:
        return {}
    return {name: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))}


def _lm_run(cfg, params, prompt, feed, dev, steps: int = 8, extras=None):
    """Prefill of ``prompt`` (2 rows, after any embeds prefix, with any
    frames), then ``steps`` decode steps of the ``feed`` tokens (None: its
    own greedy tokens) on ``dev``, cache and compute in ``cfg.dtype``.
    Returns the (logits, increment) rows of each step, float32 on the host,
    and the tokens fed."""
    extras = {k: v.to(dev) for k, v in (extras or {}).items()}
    P = extras["embeds"].shape[1] if "embeds" in extras else 0
    p = lm_model.compute_params(params, cfg.dtype)
    # the cache in the compute dtype: a bf16 cache would round the two
    # sides' float32 K/V apart wherever they straddle a bf16 rounding point
    cache = lm_model.init_cache(cfg, prompt.shape[0], P + prompt.shape[1] + steps + 1,
                                cfg.dtype, dev)
    logits, cache, inc = lm_model.prefill(p, cfg, prompt.to(dev), cache, increment=True,
                                          **extras)
    rows, fed = [(logits.float().cpu(), inc[:, -1].cpu())], []
    for i in range(steps):
        fed.append(torch.argmax(logits, -1).cpu() if feed is None else feed[i])
        logits, cache, inc = lm_model.decode_step(p, cfg, fed[-1].to(dev),
                                                  P + prompt.shape[1] + i, cache,
                                                  increment=True)
        rows.append((logits.float().cpu(), inc.cpu()))
    return rows, fed


def lm_card_vs_cpu(cfg, params_card, dev, tag: str, steps: int = 8, extras=None) -> dict:
    """Check (c)/(f): prefill of 2 rows of 12 tokens (with the family's
    ``extras``: frames or embeds) plus ``steps`` decode steps teacher-forced
    on the card's bf16 greedy tokens, on the card and on the CPU from the
    same weights, in bfloat16 and in float32: logits and trunk increments at
    the stated tolerances (also each side's bf16 logits against its own f32
    ones, printed: the rounding the bf16 tolerance must hold)."""
    params_cpu = lm_tree_map(lambda t: t.cpu(), params_card)
    prompt = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 12)))
    bf, f32 = dataclasses.replace(cfg, dtype="bfloat16"), dataclasses.replace(cfg, dtype="float32")
    # the card's greedy tokens
    _, feed = _lm_run(bf, params_card, prompt, None, dev, steps, extras)
    runs = {(w, c.dtype): _lm_run(c, p, prompt, feed, d, steps, extras)[0]
            for w, p, d in (("card", params_card, dev), ("cpu", params_cpu, torch.device("cpu")))
            for c in (bf, f32)}
    out = {}
    for dtype in ("float32", "bfloat16"):
        dl, inc_err = 0.0, 0.0
        for (la, ia), (lb, ib) in zip(runs["card", dtype], runs["cpu", dtype]):
            dl = max(dl, float((la - lb).abs().max()))
            if dtype == "float32":
                inc_err = max(inc_err, float((ia - ib).abs().max() / ib.abs().max()))
            else:
                inc_err = max(inc_err, _rms_rel(ia, ib))
        top = max(float(lb.abs().max()) for lb, _ in runs["cpu", dtype])
        out[dtype] = {"max_abs_dlogit": dl, "increment": inc_err, "max_abs_logit": top}
        if dtype == "float32":
            tol = max(LM_F32["logits"], LM_F32_REL * top)
            ok = dl <= tol and inc_err <= LM_F32["inc_max"]
            print(f"  {tag} float32, card vs CPU (prefill + {steps} decode steps): max |dlogit| "
                  f"{dl:.4g} (tolerance {tol:.4g}: {LM_F32['logits']}, or {LM_F32_REL} of the "
                  f"largest |logit| {top:.4g}), increment max |diff| / max |inc| {inc_err:.4g} "
                  f"(tolerance {LM_F32['inc_max']})", flush=True)
        else:
            own = {w: max(float((a[0] - b[0]).abs().max()) for a, b in
                          zip(runs[w, "bfloat16"], runs[w, "float32"])) for w in ("card", "cpu")}
            ulp = bf16_ulp(top)
            out[dtype].update(bf16_vs_f32=own, bf16_ulp=ulp)
            tol = max(max(own.values()), ulp)
            ok = dl <= tol and inc_err <= LM_INC_RMS
            print(f"  {tag} bfloat16, card vs CPU: max |dlogit| {dl:.4g} (tolerance {tol:.4g}: "
                  f"the larger of each side's max |bf16 - f32| logit difference, card "
                  f"{own['card']:.4g}, CPU {own['cpu']:.4g}, and one bf16 ulp of the largest "
                  f"|logit| {top:.4g}, {ulp:.4g}), increment RMS diff / RMS "
                  f"{inc_err:.4g} (tolerance {LM_INC_RMS})", flush=True)
        if not ok:
            raise AssertionError(f"{tag} {dtype}: card and CPU differ beyond the tolerance")
    return out


def lm_batch_drift(cfg, params, dev, steps: int = 8, B: int = 4, S: int = 12) -> dict:
    """How far a batch of B rows drifts from the same rows run one at a
    time, model level, in float32 (float32 cache) and in bfloat16 (bf16
    cache): prefill of B seeded prompts, then ``steps`` decode steps of the
    batch's greedy tokens, each row also alone with the same tokens.
    Printed, not asserted: it measures how much rounding the model
    amplifies (the rows do not couple: the float32 hold asserts that)."""
    out = {}
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S)))
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        p = lm_model.compute_params(params, dtype)
        batch, feed = _lm_run(c, p, prompt, None, dev, steps)
        dl, di = 0.0, 0.0
        for r in range(B):
            one, _ = _lm_run(c, p, prompt[r:r + 1], [f[r:r + 1] for f in feed], dev, steps)
            for (lb, ib), (lo, io) in zip(batch, one):
                dl = max(dl, float((lb[r] - lo[0]).abs().max()))
                di = max(di, _rms_rel(ib[r], io[0]))
        out[dtype] = {"max_abs_dlogit": dl, "inc_rms_rel": di}
        del p
    print(f"  {cfg.name}: {B} rows batched against each row alone (prefill of {S} + "
          f"{steps} steps): float32 max |dlogit| {out['float32']['max_abs_dlogit']:.4g}, "
          f"increments {out['float32']['inc_rms_rel']:.4g} RMS; bfloat16 "
          f"{out['bfloat16']['max_abs_dlogit']:.4g}, {out['bfloat16']['inc_rms_rel']:.4g} RMS",
          flush=True)
    return out


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def lm_prefix_serving(dev, steps: int = 4) -> dict:
    """internvl2-76b at full width cut to 2 of 80 layers, float32 on the
    card: a 256-position embeds prefix (seeded) and 12 tokens; prefill of
    the prefix and the first 8 tokens, then 4 decode steps of the rest,
    held to forward_train of all of it (serving equals training: the
    reference test's 3e-4 / 3e-3 on the logits; increments within 1e-4 of
    their largest value)."""
    cfg = dataclasses.replace(get_lm_config("internvl2-76b"), n_layers=2, layout_repeat=2,
                              dtype="float32")
    t0 = time.perf_counter()
    params = lm_model.init_params(cfg, t_random.PRNGKey(0), dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    emb = lm_extras(cfg, 2, seed=13)["embeds"].to(dev)
    P, S = emb.shape[1], 12
    tok = torch.from_numpy(np.random.default_rng(14).integers(0, cfg.vocab_size, (2, S))).to(dev)
    full, full_inc = lm_model.forward_train(params, cfg, tok, embeds=emb, increment=True)
    n = S - steps
    cache = lm_model.init_cache(cfg, 2, P + S + 1, torch.float32, dev)
    last, cache, inc = lm_model.prefill(params, cfg, tok[:, :n], cache, embeds=emb,
                                        increment=True)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    d_pre = float((last - full[:, P + n - 1]).abs().max())
    inc_err = rel(inc, full_inc[:, :P + n])
    d_dec = 0.0
    for i in range(steps):
        logits, cache, inc = lm_model.decode_step(params, cfg, tok[:, n + i], P + n + i, cache,
                                                  increment=True)
        d_dec = max(d_dec, float((logits - full[:, P + n + i]).abs().max()))
        inc_err = max(inc_err, rel(inc, full_inc[:, P + n + i]))
    print(f"  internvl2-76b (2 of 80 layers, d = 8192, {lm_model.param_count(cfg):,} "
          f"parameters drawn in {draw_s:.1f} s), float32, {P}-position embeds prefix: prefill "
          f"max |dlogit| {d_pre:.4g} (tolerance 3e-4), {steps} decode steps {d_dec:.4g} "
          f"(3e-3) against forward_train; increments {inc_err:.4g} of their largest "
          f"(1e-4)", flush=True)
    if d_pre > 3e-4 or d_dec > 3e-3 or inc_err > 1e-4:
        raise AssertionError("internvl2-76b prefix: serving differs from training")
    return {"params": lm_model.param_count(cfg), "draw_s": draw_s, "prefix": P,
            "prefill_max_abs_dlogit": d_pre, "decode_max_abs_dlogit": d_dec,
            "inc_max_rel": inc_err}


FRONTEND_LAUNCHES = {
    "pallas": {"tnn_column": t_frontend.WAVES + 1, "stdp_update": t_frontend.WAVES,
               "threefry": t_frontend.WAVES},
    "direct": {"threefry": t_frontend.WAVES},
    "cpu": {},
}


def frontend_phase(dev) -> dict:
    """The TNN-frontend -> LM entry point (``launch.tnn_frontend_lm``, LM in
    float32): --impl pallas and direct on the card, direct on the CPU, each
    with the counts set to 0 just before it. pallas launches the column
    kernel a wave and once more for the frozen forward, the STDP and
    threefry kernels a wave; direct only the threefry kernel (its uniforms
    are drawn on the card). All three give the same trained weights, spike
    times, winners and embeds; logits within the float32 tolerance."""
    runs, counts, secs = {}, {}, {}
    for name, argv in (("pallas", ["--impl", "pallas"]), ("direct", ["--impl", "direct"]),
                       ("cpu", ["--impl", "direct", "--device", "cpu"])):
        t0 = time.perf_counter()
        reset_counts()
        runs[name] = t_frontend.main(argv + ["--dtype", "float32"])
        torch.cuda.synchronize()
        counts[name] = read_counts()
        secs[name] = time.perf_counter() - t0
        want = {k: FRONTEND_LAUNCHES[name].get(k, 0) for k in counts[name]}
        if counts[name] != want:
            raise AssertionError(f"frontend {name}: launches {counts[name]}, expected {want}")
    for name in ("direct", "cpu"):
        for k in ("weights", "z", "winners", "embeds"):
            if not torch.equal(runs[name][k], runs["pallas"][k]):
                raise AssertionError(f"frontend: {k} of {name} differ from pallas")
    d_card = float((runs["direct"]["logits"] - runs["pallas"]["logits"]).abs().max())
    d_cpu = float((runs["cpu"]["logits"] - runs["pallas"]["logits"]).abs().max())
    print(f"  frontend: pallas (card) == direct (card) == CPU: trained weights, spike "
          f"times, winners, embeds; logits max |d| card {d_card:.4g}, card vs CPU "
          f"{d_cpu:.4g} (tolerance {LM_F32['logits']}); launches {counts}; seconds {secs}",
          flush=True)
    if d_card > LM_F32["logits"] or d_cpu > LM_F32["logits"]:
        raise AssertionError("frontend: logits differ beyond the float32 tolerance")
    return {"launches": counts, "seconds": secs, "logits_card_max_abs": d_card,
            "logits_cpu_max_abs": d_cpu,
            "winners": runs["pallas"]["winners"][0].tolist()}


# served at full width, cut in depth to these layers of their 40 (slice 13
# served both at full size; slice 15 cut them, and grok-1-314b from 2 of its
# 64 layers to LM_GROK_LAYERS, so that the run stays under 1,200 s with the
# hybrid's meshed training in lm_mesh)
LM_LAST = {"qwen1.5-4b": 4, "mistral-nemo-12b": 2}
LM_GROK_LAYERS = 1
LM_BIAS_STD = 0.5   # qwen's QKV biases in its card-vs-CPU check: a seeded draw, not zeros


def lm_last_three(dev, smi: str, argv_tail) -> dict:
    """Slice 13 (ROADMAP Queue 1 item 6(f)): qwen1.5-4b (QKV biases) and
    mistral-nemo-12b (32 x 128 = 4,096 query width, not d = 5,120) served
    at full width cut to LM_LAST's layers and held to one-slot runs, their
    draw windows against the CPU's, then each cut to 2 layers card against
    the CPU in bf16 and f32 (qwen's biases filled with one seeded draw, so
    the bias add is exercised); grok-1-314b (32,768-wide experts) cut to
    LM_GROK_LAYERS of 64 layers with its capacity factor at E / k, as
    mixtral's, served, held in
    float32 (as zamba2-7b) and its batch drift printed, its draw windows
    against the CPU's (its float32 params, 45.8 GB, are not copied to the
    CPU). Each model freed before the next."""
    out = {}
    for arch, layers in LM_LAST.items():
        t1 = time.perf_counter()
        case, rep = lm_serve_case(f"{arch} ({layers} layers)", ["--arch", arch, *argv_tail],
                                  dev, smi, cfg=dataclasses.replace(
                                      get_lm_config(arch), n_layers=layers, layout_repeat=layers))
        out[f"{arch}_{layers}layers"] = case
        case["draw_windows"] = lm_draw_windows(rep.cfg, rep.params)
        del rep
        _free()
        cut = dataclasses.replace(get_lm_config(arch), n_layers=2, layout_repeat=2)
        p2 = lm_model.init_params(cut, t_random.PRNGKey(0), dev)
        if cut.qkv_bias:
            rng = np.random.default_rng(17)
            attn = p2["trunk"]["0_dense"]["attn"]
            for k in ("bq", "bk", "bv"):
                attn[k].copy_(torch.from_numpy(
                    LM_BIAS_STD * rng.standard_normal(tuple(attn[k].shape), dtype=np.float32)))
        out[f"{arch}_2layers_card_vs_cpu"] = lm_card_vs_cpu(cut, p2, dev, f"{arch} 2 layers")
        del p2
        _free()
        out[f"seconds_{arch}"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    grok = get_lm_config("grok-1-314b")
    cut = dataclasses.replace(grok, n_layers=LM_GROK_LAYERS, layout_repeat=LM_GROK_LAYERS,
                              moe_capacity_factor=grok.n_experts / grok.experts_per_token)
    # held in float32: in bf16 one decode step of 128 differs from its
    # one-row run by half the increment's RMS, the rest by about 0.01. A
    # router near-tie (the k-th and (k+1)-th bf16 logits within an ulp)
    # flips between the two runs, whose expert GEMMs (capacity 5 rows
    # against 2) round apart; with the routing fixed, or the router's
    # logits in float32, every step is within 0.011 (PERF.md, Findings).
    # lm_batch_drift prints the model-level drift
    case, rep = lm_serve_case(f"grok-1-314b ({LM_GROK_LAYERS} layer)",
                              ["--arch", "grok-1-314b", *argv_tail], dev, smi, cfg=cut,
                              hold_dtype="float32")
    out[f"grok-1-314b_{LM_GROK_LAYERS}layer"] = case
    case["draw_windows"] = lm_draw_windows(rep.cfg, rep.params)
    case["batch_drift"] = lm_batch_drift(rep.cfg, rep.params, dev)
    del rep
    _free()
    out["seconds_grok-1-314b"] = time.perf_counter() - t1
    return out


def lm_phase(dev, smi: str) -> dict:
    """(a)-(f) of the LM serve path, then the slice-10 families and the
    frontend entry point; each model freed before the next."""
    torch.empty(1, device=dev)   # the allocator's stats need it started
    out = {}
    t0 = time.perf_counter()
    case, rep = lm_serve_case("llama3.2-3b", ["--arch", "llama3.2-3b", *LM_SERVE], dev, smi)
    out["llama3.2-3b"] = case
    out["llama3.2-3b"]["draw_windows"] = lm_draw_windows(rep.cfg, rep.params)
    del rep
    _free()
    cut = dataclasses.replace(get_lm_config("llama3.2-3b"), n_layers=2, layout_repeat=2)
    p2 = lm_model.init_params(cut, t_random.PRNGKey(0), dev)
    out["llama3.2-3b_2layers_card_vs_cpu"] = lm_card_vs_cpu(cut, p2, dev, "llama3.2-3b 2 layers")
    del p2
    _free()
    out["seconds_llama"] = time.perf_counter() - t0
    four = ["--requests", "4", "--slots", "4", "--max-new", str(LM_MAX_NEW),
            "--max-len", str(LM_MAX_LEN)]
    # minicpm3-4b cut to 8 of its 62 layers (16 until slice 15), zamba2-7b
    # (below) to 1 of its 13
    # units and the tail: both at full size would take the run past 1,200 s
    case, rep = lm_serve_case("minicpm3-4b (8 layers)", ["--arch", "minicpm3-4b", *four],
                              dev, smi, cfg=dataclasses.replace(
                                  get_lm_config("minicpm3-4b"), n_layers=8, layout_repeat=8))
    out["minicpm3-4b_8layers"] = case
    del rep
    _free()
    # mixtral cut to 2 layers, and its capacity factor raised to E / k so no
    # token is dropped: the reference's decode routes all slots as one group
    # (capacity 2 at 4 slots), so at 1.25 a request's tokens depend on the
    # other slots' (idle ones too) and need not equal its one-slot run, in
    # either package (ROADMAP Queue 3)
    mix = get_lm_config("mixtral-8x22b")
    cut = dataclasses.replace(mix, n_layers=2, layout_repeat=2,
                              moe_capacity_factor=mix.n_experts / mix.experts_per_token)
    case, rep = lm_serve_case("mixtral-8x22b (2 layers)", ["--arch", "mixtral-8x22b", *four],
                              dev, smi, cfg=cut)
    out["mixtral-8x22b_2layers"] = case
    del rep
    _free()
    out["seconds_slice9"] = time.perf_counter() - t0
    out.update(lm_last_three(dev, smi, four))

    # slice 10: the hybrid and SSM families served at full size, the
    # encoder-decoder and the VLM prefix at the model level, the frontend
    t1 = time.perf_counter()
    # zamba2's depth amplifies bf16 rounding until a batched bf16 run and its
    # one-row runs differ everywhere (PERF.md, Findings): its hold runs in
    # float32. Cut to 1 of its 13 units of 6 and the 3-block tail (9 layers;
    # slice 13 served 4 units, 27 layers; slice 15 cut it to stay under
    # 1,200 s with the hybrid's meshed training in lm_mesh)
    case, rep = lm_serve_case("zamba2-7b (9 layers)", ["--arch", "zamba2-7b", *LM_SERVE], dev,
                              smi, cfg=dataclasses.replace(get_lm_config("zamba2-7b"),
                                                           n_layers=9, layout_repeat=1),
                              hold_dtype="float32")
    out["zamba2-7b_9layers"] = case
    out["zamba2-7b_9layers"]["draw_windows"] = lm_draw_windows(rep.cfg, rep.params)
    out["zamba2-7b_9layers"]["batch_drift"] = lm_batch_drift(rep.cfg, rep.params, dev)
    del rep
    _free()
    cut = dataclasses.replace(get_lm_config("zamba2-7b"), n_layers=9, layout_repeat=1)
    pz = lm_model.init_params(cut, t_random.PRNGKey(0), dev)
    out["zamba2-7b_1unit_card_vs_cpu"] = lm_card_vs_cpu(
        cut, pz, dev, "zamba2-7b (one unit of 6 and the 3-block tail)")
    del pz
    _free()
    out["seconds_zamba2"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    case, rep = lm_serve_case("xlstm-125m", ["--arch", "xlstm-125m", *LM_SERVE], dev, smi)
    out["xlstm-125m"] = case
    out["xlstm-125m_card_vs_cpu"] = lm_card_vs_cpu(rep.cfg, rep.params, dev, "xlstm-125m")
    del rep
    _free()
    out["seconds_xlstm"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    whisper = get_lm_config("whisper-tiny")
    pw = lm_model.init_params(whisper, t_random.PRNGKey(0), dev)
    out["whisper-tiny_card_vs_cpu"] = lm_card_vs_cpu(
        whisper, pw, dev, f"whisper-tiny (frames (2, {whisper.enc_seq}, {whisper.d_model}))",
        steps=16, extras=lm_extras(whisper, 2, seed=11))
    del pw
    _free()
    out["seconds_whisper"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["internvl2-76b_2layers_prefix"] = lm_prefix_serving(dev)
    _free()
    out["seconds_internvl"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["frontend"] = frontend_phase(dev)
    out["seconds_frontend"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    smoke = {}
    for i, arch in enumerate(LM_SMOKE_ARCHS):
        cfg = lm_smoke_config(arch)
        card = lm_model.init_params(cfg, t_random.PRNGKey(0), dev)
        cpu = lm_model.init_params(cfg, t_random.PRNGKey(0), "cpu")
        bad = sum(int((a.cpu().view(torch.int32) != b.view(torch.int32)).sum())
                  for (_, a), (_, b) in zip(lm_tree_flatten(card), lm_tree_flatten(cpu)))
        if bad:
            raise AssertionError(f"smoke {arch}: {bad} parameters differ card vs CPU")
        smoke[arch] = lm_card_vs_cpu(cfg, card, dev, f"smoke {arch}",
                                     extras=lm_extras(cfg, 2, seed=20 + i))
    out["smoke"] = smoke
    out["seconds_smoke"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    print(f"  lm sub-phase seconds: "
          f"{ {k: round(v, 1) for k, v in out.items() if k.startswith('seconds')} }",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# LM training (port slice 11): train step, trainer, checkpoints, launcher
# ---------------------------------------------------------------------------

LM_TRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_lm_train")  # .gitignore lists build/
LM_HOLD_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=2)
# The CPU tests' float32 tolerances (tests/test_torch_lm_train_step.py): the
# step's loss, loss_total and grad_norm within 1e-5 relative; params after
# the steps within 0.25 lr at most and within 1e-3 of the RMS distance they
# moved in RMS (AdamW's normalised update turns a grad that differs in its
# last bits near eps into a step a fraction of lr apart).
LM_TRAIN_METRIC_REL = 1e-5
LM_TRAIN_PARAM_LR = 0.25
LM_TRAIN_PARAM_RMS = 1e-3
LM_LAUNCH = ["--arch", "llama3.2-3b", "--steps", "4", "--batch", "8", "--seq", "512"]
LM_RESUME = ["--arch", "llama3.2-3b", "--smoke", "--steps", "8"]
LM_FULL_BATCH, LM_FULL_SEQ, LM_FULL_WARMUP, LM_FULL_TIMED = 4, 512, 2, 6


def llama_layers(n: int, **kw):
    """llama3.2-3b at full width cut to ``n`` of its 28 layers."""
    return dataclasses.replace(get_lm_config("llama3.2-3b"), n_layers=n, layout_repeat=n, **kw)


def _host_copy(tree):
    return lm_tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def lm_train_hold(dev) -> dict:
    """Part 1: llama3.2-3b at full width cut to 2 layers (989,346,816 spec
    params), float32, AdamW, B = 1, S = 32, kv_chunk 128: two train steps on
    the card and on the CPU from the same state (drawn from PRNGKey(0) on
    the card and copied; the draw itself is held to the CPU's in the lm
    phase), per-step metrics and the params after step 2 at the CPU tests'
    float32 tolerances."""
    cfg = llama_layers(2, dtype="float32")
    opt_cfg = lm_opt.OptConfig(**LM_HOLD_OPT)
    step = lm_ts.make_train_step(cfg, opt_cfg, lm_ts.TrainConfig(kv_chunk=128))
    stream = TokenStream(cfg.vocab_size, 1, 32, seed=0)
    card = lm_ts.init_state(cfg, opt_cfg, t_random.PRNGKey(0), dev)
    cpu = _host_copy(card)
    start = _host_copy(card["params"])
    rows, secs = [], {"card": 0.0, "cpu": 0.0}
    for i in range(2):
        batch = stream.batch_at(i)
        got = {}
        for where, state in (("card", card), ("cpu", cpu)):
            t0 = time.perf_counter()
            _, m = step(state, batch)
            got[where] = {k: float(v) for k, v in m.items()}
            secs[where] += time.perf_counter() - t0
        for k in ("loss", "loss_total", "grad_norm"):
            a, b = got["card"][k], got["cpu"][k]
            if not abs(a - b) <= LM_TRAIN_METRIC_REL * abs(b):
                raise AssertionError(f"lm_train hold step {i + 1}: {k} card {a} cpu {b}")
        rows.append(got)
    lr = LM_HOLD_OPT["lr"]
    worst_max, worst_rms, far, total, bad = 0.0, 0.0, 0, 0, []
    for (path, a), (_, b), (_, s0) in zip(lm_tree_flatten(card["params"]),
                                          lm_tree_flatten(cpu["params"]),
                                          lm_tree_flatten(start)):
        d = (a.cpu() - b).abs()
        moved = float(((b - s0) ** 2).mean().sqrt())
        dmax, drms = float(d.max()), float((d ** 2).mean().sqrt())
        worst_max = max(worst_max, dmax / lr)
        worst_rms = max(worst_rms, drms / max(moved, 1e-30))
        far += int((d > 0.01 * lr).sum())
        total += d.numel()
        if dmax > LM_TRAIN_PARAM_LR * lr or drms > LM_TRAIN_PARAM_RMS * moved:
            bad.append(f"{path}: max {dmax:.3g}, RMS {drms:.3g} of a {moved:.3g} move")
    print(f"  llama3.2-3b 2 layers f32, 2 AdamW steps card vs CPU: losses "
          f"{[r['card']['loss_total'] for r in rows]} / {[r['cpu']['loss_total'] for r in rows]}"
          f", grad norms {[r['card']['grad_norm'] for r in rows]} / "
          f"{[r['cpu']['grad_norm'] for r in rows]} (tolerance {LM_TRAIN_METRIC_REL} "
          f"relative); params after step 2: max |diff| {worst_max:.3g} lr (tolerance "
          f"{LM_TRAIN_PARAM_LR}), RMS diff {worst_rms:.3g} of the RMS move (tolerance "
          f"{LM_TRAIN_PARAM_RMS}), {far} of {total:,} params more than 0.01 lr apart; "
          f"card {secs['card']:.2f} s, CPU {secs['cpu']:.2f} s", flush=True)
    if bad:
        raise AssertionError(f"lm_train hold: params differ card vs CPU: {bad}")
    return {"params": lm_model.param_count(cfg), "steps": rows,
            "param_max_diff_in_lr": worst_max, "param_rms_diff_of_move": worst_rms,
            "params_over_0.01_lr": far, "seconds": secs}


def _same_state(a, b, what: str) -> None:
    """Two states bit for bit, leaf by leaf (tensors or numpy arrays)."""
    fa, fb = lm_tree_flatten(a), lm_tree_flatten(b)
    if [p for p, _ in fa] != [p for p, _ in fb]:
        raise AssertionError(f"{what}: the states' leaves differ")
    for (path, x), (_, y) in zip(fa, fb):
        x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(
                x.reshape(-1).view(np.uint8), y.reshape(-1).view(np.uint8)):
            raise AssertionError(f"{what}: leaf {path} differs")


def _metrics(ckpt_dir: str) -> list:
    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def lm_train_launcher(dev) -> dict:
    """Part 2: the launcher's run (``--steps 4 --batch 8 --seq 512``) on
    llama3.2-3b cut to 2 layers, bf16: its only checkpoint is the final one
    (``ckpt_every = max(4 // 3, 5)``), restored through ``lm_abstract_state``
    equal to the trainer's final state bit for bit, then deleted."""
    cfg = llama_layers(2)
    d = os.path.join(LM_TRAIN_DIR, "launcher")
    shutil.rmtree(d, ignore_errors=True)
    args = launch_train.parse_args([*LM_LAUNCH, "--ckpt-dir", d])
    prev = signal.getsignal(signal.SIGTERM)  # the trainer installs its own
    t0 = time.perf_counter()
    try:
        out = launch_train.train_lm(args, cfg=cfg)
    finally:
        signal.signal(signal.SIGTERM, prev)
    wall = time.perf_counter() - t0
    tr = out["trainer"]
    lines = _metrics(d)
    tokens = args.batch * args.seq
    if out["final_step"] != 4 or [l["step"] for l in lines] != [1, 2, 3, 4]:
        raise AssertionError(f"lm_train launcher: {out}, metrics steps {[l['step'] for l in lines]}")
    if not all(math.isfinite(l["loss_total"]) for l in lines):
        raise AssertionError("lm_train launcher: a loss is not finite")
    ck = Checkpointer(d)
    if ck.all_steps() != [4]:
        raise AssertionError(f"lm_train launcher: checkpoints {ck.all_steps()}, expected [4]")
    for l in lines:
        print(f"  launcher step {l['step']}: loss {l['loss']:.5f}, grad_norm "
              f"{l['grad_norm']:.4f}, {1e3 * l['dt_s']:.1f} ms, "
              f"{tokens / l['dt_s']:.0f} tokens/s", flush=True)
    t1 = time.perf_counter()
    tree, extra = ck.restore(4, lm_abstract_state(cfg, launch_train.lm_opt_config(args, cfg)))
    restore_s = time.perf_counter() - t1
    if extra != {"data_step": 4}:
        raise AssertionError(f"lm_train launcher: checkpoint extra {extra}")
    _same_state(tr.state, tree, "lm_train launcher checkpoint vs the trainer's state")
    nbytes = sum(a.nbytes for _, a in lm_tree_flatten(tree))
    del tree, tr, out
    shutil.rmtree(d)
    print(f"  launcher: 4 steps of {tokens} tokens in {wall:.1f} s with the draw and the "
          f"final checkpoint ({nbytes / 1e9:.2f} GB), restored in {restore_s:.1f} s bit-equal "
          f"to the trainer's state; directory deleted", flush=True)
    return {"steps": lines, "wall_s": wall, "ckpt_bytes": nbytes, "restore_s": restore_s}


def lm_resume_pair(base: str) -> dict:
    """Part 3's runs at the smoke config on the card: A stopped after step 5
    by a SIGTERM (the trainer's handler sets the flag; the loop writes a
    blocking checkpoint), then the same command again, which resumes; B
    uninterrupted. Returns whether their states and metrics.jsonl losses
    are equal bit for bit."""
    prev = signal.getsignal(signal.SIGTERM)
    try:
        da, db = os.path.join(base, "a"), os.path.join(base, "b")
        for d in (da, db):
            shutil.rmtree(d, ignore_errors=True)
        args_a = launch_train.parse_args([*LM_RESUME, "--ckpt-dir", da])
        tr = launch_train.lm_trainer(args_a)
        orig = tr.step_fn

        def stop_after_5(state, batch):
            if tr.step == 4:
                os.kill(os.getpid(), signal.SIGTERM)
            return orig(state, batch)

        tr.step_fn = stop_after_5
        first = tr.run()
        if first["final_step"] != 5 or Checkpointer(da).latest_step() != 5:
            raise AssertionError(f"lm_train resume: run A stopped at {first}")
        a = launch_train.train_lm(args_a)
        b = launch_train.train_lm(launch_train.parse_args([*LM_RESUME, "--ckpt-dir", db]))
        la, lb = _metrics(da), _metrics(db)
        same_losses = ([(l["step"], l["loss"], l["grad_norm"]) for l in la]
                       == [(l["step"], l["loss"], l["grad_norm"]) for l in lb])
        try:
            _same_state(a["trainer"].state, b["trainer"].state, "lm_train resume")
            same_state = True
        except AssertionError:
            same_state = False
        return {"equal": same_state and same_losses, "same_state": same_state,
                "same_losses": same_losses, "restarts": a["restarts"] + b["restarts"],
                "losses": [l["loss"] for l in lb]}
    finally:
        signal.signal(signal.SIGTERM, prev)


def lm_train_resume() -> dict:
    """Part 3: the interrupted and the uninterrupted run equal bit for bit.
    If they are not, both run again in a subprocess under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8``: its warnings name the ops that have
    no deterministic kernel, and there the runs must be equal."""
    base = os.path.join(LM_TRAIN_DIR, "resume")
    out = lm_resume_pair(base)
    print(f"  resume (smoke llama3.2-3b, --steps 8, SIGTERM after step 5, run again) vs "
          f"uninterrupted: state equal {out['same_state']}, metrics.jsonl losses equal "
          f"{out['same_losses']}", flush=True)
    if not out["equal"]:
        code = ("import json, sys, warnings\n"
                f"sys.path.insert(0, {ROOT!r})\n"
                "import torch\n"
                "torch.use_deterministic_algorithms(True, warn_only=True)\n"
                "torch.backends.cuda.matmul.allow_tf32 = False\n"
                "import chip_smoke\n"
                "with warnings.catch_warnings(record=True) as w:\n"
                "    warnings.simplefilter('always')\n"
                f"    r = chip_smoke.lm_resume_pair({os.path.join(base, 'det')!r})\n"
                "r['nondeterministic'] = sorted({str(x.message)[:160] for x in w\n"
                "                                if 'determinis' in str(x.message)})\n"
                "print(json.dumps(r))\n")
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              env=env, timeout=300, cwd=ROOT)
        if proc.returncode != 0:
            raise AssertionError(f"lm_train resume: the deterministic rerun failed: "
                                 f"{proc.stderr[-2000:]}")
        det = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"  deterministic rerun: equal {det['equal']}; ops without a deterministic "
              f"kernel: {det['nondeterministic'] or 'none named'}", flush=True)
        out["deterministic_rerun"] = det
        if not det["equal"]:
            raise AssertionError("lm_train resume: resumed and uninterrupted runs differ, "
                                 "also under deterministic algorithms")
    shutil.rmtree(base, ignore_errors=True)
    return out


def lm_train_full(dev, smi: str) -> dict:
    """Part 4: llama3.2-3b at full size (28 layers, 3,606,752,256 spec
    params), bf16 compute, float32 masters, AdamW, remat "full", B x S =
    4 x 512: ``init_state`` and ``make_train_step`` on the card, 2 warm-up
    and 6 timed steps (host clock, each step ends in its loss's sync), no
    checkpoint; MFU against the spec count, the bound of ``lm_train_work``,
    one traced step (busy, idle share, kernels, top ops) and the peak; then
    one step of the same rows as two micro-steps, its time and its peak."""
    cfg = get_lm_config("llama3.2-3b")
    n_steps = LM_FULL_WARMUP + LM_FULL_TIMED
    opt_cfg = lm_opt.OptConfig(lr=1e-3, warmup_steps=min(20, n_steps // 5 + 1),
                               total_steps=n_steps + 1)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = lm_ts.init_state(cfg, opt_cfg, t_random.PRNGKey(0), dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    step = lm_ts.make_train_step(cfg, opt_cfg, lm_ts.TrainConfig(kv_chunk=128))
    stream = TokenStream(cfg.vocab_size, LM_FULL_BATCH, LM_FULL_SEQ, seed=0)
    times, losses = [], []
    for i in range(n_steps):
        batch = stream.batch_at(i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, m = step(state, batch)
        losses.append(float(m["loss_total"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"lm_train full size: losses {losses}")
    step_s = float(np.median(times[LM_FULL_WARMUP:]))
    tokens = LM_FULL_BATCH * LM_FULL_SEQ
    work = RL.lm_train_work(cfg, opt_cfg, LM_FULL_BATCH, LM_FULL_SEQ)
    mfu = RL.lm_mfu(work["model_flops"], step_s)
    # the step's two halves, each ending in a sync: the loss and its grads
    # (forward, recompute, backward), then the optimizer pass; the
    # optimizer traced alone, then the whole step
    batch = stream.batch_at(n_steps)
    loss_fn = lm_ts.make_loss_fn(cfg, lm_ts.TrainConfig(kv_chunk=128))
    t1 = time.perf_counter()
    loss, _, grads = lm_ts.value_and_grad(loss_fn, state["params"],
                                          lm_ts.device_batch(batch, dev))
    float(loss)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    lm_opt.opt_update(grads, state["opt"], state["params"], opt_cfg)
    torch.cuda.synchronize()
    split = {"grads_ms": 1e3 * (t2 - t1), "optimizer_ms": 1e3 * (time.perf_counter() - t2)}
    trace_opt = trace_cell_wave("llama3.2-3b optimizer pass", lambda: lm_opt.opt_update(
        grads, state["opt"], state["params"], opt_cfg), repeats=1)
    del grads
    trace = trace_cell_wave("llama3.2-3b train step", lambda: step(state, batch), repeats=1)
    peak = torch.cuda.max_memory_allocated(dev) - base
    # the same batch as two micro-steps: one step, its peak on its own
    torch.cuda.reset_peak_memory_stats(dev)
    step2 = lm_ts.make_train_step(cfg, opt_cfg, lm_ts.TrainConfig(micro_steps=2, kv_chunk=128))
    t1 = time.perf_counter()
    _, m = step2(state, stream.batch_at(n_steps + 1))
    micro = {"loss_total": float(m["loss_total"])}
    torch.cuda.synchronize()
    micro["step_ms"] = 1e3 * (time.perf_counter() - t1)
    micro["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
    if not math.isfinite(micro["loss_total"]):
        raise AssertionError(f"lm_train full size, micro-steps 2: loss {micro['loss_total']}")
    print(f"  llama3.2-3b full size ({lm_model.param_count(cfg):,} spec params) train step, "
          f"B x S = {LM_FULL_BATCH} x {LM_FULL_SEQ}, bf16, AdamW, remat full ({smi}): median "
          f"{1e3 * step_s:.1f} ms of {LM_FULL_TIMED} (all: "
          f"{[round(1e3 * t, 1) for t in times]}), {tokens / step_s:.0f} tokens/s, MFU "
          f"{mfu:.4f} (6 x {work['model_flops'] / 6 / tokens:,.0f} params x tokens, against "
          f"989 TFLOP/s); bound {work['bound_ms']:.1f} ms (products {work['products_ms']:.1f} "
          f"ms at the bf16 peak, optimizer pass {work['optimizer_ms']:.1f} ms: "
          f"{work['bytes'] / 1e9:.1f} GB at 3.35 TB/s); losses {[round(x, 4) for x in losses]}; "
          f"draw {draw_s:.1f} s; peak {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB); one step "
          f"split: grads {split['grads_ms']:.1f} ms, optimizer {split['optimizer_ms']:.1f} ms; "
          f"traced: {trace['device_kernels']} kernels a step, the optimizer alone "
          f"{trace_opt['device_busy_ms']} ms busy of {trace_opt['wall_ms']:.1f}; micro-steps 2 "
          f"(2 x 2 rows): one step {micro['step_ms']:.1f} ms, peak "
          f"{micro['peak_bytes'] / 1e9:.2f} GB", flush=True)
    del state, step, step2
    return {"params": lm_model.param_count(cfg), "batch": LM_FULL_BATCH, "seq": LM_FULL_SEQ,
            "step_ms": 1e3 * step_s, "step_ms_all": [1e3 * t for t in times],
            "tokens_per_s": tokens / step_s, "mfu": mfu, "bound": work,
            "losses": losses, "draw_s": draw_s, "peak_bytes": peak, "split": split,
            "trace": trace, "trace_optimizer": trace_opt, "micro_steps_2": micro}


def lm_train_phase(dev, smi: str) -> dict:
    """LM training through the port's train step, trainer, checkpoints and
    launcher; no TNN kernel may launch on it."""
    torch.empty(1, device=dev)
    reset_counts()
    out, secs = {}, {}
    for name, fn in (("hold_2layers_f32", lambda: lm_train_hold(dev)),
                     ("launcher_2layers", lambda: lm_train_launcher(dev)),
                     ("resume_smoke", lm_train_resume),
                     ("full_size", lambda: lm_train_full(dev, smi))):
        t0 = time.perf_counter()
        out[name] = fn()
        _free()
        secs[name] = time.perf_counter() - t0
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"lm_train: the LM path launched TNN kernels {counts}")
    out["seconds"] = secs
    print(f"  lm_train part seconds: { {k: round(v, 1) for k, v in secs.items()} }",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# Slice 12: LM sharding, the DTensor train and serve steps on 4 ranks
# ---------------------------------------------------------------------------

LM_MESH_DIR = os.path.join(ROOT, "build", "chip_smoke_lm_mesh")  # .gitignore lists build/
LM_MESH_FACTORS = ((2, 2), (1, 4))
LM_MESH_B, LM_MESH_S = 4, 128
LM_MESH_PROMPT, LM_MESH_CACHE, LM_MESH_TICKS = 64, 128, 2   # 4 ticks until slice 15
LM_MESH_LOGITS = 1e-4        # f32 logits: of the largest |logit|
# slice 13: the smoke train steps of the other families at 2x2, as the CPU
# tests (slice 15 adds the hybrid)
LM_MESH_FAMILIES = ("minicpm3-4b", "xlstm-125m", "zamba2-7b", "whisper-tiny",
                    "internvl2-76b")
LM_MESH_FAMILY_B, LM_MESH_FAMILY_S = 4, 16
LM_MESH_GRAD = 1e-4   # step-1 grads: of each leaf's largest |grad| (the CPU tests')
# slice 15: the params' RMS hold runs over the elements the one-process
# run's AdamW state determines (optimizer.adamw_determined, the CPU tests'
# rule); the AdamW update on the ranks, fed the one-process run's params,
# moments, step-2 grads and clip scale, within LM_MESH_ULPS float32 ulps of
# its step 2 on every element (the CPU tests' AdamW tolerance)
LM_MESH_ULPS = 2
# the Adafactor counterpart of the forced AdamW hold: its row and column
# means over sharded dims sum in another order, so LM_MESH_ULPS (an
# elementwise update, measured 0) has none; the meshed Adafactor update is
# held as the CPU tests hold it against the unmeshed one: every leaf within
# 1e-5 of its largest |value| (tests/test_torch_lm_mesh.py)
LM_MESH_ADAFACTOR = 1e-5
# slice 15: the hybrid at full width (d_model 3,584, vocab 32,000) cut to one
# layout unit (5 Mamba2 layers and the shared attention) and the 3-layer
# tail, float32, AdamW, LM_MESH_B x LM_MESH_S: one process, then two steps
# at 2x2
LM_MESH_HYBRID_LAYERS = 9
# slice 14: the smoke serve steps of every other family at 2x2 and 1x4, as
# the CPU tests: 13 tokens end inside a rank's block of the 24 cache
# positions under both meshes; mixtral's 18 run past its window (16), so the
# ring buffer rolls and wraps sharded; internvl2's 8 prefix embeds, 13
# tokens and 3 ticks fill its cache
LM_MESH_SERVE_FAMILIES = ("mixtral-8x22b", "minicpm3-4b", "xlstm-125m", "zamba2-7b",
                          "whisper-tiny", "internvl2-76b")
LM_MESH_SERVE_CACHE, LM_MESH_SERVE_TICKS = 24, 3
LM_MESH_SERVE_PROMPT = {"mixtral-8x22b": 18}   # 13 tokens otherwise
LM_MESH_CACHE_HOLD = 1e-4   # cache leaves after the last tick: of the leaf's largest |value|
LM_MESH_PROBE_SERVE = ("whisper-tiny", "internvl2-76b")   # the probe's prefill cells, 2x2



def lm_tree_unflatten(flat: dict) -> dict:
    """``{path tuple: leaf}`` -> the nested dicts."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


LM_MESH_LAYERS = 2   # llama3.2-3b's layers in lm_mesh: the stacked layer dim and the
                     # hand-off between layers run sharded
LM_MESH_PROBE = ["--arch", "llama3.2-3b", "--cell", "train_4k", "--mesh", "2x2",
                 "--backend", "gloo", "--batch", str(LM_MESH_B), "--seq", str(LM_MESH_S),
                 "--repeat", str(LM_MESH_LAYERS), "--dtype", "float32", "--kv-chunk", "128",
                 "--top", "8"]


def _lm_mesh_cfg(mesh=None):
    cfg = llama_layers(LM_MESH_LAYERS, dtype="float32")
    return PT.tuned_config(cfg, mesh) if mesh is not None else cfg


def _timed_step(step, state, batch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    return state, {k: float(v) for k, v in m.items()}, 1e3 * (time.perf_counter() - t0)


def _trace_once(fn) -> dict:
    """One call of ``fn`` under torch.profiler: its wall ms, the card's busy
    ms and the idle share (None where the trace recorded no device event).
    Never runs ``fn`` again, unlike :func:`trace_cell_wave`: the other ranks
    take the same collectives once."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_ms = sum(e.self_device_time_total for e in on_card(prof.key_averages())) / 1e3
    return {"wall_ms": 1e3 * wall, "device_busy_ms": busy_ms or None,
            "device_idle_share": 1 - busy_ms / (1e3 * wall) if busy_ms else None}


_BITS = (128, 64, 32, 16, 8, 4, 2, 1)


def _pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """A bool tensor's elements, flattened, 8 to a byte: host uint8."""
    flat = mask.reshape(-1)
    flat = torch.cat([flat, flat.new_zeros((-flat.numel()) % 8)])
    w = torch.tensor(_BITS, dtype=torch.int32, device=flat.device)
    return (flat.view(-1, 8).to(torch.int32) * w).sum(1).to(torch.uint8).cpu()


def _unpack_bits(packed: torch.Tensor, shape, dev) -> torch.Tensor:
    w = torch.tensor(_BITS, dtype=torch.int32, device=dev)
    bits = (packed.to(dev).to(torch.int32).unsqueeze(1) & w) != 0
    return bits.reshape(-1)[:math.prod(shape)].view(shape)


def lm_rule(start: dict, v1, end: dict, v2, dev) -> dict:
    """The set-aside rule on one process's two AdamW steps, per leaf (host
    ``{path: tensor}`` copies in, one leaf at a time on ``dev``): the
    elements it determines (``optimizer.adamw_determined`` on the second
    moments after steps 1 and 2; packed bits), how many it sets aside, and
    the RMS move from ``start`` to ``end`` over the determined ones. With
    ``v1`` None (Adafactor: no eps in its denominator) every element is
    determined."""
    cfg = lm_opt.OptConfig(**LM_HOLD_OPT)
    out = {}
    for path, p in end.items():
        if v1 is None:
            det = torch.ones(p.shape, dtype=torch.bool, device=dev)
        else:
            det = lm_opt.adamw_determined([v1[path].to(dev), v2[path].to(dev)], (1, 2), cfg)
        # masked sums, not det's indices (8 bytes a dim an element)
        sq = torch.where(det, (p.to(dev) - start[path].to(dev)).double() ** 2, 0.0).sum()
        n = int(det.sum())
        out[path] = {"det": _pack_bits(det), "aside": int(det.numel() - n),
                     "move": float((sq / n).sqrt()) if n else 0.0}
        del det, sq
    return out


def _block(t):
    """This rank's block of ``t`` (a plain tensor), its index into the
    whole tensor, and whether this rank counts it in sums: of the ranks
    that hold the same block (a mesh dim the tensor is replicated over),
    the one at coordinate 0."""
    if not PT.is_sharded(t):
        return t, tuple(slice(None) for _ in t.shape), True
    dm, places = t.device_mesh, t.placements
    coord = dm.get_coordinate()
    counts = all(coord[m] == 0 for m, pl in enumerate(places) if not pl.is_shard())
    return t.to_local(), PT.local_slices(t.shape, dm, places), counts


def _all_reduce(rows: list, op: str) -> list:
    """Per-leaf statistics of every rank's blocks, reduced over the ranks
    (``op`` "max" or "sum"; a small host collective)."""
    import torch.distributed as dist

    t = torch.tensor(rows, dtype=torch.float64)
    if dist.is_initialized():
        if dist.get_backend() == "nccl":   # NCCL reduces device tensors only
            t = t.to(torch.device("cuda", torch.cuda.current_device()))
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM)
    return t.tolist()


def _hold_params(state, ref, what: str, hold_aside: bool = True) -> dict:
    """Each rank holds its block of every param to the same block of the
    one-process card step (nothing gathered; the statistics reduced over
    the ranks) at lm_train's tolerances: every element within
    LM_TRAIN_PARAM_LR lr, and the RMS difference over the elements the
    one-process run's AdamW state determines (``ref["rule"]``,
    :func:`lm_rule`) within LM_TRAIN_PARAM_RMS of their RMS move. With
    ``hold_aside`` false the max over the elements the rule sets aside is
    printed, not held: they are held by :func:`_hold_aside`. Returns the
    worst of each, the count set aside and their largest difference in
    lr."""
    lr = LM_HOLD_OPT["lr"]
    paths, maxes, sums = [], [], []
    for path, p in lm_tree_flatten(state["params"]):
        block, idx, counts = _block(p)
        d = (block - ref["end"][path][idx].to(block.device)).abs()
        det = _unpack_bits(ref["rule"][path]["det"], p.shape, block.device)[idx]
        # masked, not indexed: det's indices would take 8 bytes a dim an element
        maxes.append([float(torch.where(det, d, 0.0).max()) if d.numel() else 0.0,
                      float(torch.where(det, 0.0, d).max()) if d.numel() else 0.0])
        sums.append([float(torch.where(det, d.double() ** 2, 0.0).sum()) if counts else 0.0,
                     float(det.sum()) if counts else 0.0])
        paths.append(path)
        del block, d, det
    maxes, sums = _all_reduce(maxes, "max"), _all_reduce(sums, "sum")
    worst_max, worst_rms, worst_leaf, bad = 0.0, 0.0, None, []
    n_aside, aside_max = 0, 0.0
    for path, (kmax, amax), (sq, n) in zip(paths, maxes, sums):
        rule = ref["rule"][path]
        moved, drms = rule["move"], (sq / n) ** 0.5 if n else 0.0
        dmax = max(kmax, amax) if hold_aside else kmax
        n_aside += rule["aside"]
        aside_max = max(aside_max, amax / lr)
        worst_max = max(worst_max, dmax / lr)
        if drms / max(moved, 1e-30) >= worst_rms:
            worst_rms, worst_leaf = drms / max(moved, 1e-30), "/".join(path)
        if dmax > LM_TRAIN_PARAM_LR * lr or drms > LM_TRAIN_PARAM_RMS * moved:
            bad.append(f"{path}: max {dmax:.3g}, RMS {drms:.3g} of a {moved:.3g} move "
                       f"over the determined elements")
    if bad:
        raise AssertionError(f"lm_mesh {what}: params differ from one process: {bad}")
    return {"param_max_diff_in_lr": worst_max, "param_rms_diff_of_move": worst_rms,
            "worst_rms_leaf": worst_leaf, "set_aside": n_aside, "set_aside_max_lr": aside_max}


def _host_blocks(tree) -> dict:
    """``{path: host copy of this rank's block}`` of a tree's leaves."""
    return {p: PT.local(t).detach().to("cpu", copy=True) for p, t in lm_tree_flatten(tree)}


def _gather_main(tree, main: bool) -> dict:
    """``{path: whole host copy}`` of a tree's leaves on rank 0 (empty on the
    others): each leaf gathered in turn (a collective on every rank)."""
    out = {}
    for path, t in lm_tree_flatten(tree):
        whole = PT.gather_tensor(t)
        if main:
            out[path] = whole.detach().to("cpu", copy=True)
        del whole
    return out


def _hold_aside(state, mine1: dict, ref, what: str) -> dict:
    """Every element the rule sets aside (``ref["rule"]``), held on each
    rank's blocks by ``optimizer.adamw_step_bound`` at LM_MESH_ULPS: after
    step 1 from the common draw, on both runs' params, m and v after it
    (the meshed run's in ``mine1``, ``{"params", "m", "v"}`` of this rank's
    host blocks; the one-process run's in ``ref["forced"]``), and after
    step 2 from step 1's difference, on both runs' after it (the meshed
    ``state``; ``ref["end"]``, ``m2``, ``v2``). Returns the count held and
    the largest share of its bound at each step."""
    cfg = lm_opt.OptConfig(**LM_HOLD_OPT)
    f = ref["forced"]
    m2 = dict(lm_tree_flatten(state["opt"]["m"]))
    v2 = dict(lm_tree_flatten(state["opt"]["v"]))
    paths, shares, counts = [], [], []
    for path, p in lm_tree_flatten(state["params"]):
        block, idx, counted = _block(p)
        dev = block.device
        aside = ~_unpack_bits(ref["rule"][path]["det"], p.shape, dev)[idx]
        one = {k: f[k][path][idx].to(dev)[aside] for k in ("p1", "m1", "v1", "m2", "v2")}
        one["p2"] = ref["end"][path][idx].to(dev)[aside]
        mine = {f"{k}1": mine1[k][path].to(dev)[aside] for k in ("params", "m", "v")}
        mine.update(p1=mine.pop("params1"), p2=block[aside], m2=PT.local(m2[path])[aside],
                    v2=PT.local(v2[path])[aside])
        row, bad = [0.0, 0.0], 0
        if aside.any():
            d1 = (one["p1"].double() - mine["p1"].double()).abs()
            b1 = lm_opt.adamw_step_bound(torch.zeros_like(d1), (one["p1"], mine["p1"]),
                                         (one["m1"], mine["m1"]), (one["v1"], mine["v1"]), 1,
                                         cfg, LM_MESH_ULPS)
            d2 = (one["p2"].double() - mine["p2"].double()).abs()
            b2 = lm_opt.adamw_step_bound(d1, (one["p2"], mine["p2"]), (one["m2"], mine["m2"]),
                                         (one["v2"], mine["v2"]), 2, cfg, LM_MESH_ULPS)
            row = [float((d1 / b1).max()), float((d2 / b2).max())]
            bad = int((d1 > b1).sum() + (d2 > b2).sum())
            del d1, b1, d2, b2
        paths.append(path)
        shares.append(row)
        counts.append([float(aside.sum()) if counted else 0.0, float(bad)])
        del one, mine, aside, block
    shares, counts = _all_reduce(shares, "max"), _all_reduce(counts, "sum")
    worst, n, bad = [0.0, 0.0], 0, []
    for path, row, (k, b) in zip(paths, shares, counts):
        worst = [max(a, c) for a, c in zip(worst, row)]
        n += int(k)
        if b:
            bad.append(f"{path}: {int(b)} element-steps past the bound (largest share "
                       f"{max(row):.3g})")
    if bad:
        raise AssertionError(f"lm_mesh {what}: set-aside params moved past AdamW's bound: "
                             f"{bad[:8]}")
    return {"aside_held": n, "aside_bound_share": worst}


def _hold_own_step(cfg, mesh, p1: dict, batch, met: dict, kv_chunk: int, what: str) -> dict:
    """The meshed step 2 evaluated from its own inputs: rank 0 takes the
    one-process loss and grads at the meshed params after step 1 (``p1``,
    its whole host copies; the other ranks wait) on its card, and every
    rank holds the meshed step 2's own loss and grad norm (``met``) to them
    within LM_TRAIN_METRIC_REL."""
    dev, vals = mesh.device, [0.0, 0.0, 0.0]
    if mesh.is_main:
        params = lm_tree_unflatten({p: t.to(dev) for p, t in p1.items()})
        loss_fn = lm_ts.make_loss_fn(cfg, lm_ts.TrainConfig(kv_chunk=kv_chunk))
        loss, aux, g = lm_ts.value_and_grad(loss_fn, params, lm_ts.device_batch(batch, dev))
        vals = [float(aux["loss"]), float(loss), float(lm_opt.global_norm(g))]
        del params, g, loss, aux
        _free()
    vals = mesh.broadcast_floats(vals)
    rel = {}
    for k, w in zip(("loss", "loss_total", "grad_norm"), vals):
        rel[k] = abs(met[k] - w) / abs(w)
        if not abs(met[k] - w) <= LM_TRAIN_METRIC_REL * abs(w):
            raise AssertionError(f"lm_mesh {what} step 2: its own {k} {met[k]} vs one process "
                                 f"at its params after step 1 {w}")
    return {"own_step2_rel": rel}


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance of two float32 tensors' elements on the
    ordered float32 line (the CPU tests' ``ulps``)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def _sharded_from(src, shardings, dev) -> dict:
    """The tree of ``shardings`` (a tree of ``NamedSharding``), each leaf
    this rank's block of the whole tensor ``src[path]`` (host or device) as
    a DTensor on ``dev``; leaf by leaf, in the tree's order on every rank."""
    return lm_tree_unflatten({
        path: PT.shard_tensor(src[path], sh, dev)
        for path, sh in lm_tree_flatten(shardings, lambda x: isinstance(x, PT.NamedSharding))})


def _hold_forced(cfg, mesh, ref, what: str, opt_cfg=None) -> dict:
    """The optimizer update on the ranks, on DTensors placed by
    ``state_shardings`` (each rank reads its own blocks of the inputs and
    outputs), fed the one-process run's params and moments after its step
    1, its step-2 grads and its step-2 clip scale (the grads scaled by it,
    the update's own clip off, so the float32 norms' sum orders cannot move
    the scale): under AdamW, params, m and v within LM_MESH_ULPS float32
    ulps of its step 2 on every element, the eps-level ones included; under
    Adafactor (``opt_cfg``), params, vr and vc within LM_MESH_ADAFACTOR of
    each leaf's largest (their ulps printed); the meshed norm of the raw
    grads within LM_TRAIN_METRIC_REL of the one-process norm."""
    f = ref["forced"]
    opt_cfg = opt_cfg or lm_opt.OptConfig(**LM_HOLD_OPT)
    moments = ("m", "v") if opt_cfg.name == "adamw" else ("vr", "vc")
    sh = lm_ts.state_shardings(cfg, opt_cfg, mesh)
    dev = mesh.device
    params, grads = _sharded_from(f["p1"], sh["params"], dev), _sharded_from(f["g2"], sh["params"], dev)
    opt = {k: _sharded_from(f[f"{k}1"], sh["opt"][k], dev) for k in moments}
    opt["count"] = torch.ones((), dtype=torch.int32)
    norm = float(lm_opt.global_norm(grads))
    want_norm = ref["metrics"][1]["grad_norm"]
    if not abs(norm - want_norm) <= LM_TRAIN_METRIC_REL * want_norm:
        raise AssertionError(f"lm_mesh {what}: meshed step-2 grad norm {norm} vs {want_norm}")
    for _, g in lm_tree_flatten(grads):
        PT.local(g).mul_(f["scale"])
    lm_opt.opt_update(grads, opt, params, dataclasses.replace(opt_cfg, clip_norm=math.inf))
    del grads
    rows, stats = [], []
    for what_, tree, want in (("params", params, ref["end"]),
                              *((k, opt[k], f[f"{k}2"]) for k in moments)):
        for path, t in lm_tree_flatten(tree):
            block, idx, _ = _block(t)
            w = want[path][idx].to(dev)
            rows.append((what_, path))
            stats.append([_ulps(block, w), float((block - w).abs().max()) if w.numel() else 0.0,
                          float(w.abs().max()) if w.numel() else 0.0])
            del w
    del params, opt
    stats = _all_reduce(stats, "max")
    worst, bad = {k: 0 for k in ("params", *moments)}, []
    worst_rel = dict.fromkeys(worst, 0.0)
    for (what_, path), (u, diff, top) in zip(rows, stats):
        worst[what_] = max(worst[what_], int(u))
        worst_rel[what_] = max(worst_rel[what_], diff / max(top, 1e-30))
        if (u > LM_MESH_ULPS if opt_cfg.name == "adamw"
                else diff > LM_MESH_ADAFACTOR * top):
            bad.append(f"{what_} {path}: {int(u)} ulps, {diff:.3g} of {top:.3g}")
    if bad:
        raise AssertionError(f"lm_mesh {what}: the meshed {opt_cfg.name} update on the "
                             f"one-process inputs differs: {bad[:8]}")
    return {"forced_ulps": worst, "forced_err_of_max": worst_rel,
            "forced_norm_equal": norm == want_norm}


def _mesh_serve(cfg, mesh, params, n_cache: int, prompt, extras: dict, want: dict,
                kv_chunk: int, what: str):
    """A sharded prefill of ``prompt`` (after any prefix embeds) into a
    float32 cache of ``n_cache`` positions and decode ticks fed the
    one-process greedy tokens ``want["next"]``; every step's logits held to
    ``want["logits"]`` within LM_MESH_LOGITS of the largest |logit|, the
    greedy token outside near ties. Returns the numbers and the cache."""
    dev, prof = mesh.device, PT.RunProfile()
    B = prompt.shape[0]
    meta = lm_model.init_cache(cfg, B, n_cache, torch.float32, "meta")
    cache = PT.shard_tree(lm_model.init_cache(cfg, B, n_cache, torch.float32, dev),
                          lm_ts.cache_shardings(cfg, meta, mesh, prof))
    prefill, decode = lm_ts.make_serve_steps(cfg, kv_chunk=kv_chunk, mesh=mesh, prof=prof)
    extras = {k: v.to(dev) for k, v in extras.items()}
    start = prompt.shape[1] + (extras["embeds"].shape[1] if "embeds" in extras else 0)
    errs, ties, argmax_ok, ms = [], 0, True, []
    with torch.no_grad():
        for t in range(len(want["logits"])):
            _sync(dev)
            t0 = time.perf_counter()
            if t == 0:
                lg, _ = prefill(params, prompt.to(dev), cache, **extras)
            else:
                lg, _ = decode(params, want["next"][t - 1].to(dev), start + t - 1, cache)
            lg = PT.gather_tensor(lg)
            _sync(dev)
            ms.append(1e3 * (time.perf_counter() - t0))
            ref = want["logits"][t].to(dev)
            top = float(ref.abs().max())
            err = float((lg - ref).abs().max())
            errs.append(err / top)
            if err > LM_MESH_LOGITS * top:
                raise AssertionError(f"lm_mesh {what} tick {t}: logits {err:.3g} of {top:.3g}")
            two = ref.topk(2, dim=-1).values
            clear = (two[:, 0] - two[:, 1]) > 2 * LM_MESH_LOGITS * top
            ties += int((~clear).sum())
            if not bool((lg.argmax(-1) == ref.argmax(-1))[clear].all()):
                argmax_ok = False
    if not argmax_ok:
        raise AssertionError(f"lm_mesh {what}: a greedy token differs outside near ties")
    return {"logit_err_of_max": errs, "near_ties": ties, "prefill_ms": ms[0],
            "decode_tick_ms": ms[1:]}, cache


def _lm_mesh_serve(mesh, cfg, ref, dev) -> dict:
    """The one-process run's end params sharded, a sharded prefill of the
    prompt into a float32 cache and LM_MESH_TICKS decode ticks fed the
    one-process greedy tokens; logits held to the one-process ones."""
    params = PT.shard_tree(ref["end_tree"], lm_ts.param_shardings(cfg, mesh), dev)
    res, _ = _mesh_serve(cfg, mesh, params, LM_MESH_CACHE, ref["prompt"], {}, ref, 128, "serve")
    return res


def _family_serve_inputs(cfg, arch: str) -> tuple:
    """The family's seeded prompt and extras (frames or embeds), host."""
    S = LM_MESH_SERVE_PROMPT.get(arch, 13)
    prompt = torch.randint(0, cfg.vocab_size, (LM_MESH_FAMILY_B, S), generator=_gen(14))
    return prompt, lm_extras(cfg, LM_MESH_FAMILY_B, seed=31)


def lm_mesh_family_serve_reference(dev) -> dict:
    """One process on the card: each of LM_MESH_SERVE_FAMILIES' smoke
    configs (f32, routing groups tuned to each of LM_MESH_FACTORS) drawn
    from PRNGKey(0), its prompt prefilled into a float32 cache and
    LM_MESH_SERVE_TICKS greedy ticks: logits, greedy tokens, every cache
    leaf after the last tick, prefill and tick ms; by arch and mesh."""
    out = {}
    for arch in LM_MESH_SERVE_FAMILIES:
        runs = []   # (config, its run): meshes that tune a config alike share a run
        for d, m in LM_MESH_FACTORS:
            cfg = _family_cfg(arch, {"data": d, "model": m})
            same = [r for c, r in runs if c == cfg]
            if same:
                out[f"{arch}@{d}x{m}"] = same[0]
                continue
            params = lm_model.init_params(cfg, t_random.PRNGKey(0), dev)
            prompt, extras = _family_serve_inputs(cfg, arch)
            out[f"{arch}@{d}x{m}"] = lm_serve_run(cfg, params, prompt, extras,
                                                  LM_MESH_SERVE_CACHE, LM_MESH_SERVE_TICKS, 8,
                                                  dev)
            runs.append((cfg, out[f"{arch}@{d}x{m}"]))
            del params
    return out


def lm_serve_run(cfg, params, prompt, extras: dict, n_cache: int, ticks: int, kv_chunk: int,
                 dev) -> dict:
    """One process: ``prompt`` (after any embeds prefix, with any frames)
    prefilled into a float32 cache of ``n_cache`` positions and ``ticks``
    greedy ticks: logits, greedy tokens, every cache leaf after the last
    tick (host), prefill and tick ms."""
    extras = {k: v.to(dev) for k, v in extras.items()}
    start = prompt.shape[1] + (extras["embeds"].shape[1] if "embeds" in extras else 0)
    cache = lm_model.init_cache(cfg, prompt.shape[0], n_cache, torch.float32, dev)
    prefill, decode = lm_ts.make_serve_steps(cfg, kv_chunk=kv_chunk)
    logits, nxt, ms = [], [], []
    with torch.no_grad():
        for t in range(ticks + 1):
            _sync(dev)
            t0 = time.perf_counter()
            if t == 0:
                lg, _ = prefill(params, prompt.to(dev), cache, **extras)
            else:
                lg, _ = decode(params, nxt[-1].to(dev), start + t - 1, cache)
            _sync(dev)
            ms.append(1e3 * (time.perf_counter() - t0))
            logits.append(lg.cpu())
            nxt.append(lg.argmax(-1).cpu())
    return {"logits": logits, "next": nxt[:ticks],
            "cache": [(p, t.to("cpu", copy=True)) for p, t in lm_tree_flatten(cache)],
            "prefill_ms": ms[0], "decode_tick_ms": ms[1:]}


def _hold_cache(cache, want: list, main: bool, what: str) -> dict:
    """Every cache leaf gathered (a collective); rank 0 holds each to the
    one-process card cache within LM_MESH_CACHE_HOLD of the leaf's largest
    |value|: the families' states, windows and latent, ring and cross
    caches, which the logits of a few ticks need not show."""
    worst, worst_leaf, bad = 0.0, None, []
    got = lm_tree_flatten(cache)
    if [p for p, _ in got] != [p for p, _ in want]:
        raise AssertionError(f"lm_mesh {what}: the cache's leaves differ from one process")
    for (path, c), (_, w) in zip(got, want):
        whole = PT.gather_tensor(c)
        if main:
            w = w.to(whole.device)
            if whole.shape != w.shape or whole.dtype != w.dtype:
                raise AssertionError(f"lm_mesh {what}: cache leaf {path} is {whole.dtype} "
                                     f"{tuple(whole.shape)}, one process {w.dtype} {tuple(w.shape)}")
            top = float(w.abs().max())
            err = float((whole - w).abs().max())
            if err / max(top, 1e-30) >= worst:
                worst, worst_leaf = err / max(top, 1e-30), "/".join(map(str, path))
            if err > LM_MESH_CACHE_HOLD * top:
                bad.append(f"{path}: {err:.3g} of {top:.3g}")
        del whole
    if bad:
        raise AssertionError(f"lm_mesh {what}: cache leaves differ from one process: {bad}")
    return {"cache_err_of_max": worst, "worst_cache_leaf": worst_leaf}


def _lm_mesh_family_serve(mesh, ref: dict, main: bool) -> dict:
    """LM_MESH_SERVE_FAMILIES on this mesh: the smoke params (f32,
    PRNGKey(0)) sharded, the prompt and extras prefilled sharded and
    LM_MESH_SERVE_TICKS ticks fed the one-process greedy tokens
    (:func:`_mesh_serve`); then every cache leaf held (:func:`_hold_cache`)."""
    shape = PT.mesh_shape(mesh)
    f = f"{shape['data']}x{shape['model']}"
    out = {}
    for arch in LM_MESH_SERVE_FAMILIES:
        t0 = time.perf_counter()
        what = f"{f} {arch} serve"
        cfg = _family_cfg(arch, mesh)
        want = ref[f"{arch}@{f}"]
        params = PT.shard_tree(lm_model.init_params(cfg, t_random.PRNGKey(0), mesh.device),
                               lm_ts.param_shardings(cfg, mesh))
        prompt, extras = _family_serve_inputs(cfg, arch)
        res, cache = _mesh_serve(cfg, mesh, params, LM_MESH_SERVE_CACHE, prompt, extras, want,
                                 8, what)
        res.update(_hold_cache(cache, want["cache"], main, what))
        res["seconds"] = time.perf_counter() - t0
        out[arch] = res
        del params, cache
    return out


def _lm_mesh_probe_serve(mesh) -> dict:
    """The collective probe's prefill cell of LM_MESH_PROBE_SERVE's archs
    (smoke, f32, the reference's specs' inputs: whisper's frames, the
    VLM's prefix embeds and its cache of S + frontend_len) at 2x2, and the
    meshed serve's prefill of the same params on the same inputs: equal
    logits. Returns the probe's lines."""
    from repro_torch.configs import cell_by_name
    from repro_torch.launch import collective_probe as t_probe

    out = {}
    for arch in LM_MESH_PROBE_SERVE:
        args = t_probe.parse_args([
            "--arch", arch, "--cell", "prefill_32k", "--smoke", "--repeat", "2",
            "--mesh", "2x2", "--backend", "gloo", "--batch", str(LM_MESH_FAMILY_B),
            "--seq", str(LM_MESH_FAMILY_S), "--dtype", "float32", "--kv-chunk", "8", "--top", "4"])
        probe = t_probe.probe_lm(args, mesh=mesh)
        cfg = _family_cfg(arch, mesh)
        inputs = t_probe.serve_inputs(cfg, cell_by_name("prefill_32k"), LM_MESH_FAMILY_B,
                                      LM_MESH_FAMILY_S, mesh.device)
        cache = inputs.pop("cache")
        cache = PT.shard_tree(cache, lm_ts.cache_shardings(cfg, cache, mesh))
        params = PT.shard_tree(lm_model.init_params(cfg, t_random.PRNGKey(0), mesh.device),
                               lm_ts.param_shardings(cfg, mesh))
        prefill, _ = lm_ts.make_serve_steps(cfg, kv_chunk=8, mesh=mesh)
        with torch.no_grad():
            lg = PT.gather_tensor(prefill(params, cache=cache, **inputs)[0])
        if not torch.equal(probe["result"], lg):
            raise AssertionError(f"lm_mesh probe {arch} prefill: logits differ from the meshed "
                                 f"serve's on the same inputs by "
                                 f"{float((probe['result'] - lg).abs().max()):.3g}")
        out[arch] = probe["lines"]
        del params, cache
    return out


def _lm_mesh_pipeline(dev) -> dict:
    """``pipeline_apply`` over the 4 ranks as stages on the card (R = 8,
    B = 16, D = 32, 4 microbatches): the output and each stage's grads
    against the same layers run one after another on this rank's card."""
    from repro_torch.sharding.pipeline import pipeline_apply

    g = torch.Generator().manual_seed(7)
    w = (0.3 * torch.randn(8, 32, 32, generator=g)).to(dev)
    b = (0.01 * torch.randn(8, 32, generator=g)).to(dev)
    x = torch.randn(16, 32, generator=g).to(dev)
    s = torch.distributed.get_rank()
    lp = {"w": w[2 * s:2 * s + 2].clone().requires_grad_(),
          "b": b[2 * s:2 * s + 2].clone().requires_grad_()}

    def layer(pr, h):
        return torch.tanh(h @ pr["w"] + pr["b"])

    out = pipeline_apply(layer, lp, x, None, 4)
    (out ** 2).sum().backward()
    sp = {"w": w.clone().requires_grad_(), "b": b.clone().requires_grad_()}
    h = x
    for r in range(8):
        h = layer({k: v[r] for k, v in sp.items()}, h)
    (h ** 2).sum().backward()
    out, h = out.detach(), h.detach()
    err = {"out": float((out - h).abs().max())}
    for k in ("w", "b"):
        err[f"grad_{k}"] = float((lp[k].grad - sp[k].grad[2 * s:2 * s + 2]).abs().max())
    if err["out"] > 2e-5 * max(float(h.abs().max()), 1.0) or max(
            err[f"grad_{k}"] / max(float(sp[k].grad.abs().max()), 1e-30) for k in ("w", "b")) > 2e-5:
        raise AssertionError(f"lm_mesh pipeline: card vs its sequential form {err}")
    return err


def _family_cfg(arch, mesh_shape):
    return PT.tuned_config(dataclasses.replace(lm_smoke_config(arch), dtype="float32"),
                           mesh_shape)


def _family_batches(cfg):
    """Two token-stream batches with the family's seeded extras (frames or
    embeds), host numpy."""
    extras = {k: v.numpy() for k, v in lm_extras(cfg, LM_MESH_FAMILY_B, seed=31).items()}
    stream = TokenStream(cfg.vocab_size, LM_MESH_FAMILY_B, LM_MESH_FAMILY_S, seed=0)
    return [dict(stream.batch_at(i), **extras) for i in range(2)]


def _host(tree) -> dict:
    """``{path: host copy}`` of a tree's leaves."""
    return {p: t.detach().to("cpu", copy=True) for p, t in lm_tree_flatten(tree)}


def lm_mesh_family_reference(dev) -> dict:
    """One process on the card: each of LM_MESH_FAMILIES' smoke configs (f32,
    routing groups tuned to 2x2) drawn from PRNGKey(0) and trained two AdamW
    steps, the second by hand (the train step's own body) to keep its
    grads; per-step metrics, the step-1 grads at the start, end params,
    the set-aside rule (:func:`lm_rule`), and the optimizer's inputs and
    outputs at step 2 for :func:`_hold_forced`."""
    out = {}
    for arch in LM_MESH_FAMILIES:
        cfg = _family_cfg(arch, {"data": 2, "model": 2})
        opt_cfg = lm_opt.OptConfig(**LM_HOLD_OPT)
        tc = lm_ts.TrainConfig(kv_chunk=8)
        state = lm_ts.init_state(cfg, opt_cfg, t_random.PRNGKey(0), dev)
        start = _host(state["params"])
        step = lm_ts.make_train_step(cfg, opt_cfg, tc)
        loss_fn = lm_ts.make_loss_fn(cfg, tc)
        batches = _family_batches(cfg)
        _, _, g = lm_ts.value_and_grad(loss_fn, state["params"],
                                       lm_ts.device_batch(batches[0], dev))
        grads = _host(g)
        del g
        state, met = step(state, batches[0])
        metrics = [{k: float(v) for k, v in met.items()}]
        forced = {"p1": _host(state["params"]), "m1": _host(state["opt"]["m"]),
                  "v1": _host(state["opt"]["v"])}
        loss, aux, g = lm_ts.value_and_grad(loss_fn, state["params"],
                                            lm_ts.device_batch(batches[1], dev))
        forced["g2"] = _host(g)
        _, _, gnorm = lm_opt.opt_update(g, state["opt"], state["params"], opt_cfg)
        state["step"].add_(1)
        del g
        forced.update(scale=lm_opt.clip_scale(gnorm, opt_cfg.clip_norm), m2=_host(state["opt"]["m"]),
                      v2=_host(state["opt"]["v"]))
        metrics.append({"loss": float(aux["loss"]), "loss_total": float(loss),
                        "grad_norm": float(gnorm)})
        end = _host(state["params"])
        out[arch] = {"end": end, "metrics": metrics, "grads": grads, "forced": forced,
                     "rule": lm_rule(start, forced["v1"], end, forced["v2"], dev)}
        del state, step
        _free()
    return out


def _hold_grads(grads, want: dict, what: str) -> dict:
    """Each rank holds its block of every grad leaf to the same block of
    the one-process card grads (nothing gathered; the statistics reduced
    over the ranks): within LM_MESH_GRAD of the leaf's largest |grad|, the
    grads' placement, before AdamW divides them by their own size."""
    paths, rows = [], []
    for path, g in lm_tree_flatten(grads):
        block, idx, _ = _block(g)
        w = want[path][idx].to(block.device)
        rows.append([float((block - w).abs().max()), float(w.abs().max())])
        paths.append(path)
        del block, w
    worst, worst_leaf, bad = 0.0, None, []
    for path, (diff, top) in zip(paths, _all_reduce(rows, "max")):
        err = diff / max(top, 1e-30)
        if err >= worst:
            worst, worst_leaf = err, "/".join(path)
        if err > LM_MESH_GRAD:
            bad.append(f"{path}: {err:.3g} of the largest |grad|")
    if bad:
        raise AssertionError(f"lm_mesh {what}: step-1 grads differ from one process: {bad}")
    return {"grad_err_of_max": worst, "worst_grad_leaf": worst_leaf}


def _lm_mesh_families(mesh, ref) -> dict:
    """LM_MESH_FAMILIES at 2x2: the sharded draw and two AdamW steps of each
    family's smoke config with its extras, per-step metrics and end params
    held to the one-process card run at lm_train's tolerances, and
    the step-1 grads at the start to its grads within LM_MESH_GRAD."""
    out = {}
    for arch in LM_MESH_FAMILIES:
        t0 = time.perf_counter()
        cfg = _family_cfg(arch, mesh)
        opt_cfg = lm_opt.OptConfig(**LM_HOLD_OPT)
        state = lm_ts.init_state(cfg, opt_cfg, t_random.PRNGKey(0), mesh.device,
                                 lm_ts.state_shardings(cfg, opt_cfg, mesh))
        step = lm_ts.make_train_step(cfg, opt_cfg, lm_ts.TrainConfig(kv_chunk=8), mesh=mesh)
        batches, prof = _family_batches(cfg), PT.RunProfile()
        with use_partitioning(PT.device_mesh(mesh), PT.act_rules(mesh, prof)):
            b = lm_ts.shard_batch(lm_ts.device_batch(batches[0], mesh.device), mesh, prof)
            _, _, g = lm_ts.value_and_grad(
                lm_ts.make_loss_fn(cfg, lm_ts.TrainConfig(kv_chunk=8)), state["params"], b)
        res = {"steps": [], "step_ms": [], **_hold_grads(g, ref[arch]["grads"], f"2x2 {arch}")}
        del g
        for i, b in enumerate(batches):
            state, met, ms = _timed_step(step, state, b)
            res["steps"].append(met)
            res["step_ms"].append(ms)
            for k in ("loss", "loss_total", "grad_norm"):
                a, w = met[k], ref[arch]["metrics"][i][k]
                if not abs(a - w) <= LM_TRAIN_METRIC_REL * abs(w):
                    raise AssertionError(f"lm_mesh 2x2 {arch} step {i + 1}: {k} {a} vs {w}")
        res.update(_hold_params(state, ref[arch], f"2x2 {arch}"))
        del state, step
        _free()
        res.update(_hold_forced(cfg, mesh, ref[arch], f"2x2 {arch}"))
        res["seconds"] = time.perf_counter() - t0
        out[arch] = res
        _free()
    return out


def _hybrid_cfg(mesh=None):
    """zamba2-7b at full width cut to one layout unit and the tail, f32."""
    cfg = dataclasses.replace(get_lm_config("zamba2-7b"), n_layers=LM_MESH_HYBRID_LAYERS,
                              layout_repeat=1, dtype="float32")
    return PT.tuned_config(cfg, mesh) if mesh is not None else cfg


def lm_mesh_hybrid_reference(dev) -> dict:
    """One process on the card: :func:`_hybrid_cfg` drawn from PRNGKey(0)
    and trained two AdamW steps at LM_MESH_B x LM_MESH_S, the second by
    hand (the train step's own body) to keep its grads; per-step metrics
    and ms, the draw's seconds, the peak, end params, the set-aside rule
    (:func:`lm_rule`), and the optimizer's inputs and outputs at step 2
    (for :func:`_hold_forced`; the params after step 1 and the step-2
    grads also for the grads' hold)."""
    cfg = _hybrid_cfg(PT.mesh_shape({"data": 2, "model": 2}))
    opt_cfg = lm_opt.OptConfig(**LM_HOLD_OPT)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = lm_ts.init_state(cfg, opt_cfg, t_random.PRNGKey(0), dev)
    torch.cuda.synchronize()
    out = {"params": lm_model.param_count(cfg), "draw_s": time.perf_counter() - t0,
           "metrics": [], "step_ms": []}
    start = _host(state["params"])
    tc = lm_ts.TrainConfig(kv_chunk=128)
    step, loss_fn = lm_ts.make_train_step(cfg, opt_cfg, tc), lm_ts.make_loss_fn(cfg, tc)
    stream = TokenStream(cfg.vocab_size, LM_MESH_B, LM_MESH_S, seed=0)
    state, met, ms = _timed_step(step, state, stream.batch_at(0))
    out["metrics"].append(met)
    out["step_ms"].append(ms)
    forced = {"p1": _host(state["params"]), "m1": _host(state["opt"]["m"]),
              "v1": _host(state["opt"]["v"])}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, aux, g = lm_ts.value_and_grad(loss_fn, state["params"],
                                        lm_ts.device_batch(stream.batch_at(1), dev))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    forced["g2"] = _host(g)
    t2 = time.perf_counter()
    _, _, gnorm = lm_opt.opt_update(g, state["opt"], state["params"], opt_cfg)
    state["step"].add_(1)
    del g
    torch.cuda.synchronize()
    out["step_ms"].append(1e3 * (time.perf_counter() - t2 + t1 - t0))
    out["metrics"].append({"loss": float(aux["loss"]), "loss_total": float(loss),
                           "grad_norm": float(gnorm)})
    forced.update(scale=lm_opt.clip_scale(gnorm, opt_cfg.clip_norm),
                  m2=_host(state["opt"]["m"]), v2=_host(state["opt"]["v"]))
    out["end"], out["forced"] = _host(state["params"]), forced
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
    del state, step
    _free()
    out["rule"] = lm_rule(start, forced["v1"], out["end"], forced["v2"], dev)
    return out


def _lm_mesh_hybrid(mesh, ref: dict, main: bool) -> dict:
    """:func:`_hybrid_cfg` at 2x2: the sharded draw and two AdamW steps held
    to the one-process card run: step 1's metrics and step 2's loss within
    LM_TRAIN_METRIC_REL; the params after step 2 under :func:`_hold_params`
    over the elements the rule determines, and every element it sets aside
    under :func:`_hold_aside` (AdamW's own bound on both runs' steps); the
    meshed step 2 from its own inputs (:func:`_hold_own_step`: its own grad
    norm to one process's at the meshed params after step 1); the step-2
    grads taken at the one-process params after step 1 within LM_MESH_GRAD
    of each leaf's largest and their norm within LM_TRAIN_METRIC_REL of its
    step-2 grad norm; the AdamW update on its step-2 inputs under
    :func:`_hold_forced`, on every element. Where AdamW's denominator is
    eps-level a rounding-level grad difference moves a param by up to lr /
    eps times it (0.82 lr apart on the H100), and the next step's grads
    with it: the whole trajectory is held step by step from each run's own
    inputs (ROADMAP Queue 3 item 17).
    Step ms (rank 0's step 2 traced), the draw's seconds, the peak."""
    t0 = time.perf_counter()
    cfg = _hybrid_cfg(mesh)
    opt_cfg = lm_opt.OptConfig(**LM_HOLD_OPT)
    dev = mesh.device
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state = lm_ts.init_state(cfg, opt_cfg, t_random.PRNGKey(0), dev,
                             lm_ts.state_shardings(cfg, opt_cfg, mesh))
    torch.cuda.synchronize()
    res = {"draw_s": time.perf_counter() - t0, "steps": [], "step_ms": []}
    step = lm_ts.make_train_step(cfg, opt_cfg, lm_ts.TrainConfig(kv_chunk=128), mesh=mesh)
    stream = TokenStream(cfg.vocab_size, LM_MESH_B, LM_MESH_S, seed=0)
    for i in range(2):
        if i == 1 and main:   # rank 0's step 2 traced: its wall is the step's ms
            box = {}
            res["trace"] = _trace_once(lambda: box.update(out=step(state, stream.batch_at(1))))
            state, met = box["out"]
            met, ms = {k: float(v) for k, v in met.items()}, res["trace"]["wall_ms"]
        else:
            state, met, ms = _timed_step(step, state, stream.batch_at(i))
        res["steps"].append(met)
        res["step_ms"].append(ms)
        for k in ("loss", "loss_total", "grad_norm")[:3 - i]:
            a, w = met[k], ref["metrics"][i][k]
            if not abs(a - w) <= LM_TRAIN_METRIC_REL * abs(w):
                raise AssertionError(f"lm_mesh 2x2 zamba2-7b full width step {i + 1}: "
                                     f"{k} {a} vs {w}")
        if i == 0:   # the meshed run's own step-2 inputs
            mine1 = {"params": _host_blocks(state["params"]), "m": _host_blocks(state["opt"]["m"]),
                     "v": _host_blocks(state["opt"]["v"])}
            p1 = _gather_main(state["params"], main)
    res["own_grad_norm_rel"] = (abs(res["steps"][1]["grad_norm"] - ref["metrics"][1]["grad_norm"])
                                / ref["metrics"][1]["grad_norm"])
    res["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
    what = "2x2 zamba2-7b full width"
    res.update(_hold_params(state, ref, what, hold_aside=False))
    res.update(_hold_aside(state, mine1, ref, what))
    del state, step, mine1
    _free()
    res.update(_hold_own_step(cfg, mesh, p1, stream.batch_at(1), res["steps"][1], 128, what))
    del p1
    p1 = PT.shard_tree(lm_tree_unflatten(ref["forced"]["p1"]), lm_ts.param_shardings(cfg, mesh),
                       dev)
    prof = PT.RunProfile()
    with use_partitioning(PT.device_mesh(mesh), PT.act_rules(mesh, prof)):
        b = lm_ts.shard_batch(lm_ts.device_batch(stream.batch_at(1), dev), mesh, prof)
        _, _, g = lm_ts.value_and_grad(
            lm_ts.make_loss_fn(cfg, lm_ts.TrainConfig(kv_chunk=128)), p1, b)
    del p1
    norm = float(lm_opt.global_norm(g))
    want = ref["metrics"][1]["grad_norm"]
    if not abs(norm - want) <= LM_TRAIN_METRIC_REL * want:
        raise AssertionError(f"lm_mesh 2x2 zamba2-7b full width: step-2 grad norm at the "
                             f"one-process params {norm} vs {want}")
    res.update(_hold_grads(g, ref["forced"]["g2"], "2x2 zamba2-7b full width, step 2 at the "
                                                   "one-process params"), forced_grad_norm=norm)
    del g
    _free()
    res.update(_hold_forced(cfg, mesh, ref, what))
    res["seconds"] = time.perf_counter() - t0
    _free()
    return res


LM_MESH_LAUNCH_HYBRID = ["--arch", "zamba2-7b", "--smoke", "--batch", "4", "--seq", "16",
                         "--steps", "1", "--mesh", "2x2", "--backend", "gloo"]


def _lm_mesh_launch_hybrid(main: bool) -> dict:
    """The train launcher on this rank with LM_MESH_LAUNCH_HYBRID (the
    process group exists, so its ``make_mesh_2d`` only builds the groups):
    it ends at step 1, and its checkpoint, restored in one process by rank
    0, equals the state it holds, leaf by leaf (gathered)."""
    d = os.path.join(LM_MESH_DIR, "launch_hybrid")
    t0 = time.perf_counter()
    prev = signal.getsignal(signal.SIGTERM)
    trainer = launch_train.main(LM_MESH_LAUNCH_HYBRID + ["--ckpt-dir", d])["trainer"]
    signal.signal(signal.SIGTERM, prev)   # the launcher's preemption handler
    if trainer.step != 1:
        raise AssertionError(f"lm_mesh: the meshed zamba2-7b launcher ended at {trainer.step}")
    gathered = {p: PT.gather_tensor(t).cpu().numpy() for p, t in lm_tree_flatten(trainer.state)}
    if main:
        ck = Checkpointer(d)
        if ck.all_steps() != [1]:
            raise AssertionError(f"lm_mesh: the meshed zamba2-7b launcher's checkpoints "
                                 f"{ck.all_steps()}")
        one = dict(lm_tree_flatten(ck.restore(1, lm_tree_unflatten(gathered))[0]))
        for p, a in gathered.items():
            if not np.array_equal(a, one[p]):
                raise AssertionError(f"lm_mesh: the meshed zamba2-7b launcher's checkpoint "
                                     f"leaf {p} differs from the state it holds")
    return {"step": trainer.step, "seconds": time.perf_counter() - t0}


def lm_mesh_ranks():
    """What each of the 4 ranks (gloo, sharing the card) runs: under 2x2
    and 1x4 the sharded draw, two AdamW steps held to the one-process card
    steps, one traced step, the sharded serve steps; under 2x2 also the
    sharded checkpoint (restored by rank 0 in one process and by each rank
    sharded),
    the collective probe's LM table and the 4-stage pipeline."""
    from repro_torch.launch import collective_probe as t_probe

    ref = torch.load(os.path.join(LM_MESH_DIR, "ref.pt"), mmap=True, weights_only=False)
    ref["end_tree"] = lm_tree_unflatten(ref["end"])
    out = {}
    for d, m in LM_MESH_FACTORS:
        mesh = make_mesh_2d(d, m, device="cuda", backend="gloo")
        dev, main = mesh.device, mesh.is_main
        res = {}
        cfg = _lm_mesh_cfg(mesh)
        opt_cfg = lm_opt.OptConfig(**LM_HOLD_OPT)
        sh = lm_ts.state_shardings(cfg, opt_cfg, mesh)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        state = lm_ts.init_state(cfg, opt_cfg, t_random.PRNGKey(0), dev, sh)
        torch.cuda.synchronize()
        res["draw_s"] = time.perf_counter() - t0
        step = lm_ts.make_train_step(cfg, opt_cfg, lm_ts.TrainConfig(kv_chunk=128), mesh=mesh)
        stream = TokenStream(cfg.vocab_size, LM_MESH_B, LM_MESH_S, seed=0)
        res["steps"], res["step_ms"] = [], []
        for i in range(2):
            state, met, ms = _timed_step(step, state, stream.batch_at(i))
            res["steps"].append(met)
            res["step_ms"].append(ms)
            for k in ("loss", "loss_total", "grad_norm"):
                a, b = met[k], ref["metrics"][i][k]
                if not abs(a - b) <= LM_TRAIN_METRIC_REL * abs(b):
                    raise AssertionError(f"lm_mesh {d}x{m} step {i + 1}: {k} {a} vs {b}")
        res.update(_hold_params(state, ref, f"{d}x{m}"))
        if (d, m) == (2, 2):
            ck = Checkpointer(os.path.join(LM_MESH_DIR, "ckpt_2x2"))
            t0 = time.perf_counter()
            ck.save(2, state, extra={"data_step": 2})
            res["ckpt_save_s"] = time.perf_counter() - t0
            # restored in one process (rank 0, no shardings) == the gathered state
            one = ck.restore(2, lm_abstract_state(cfg, opt_cfg))[0] if main else None
            flat_one = dict(lm_tree_flatten(one)) if main else {}
            for path, leaf in lm_tree_flatten(state):
                whole = PT.gather_tensor(leaf)
                if main and not np.array_equal(whole.cpu().numpy(), flat_one[path]):
                    raise AssertionError(f"lm_mesh 2x2: checkpoint leaf {path} restored in "
                                         f"one process differs from the gathered state")
                del whole
            del one, flat_one
            tree, _ = ck.restore(2, lm_tree_map(
                lambda t: LeafSpec(tuple(t.shape), np.dtype(str(t.dtype)[6:])), state), sh)
            res["restored_blocks_equal"] = all(
                torch.equal(PT.local(a), PT.local(b)) if PT.is_sharded(a)
                else np.array_equal(np.asarray(a), b.cpu().numpy())
                for (_, a), (_, b) in zip(lm_tree_flatten(tree), lm_tree_flatten(state)))
            if not res["restored_blocks_equal"]:
                raise AssertionError("lm_mesh 2x2: a rank's sharded restore differs")
            del tree
        batch = stream.batch_at(2)
        if main:
            res["trace"] = _trace_once(lambda: step(state, batch))
        else:
            step(state, batch)
            torch.cuda.synchronize()
        res["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
        if (d, m) == (2, 2):
            args = t_probe.parse_args(LM_MESH_PROBE)
            res["probe"] = t_probe.probe_lm(args, mesh=mesh, state=state)["lines"]
        del state, step
        _free()
        res["serve"] = _lm_mesh_serve(mesh, cfg, ref, dev)
        _free()
        res["family_serve"] = _lm_mesh_family_serve(mesh, ref["family_serve"], main)
        if (d, m) == (2, 2):
            res["probe_serve"] = _lm_mesh_probe_serve(mesh)
            res["pipeline"] = _lm_mesh_pipeline(dev)
            res["families"] = _lm_mesh_families(mesh, ref["families"])
            res["hybrid"] = _lm_mesh_hybrid(mesh, ref["hybrid"], main)
            res["launch_hybrid"] = _lm_mesh_launch_hybrid(main)
        out[f"{d}x{m}"] = res
    return out


def lm_mesh_phase(dev, smi: str) -> dict:
    """The one-process card reference (llama3.2-3b at full width cut to 2
    layers, f32: two AdamW steps at 4 x 128, one traced; then its end
    params served: a 64-token prefill and LM_MESH_TICKS greedy ticks) to
    a file; then the 4 gloo ranks (:func:`lm_mesh_ranks`)."""
    torch.empty(1, device=dev)
    shutil.rmtree(LM_MESH_DIR, ignore_errors=True)
    os.makedirs(LM_MESH_DIR)
    t_phase = time.perf_counter()
    cfg = _lm_mesh_cfg(PT.mesh_shape({"data": 2, "model": 2}))
    opt_cfg = lm_opt.OptConfig(**LM_HOLD_OPT)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state = lm_ts.init_state(cfg, opt_cfg, t_random.PRNGKey(0), dev)
    start = {p: t.detach().to("cpu", copy=True) for p, t in lm_tree_flatten(state["params"])}
    step = lm_ts.make_train_step(cfg, opt_cfg, lm_ts.TrainConfig(kv_chunk=128))
    stream = TokenStream(cfg.vocab_size, LM_MESH_B, LM_MESH_S, seed=0)
    metrics, one_ms = [], []
    for i in range(2):
        state, met, ms = _timed_step(step, state, stream.batch_at(i))
        metrics.append(met)
        one_ms.append(ms)
        if i == 0:
            v1 = _host(state["opt"]["v"])
    end, v2 = _host(state["params"]), _host(state["opt"]["v"])
    batch = stream.batch_at(2)
    one_trace = trace_cell_wave("lm_mesh one-process train step", lambda: step(state, batch),
                                repeats=1)
    one_peak = torch.cuda.max_memory_allocated(dev) - base
    del state, step
    _free()
    rule = lm_rule(start, v1, end, v2, dev)
    del start, v1, v2
    _free()
    # the serve reference on the end params
    params = lm_tree_unflatten({p: t.to(dev) for p, t in end.items()})
    prefill, decode = lm_ts.make_serve_steps(cfg, kv_chunk=128)
    cache = lm_model.init_cache(cfg, LM_MESH_B, LM_MESH_CACHE, torch.float32, dev)
    prompt = torch.randint(0, cfg.vocab_size, (LM_MESH_B, LM_MESH_PROMPT), generator=_gen(12))
    logits, nxt, serve_ms = [], [], []
    with torch.no_grad():
        for t in range(LM_MESH_TICKS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if t == 0:
                lg, _ = prefill(params, prompt.to(dev), cache)
            else:
                lg, _ = decode(params, nxt[-1].to(dev), LM_MESH_PROMPT + t - 1, cache)
            torch.cuda.synchronize()
            serve_ms.append(1e3 * (time.perf_counter() - t0))
            logits.append(lg.cpu())
            nxt.append(lg.argmax(-1).cpu())
    del params, cache
    _free()
    t0 = time.perf_counter()
    families = lm_mesh_family_reference(dev)
    families_s = time.perf_counter() - t0
    _free()
    t0 = time.perf_counter()
    family_serve = lm_mesh_family_serve_reference(dev)
    family_serve_s = time.perf_counter() - t0
    _free()
    t0 = time.perf_counter()
    hybrid = lm_mesh_hybrid_reference(dev)
    hybrid_s = time.perf_counter() - t0
    _free()
    t0 = time.perf_counter()
    torch.save({"end": end, "rule": rule, "metrics": metrics, "prompt": prompt,
                "next": nxt[:LM_MESH_TICKS], "logits": logits, "families": families,
                "family_serve": family_serve, "hybrid": hybrid},
               os.path.join(LM_MESH_DIR, "ref.pt"))
    save_s = time.perf_counter() - t0
    for k in ("end", "forced"):
        del hybrid[k]
    t0 = time.perf_counter()
    ranks = spawn_ranks(lm_mesh_ranks, 4, work_dir=os.path.join(LM_MESH_DIR, "ranks"),
                        device="cuda", backend="gloo", timeout_s=900)
    ranks_s = time.perf_counter() - t0
    shutil.rmtree(LM_MESH_DIR, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    out = {"params": lm_model.param_count(cfg), "batch": LM_MESH_B, "seq": LM_MESH_S,
           "one_process": {"step_ms": one_ms, "peak_bytes": one_peak, "trace": one_trace,
                           "prefill_ms": serve_ms[0], "decode_tick_ms": serve_ms[1:]},
           "phase_wall_s": wall, "ranks_s": ranks_s}
    print(f"  llama3.2-3b {LM_MESH_LAYERS} layer(s) f32 ({out['params']:,} params), B x S = "
          f"{LM_MESH_B} x "
          f"{LM_MESH_S}, on {smi}: one process (the card alone) step ms "
          f"{[round(v, 1) for v in one_ms]}, traced idle share "
          f"{one_trace['device_idle_share']}, peak {one_peak / 1e9:.2f} GB; prefill "
          f"{serve_ms[0]:.1f} ms, decode ticks {[round(v, 1) for v in serve_ms[1:]]} ms",
          flush=True)
    for f in ranks[0]:
        r = [x[f] for x in ranks]
        tr = r[0]["trace"]
        out[f] = {"step_ms": [x["step_ms"] for x in r], "draw_s": [x["draw_s"] for x in r],
                  "peak_bytes": [x["peak_bytes"] for x in r], "trace_rank0": tr,
                  "param_max_diff_in_lr": r[0]["param_max_diff_in_lr"],
                  "param_rms_diff_of_move": r[0]["param_rms_diff_of_move"],
                  "set_aside": r[0]["set_aside"], "set_aside_max_lr": r[0]["set_aside_max_lr"],
                  "steps": r[0]["steps"], "serve": r[0]["serve"]}
        print(f"  {f}, 4 ranks sharing one card over gloo ({smi}): step ms/rank "
              f"{[[round(v, 1) for v in x['step_ms']] for x in r]}; draw s/rank "
              f"{[round(x['draw_s'], 1) for x in r]}; peak GB/rank "
              f"{[round(x['peak_bytes'] / 1e9, 2) for x in r]}; rank 0's traced step: wall "
              f"{tr['wall_ms']:.1f} ms, idle share {tr['device_idle_share']}; params after "
              f"step 2 vs one process: max {r[0]['param_max_diff_in_lr']:.3g} lr, RMS "
              f"{r[0]['param_rms_diff_of_move']:.3g} of the move over the determined "
              f"elements ({r[0]['set_aside']:,} set aside, within "
              f"{r[0]['set_aside_max_lr']:.3g} lr); serve logits err/max "
              f"{[f'{e:.2g}' for e in r[0]['serve']['logit_err_of_max']]}, near ties "
              f"{r[0]['serve']['near_ties']}, prefill {r[0]['serve']['prefill_ms']:.1f} ms, "
              f"decode ticks {[round(v, 1) for v in r[0]['serve']['decode_tick_ms']]} ms",
              flush=True)
    two = ranks[0]["2x2"]
    out["2x2"].update(ckpt_save_s=two["ckpt_save_s"], pipeline=two["pipeline"],
                      probe=two["probe"])
    out["families"] = {"one_process_s": families_s}
    for arch in LM_MESH_FAMILIES:
        r = [x["2x2"]["families"][arch] for x in ranks]
        f = r[0]
        out["families"][arch] = {k: f[k] for k in (
            "steps", "grad_err_of_max", "worst_grad_leaf", "param_max_diff_in_lr",
            "param_rms_diff_of_move", "worst_rms_leaf", "set_aside", "set_aside_max_lr",
            "forced_ulps", "forced_norm_equal", "seconds")}
        out["families"][arch]["step_ms"] = [x["step_ms"] for x in r]
        print(f"  {arch} smoke (f32, {LM_MESH_FAMILY_B} x {LM_MESH_FAMILY_S}, extras where "
              f"taken) at 2x2, 4 ranks sharing one card over gloo ({smi}): losses "
              f"{[round(m['loss'], 6) for m in f['steps']]} and grad norms within "
              f"{LM_TRAIN_METRIC_REL} of one process on the card; step-1 grads within "
              f"{f['grad_err_of_max']:.3g} of the leaf's largest (tolerance {LM_MESH_GRAD}; "
              f"worst {f['worst_grad_leaf']}); params after step 2: max "
              f"{f['param_max_diff_in_lr']:.3g} lr, RMS {f['param_rms_diff_of_move']:.3g} of "
              f"the move over the determined elements (tolerance {LM_TRAIN_PARAM_RMS}; worst "
              f"{f['worst_rms_leaf']}); {f['set_aside']:,} elements set aside, within "
              f"{f['set_aside_max_lr']:.3g} lr; AdamW on the one-process step-2 inputs: ulps "
              f"{f['forced_ulps']} (tolerance {LM_MESH_ULPS}), raw grad norm equal "
              f"{f['forced_norm_equal']}; rank 0 step ms "
              f"{[round(v, 1) for v in f['step_ms']]}; {f['seconds']:.1f} s", flush=True)
    hy = [x["2x2"]["hybrid"] for x in ranks]
    h = hy[0]
    out["hybrid"] = dict({k: h[k] for k in (
        "steps", "param_max_diff_in_lr", "param_rms_diff_of_move", "worst_rms_leaf",
        "set_aside", "set_aside_max_lr", "aside_held", "aside_bound_share", "own_grad_norm_rel",
        "own_step2_rel", "grad_err_of_max", "worst_grad_leaf", "forced_grad_norm", "forced_ulps",
        "forced_norm_equal", "trace", "seconds")},
        params=hybrid["params"], step_ms=[x["step_ms"] for x in hy],
        draw_s=[x["draw_s"] for x in hy], peak_bytes=[x["peak_bytes"] for x in hy],
        one_process={k: hybrid[k] for k in ("step_ms", "draw_s", "peak_bytes")},
        one_process_s=hybrid_s, ref_save_s=save_s)
    print(f"  zamba2-7b full width cut to one unit and the tail ({LM_MESH_HYBRID_LAYERS} "
          f"layers, {hybrid['params']:,} params, f32, AdamW, {LM_MESH_B} x {LM_MESH_S}) on "
          f"{smi}: one process step ms {[round(v, 1) for v in hybrid['step_ms']]}, peak "
          f"{hybrid['peak_bytes'] / 1e9:.2f} GB; 2x2, 4 ranks sharing the card over gloo: "
          f"step ms/rank {[[round(v, 1) for v in x['step_ms']] for x in hy]}, draw s/rank "
          f"{[round(x['draw_s'], 1) for x in hy]}, peak GB/rank "
          f"{[round(x['peak_bytes'] / 1e9, 2) for x in hy]}; rank 0's traced step: wall "
          f"{h['trace']['wall_ms']:.1f} ms, idle share {h['trace']['device_idle_share']}; "
          f"losses {[round(m['loss'], 6) for m in h['steps']]} and step 1's grad norm within "
          f"{LM_TRAIN_METRIC_REL} of one process (step 2's own grad norm "
          f"{h['own_grad_norm_rel']:.3g} of its step 2's, from the set-aside elements after "
          f"step 1); step 2 from its own inputs: loss, loss_total, grad norm within "
          f"{[f'{v:.3g}' for v in h['own_step2_rel'].values()]} of one process at the meshed "
          f"params after step 1 (tolerance {LM_TRAIN_METRIC_REL}); "
          f"step-2 grads at the one-process params after step 1 within "
          f"{h['grad_err_of_max']:.3g} of the leaf's largest (tolerance {LM_MESH_GRAD}; worst "
          f"{h['worst_grad_leaf']}), their norm {h['forced_grad_norm']} vs "
          f"{hybrid['metrics'][1]['grad_norm']}; params after step 2: max over the determined "
          f"elements {h['param_max_diff_in_lr']:.3g} lr (tolerance {LM_TRAIN_PARAM_LR}), RMS "
          f"{h['param_rms_diff_of_move']:.3g} of the move over the determined elements "
          f"(tolerance {LM_TRAIN_PARAM_RMS}; worst "
          f"{h['worst_rms_leaf']}); {h['set_aside']:,} elements set aside, within "
          f"{h['set_aside_max_lr']:.3g} lr, each held by AdamW's bound from both runs' g, m "
          f"and v ({h['aside_held']:,} held; largest share of the bound after steps 1 and 2 "
          f"{[f'{v:.3g}' for v in h['aside_bound_share']]}); AdamW on the "
          f"one-process step-2 inputs: ulps {h['forced_ulps']} (tolerance {LM_MESH_ULPS}), "
          f"raw grad norm equal {h['forced_norm_equal']}; {h['seconds']:.1f} s in the ranks, "
          f"{hybrid_s:.1f} s one process, ref.pt written in {save_s:.1f} s", flush=True)
    out["launch_hybrid"] = ranks[0]["2x2"]["launch_hybrid"]
    print(f"  launch.train {' '.join(LM_MESH_LAUNCH_HYBRID)}: ended at step "
          f"{out['launch_hybrid']['step']}, its checkpoint restored in one process == the "
          f"state it holds; {out['launch_hybrid']['seconds']:.1f} s", flush=True)
    out["family_serve"] = {"one_process_s": family_serve_s}
    for arch in LM_MESH_SERVE_FAMILIES:
        for d, m in LM_MESH_FACTORS:
            f = f"{d}x{m}"
            one = family_serve[f"{arch}@{f}"]
            r = ranks[0][f]["family_serve"][arch]
            out["family_serve"][f"{arch}@{f}"] = dict(
                r, one_process_prefill_ms=one["prefill_ms"],
                one_process_decode_tick_ms=one["decode_tick_ms"],
                seconds_per_rank=[x[f]["family_serve"][arch]["seconds"] for x in ranks])
            print(f"  {arch} smoke serve (f32, {LM_MESH_FAMILY_B} rows, "
                  f"{LM_MESH_SERVE_PROMPT.get(arch, 13)} tokens, extras where taken, "
                  f"{LM_MESH_SERVE_CACHE} cache positions, {LM_MESH_SERVE_TICKS} ticks) at {f}, 4 "
                  f"ranks sharing one card over gloo ({smi}): logits err/max "
                  f"{[f'{e:.2g}' for e in r['logit_err_of_max']]} (tolerance {LM_MESH_LOGITS}), "
                  f"near ties {r['near_ties']}; cache leaves within {r['cache_err_of_max']:.3g} "
                  f"of the leaf's largest (tolerance {LM_MESH_CACHE_HOLD}; worst "
                  f"{r['worst_cache_leaf']}); rank 0 prefill {r['prefill_ms']:.1f} ms, median "
                  f"tick {float(np.median(r['decode_tick_ms'])):.1f} ms (one process "
                  f"{one['prefill_ms']:.1f} / {float(np.median(one['decode_tick_ms'])):.1f} ms); "
                  f"{r['seconds']:.1f} s", flush=True)
    out["2x2"]["probe_serve"] = two["probe_serve"]
    for arch, lines in two["probe_serve"].items():
        print(f"  collective probe (rank 0), {arch} smoke prefill_32k cell at 2x2 on the "
              f"reference's specs' inputs, logits equal to the meshed serve's prefill:",
              flush=True)
        for line in lines:
            print(f"    {line}", flush=True)
    print(f"  2x2 checkpoint: saved in {two['ckpt_save_s']:.1f} s (gathered leaf by leaf, "
          f"rank 0 writes), each rank's sharded restore == its blocks, restored in one "
          f"process (rank 0, no shardings) == the gathered state, leaf by leaf; "
          f"pipeline_apply 4 stages card vs sequential: {two['pipeline']}", flush=True)
    print(f"  collective probe (rank 0), llama3.2-3b {LM_MESH_LAYERS} layer(s) f32 train step "
          f"on 2x2:", flush=True)
    for line in two["probe"]:
        print(f"    {line}", flush=True)
    print(f"  lm_mesh phase {wall:.1f} s (ranks {ranks_s:.1f} s)", flush=True)
    return out


def main() -> int:
    t_start = time.perf_counter()
    phase("device")
    if not torch.cuda.is_available():
        print("CUDA is not available: this script needs one CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi_line = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"  {kind}; nvidia-smi: {smi_line}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    phase("build")
    t0 = time.perf_counter()
    _build.build_all(KERNELS)
    for mod in (tnn_wave, tnn_column, stdp_update, wta, threefry):
        mod.build()
    print(f"  {', '.join(KERNELS)} built/loaded in {time.perf_counter() - t0:.1f} s "
          f"(in parallel)", flush=True)
    for name in KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "smem" in line or line.startswith("["):
                print(f"  {name}: {line.strip()}")
    threefry_sass = sass_mix("threefry", "tnn_threefry_uniform_kernel")
    print(f"  threefry: SASS of tnn_threefry_uniform_kernel (4 floats a thread and "
          f"a column key a block): {threefry_sass or 'cuobjdump not found'}",
          flush=True)

    phase("kernels vs plain (bit for bit): tnn_wave")
    full_hi = network_config(625, 24, 8, impl="fused")    # the served thresholds
    full_lo = network_config(625, 12, 3, impl="fused")    # both layers fire
    deep = deep_config(625, widths=(12, 12, 10), thetas=(12, 3, 1), impl="fused")
    errs = {}
    err = 0
    for name, cfg, B, seed in (
            ("full theta=(24,8) serve", full_hi, 64, 1),
            ("full theta=(24,8) learn", full_hi, 16, 2),
            ("full theta=(12,3) serve", full_lo, 64, 3),
            ("full theta=(12,3) learn", full_lo, 16, 4),
            ("full ragged", full_lo, 13, 5),
            ("full multi-chunk", full_lo, 300, 6),
            ("deep depth-3", deep, 64, 7),
            ("deep depth-3 learn", deep, 16, 8),
            ("caps p1=512 q=128", caps_config(132), 40, 9),
            ("full odd B=7", full_lo, 7, 10),
            ("odd widths 32x11 -> 11x9", odd_config(48), 37, 11)):
        err = max(err, check_case(name, cfg, B, seed, dev))
    for k, (tb, wb) in enumerate(OTHER_SPECS):
        for B in (5, 64):
            err = max(err, check_case(f"24 sites (time_bits, weight_bits)=({tb},{wb})",
                                      spec_config(tb, wb, 24), B, 20 + 2 * k + (B > 5), dev))
    errs["tnn_wave"] = err
    timing = measure(full_hi, dev)

    seconds = {}
    t0 = time.perf_counter()
    phase("autotune: the wave kernel's tuned forward launches (every candidate bit-equal, "
          "static vs tuned ms, serving launches with the cached extents)")
    tuned = autotune_phase(dev, smi_line)
    seconds["autotune"] = time.perf_counter() - t0

    phase("kernels vs plain (bit for bit): tnn_column, stdp_update, wta")
    errs["tnn_column"] = check_columns(dev)
    errs["stdp_update"] = check_stdps(dev)
    errs["wta"] = check_wtas(dev)
    layer_timing = measure_layer_kernels(dev)

    phase("kernels vs plain (bit for bit): threefry")
    errs["threefry"] = check_threefrys(dev)
    layer_timing["threefry"] = measure_threefry(dev)
    draw_host = measure_draw_host_time(dev)

    record_forward_geometries(True)
    phase("serve, impl=pallas (main path: launcher on the card, full width)")
    rep_p, counts_p, _ = serve_path("pallas", dev)
    want = expected_launches(2, rep_p.stats.waves)
    want.update({"tnn_wave[forward]": 0, "tnn_wave[learn]": 0, "wta": 0})
    if counts_p != want:
        raise AssertionError(f"pallas serve launches {counts_p}, expected {want}")

    phase("serve, impl=fused (launcher on the card, full width)")
    rep_f, counts_f, _ = serve_path("fused", dev)
    if counts_f["tnn_wave[learn]"] != TRAIN_WAVES:
        raise AssertionError(f"{counts_f['tnn_wave[learn]']} learn launches for "
                             f"{TRAIN_WAVES} warm-up waves")
    if counts_f["tnn_wave[forward]"] < rep_f.stats.waves:
        raise AssertionError(f"{counts_f['tnn_wave[forward]']} forward launches for "
                             f"{rep_f.stats.waves} served waves")
    if counts_f["tnn_column"] or counts_f["stdp_update"] or counts_f["wta"]:
        raise AssertionError(f"the fused serve launched per-layer kernels: {counts_f}")
    if counts_f["threefry"] != 2 * TRAIN_WAVES:
        raise AssertionError(f"{counts_f['threefry']} threefry launches for "
                             f"{TRAIN_WAVES} warm-up waves of 2 layers")

    phase("serve on the CPU (plain path, same seeds) and across backends")
    t0 = time.perf_counter()
    ref = launch_serve.main(SERVE_ARGS + ["--impl", "fused", "--device", "cpu"])
    print(f"  cpu launcher wall {time.perf_counter() - t0:.2f} s", flush=True)
    same_result(rep_f, ref, "fused on the card vs the CPU")
    same_result(rep_p, rep_f, "pallas vs fused on the card")
    print(f"  pallas (card) == fused (card) == cpu: warmed weights, vote table "
          f"and all {len(ref.results)} class ids; layer spikes in the first "
          f"served wave {rep_p.served_spikes} (the paper thresholds leave "
          f"layer 2 silent at 625 sites, as in the reference)", flush=True)

    phase("serve, steady state and traced")
    prof = {impl: profile_serve(rep, dev, impl)
            for impl, rep in (("pallas", rep_p), ("fused", rep_f))}

    phase("fallback: a fused network the wave kernel cannot hold")
    errs["fallback"], counts_fb = fallback_path(dev)

    phase("train at full width (main path of slice 5: launcher, trainer, checkpoints)")
    train, counts_t, (ckpt_a, trainer_a) = train_phase(dev)
    final_a = trainer_a.state

    t0 = time.perf_counter()
    phase("serve at a firing theta = (12, 3): pallas (card), fused (card), CPU")
    firing, params0 = firing_phase(dev)
    seconds["firing"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    phase("serve online (learn while serving, K = 4, swaps every 4 waves) at theta = (12, 3)")
    online, online_ref = online_phase(dev, params0)
    seconds["online"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    phase("serve from a checkpoint, online (train A's step_00000016, waves 16-31)")
    online_ckpt = online_ckpt_phase(dev, ckpt_a, final_a)
    seconds["online_ckpt"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    phase("loadgen: closed loop, then open loop at half its images/s (online)")
    loadgen = loadgen_phase(dev)
    seconds["loadgen"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    phase("flagship: repro_torch.launch.tnn_mnist --impl fused, card and CPU")
    flagship = flagship_phase(dev)
    seconds["flagship"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    phase("modes: seq and gauss learning waves at 625 sites, pallas and fused (card) vs CPU")
    modes = modes_phase(dev)
    seconds["modes"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    phase("cells: tnn_infer_64k and tnn_train_8k (the reference's dry-run cells) on the card")
    cells = cells_phase(dev)
    seconds["cells"] = time.perf_counter() - t0
    record_forward_geometries(False)
    print("  the forward waves that serving, training, the flagship and the cells launched "
          "on the card (this process; the mesh ranks launch over their local sites):",
          flush=True)
    tuned["main_path_geometries"] = forward_geometries_report()

    t0 = time.perf_counter()
    phase("mesh: the (data, model) mesh, 4 ranks sharing the card (gloo), 1 rank (NCCL)")
    mesh = mesh_phase(dev, trainer_a, online_ref, params0, smi_line)
    seconds["mesh"] = time.perf_counter() - t0
    errs["threefry[window]"] = mesh["window_err"]

    t0 = time.perf_counter()
    phase("lm: LM serving on the card (llama3.2-3b full size, qwen1.5-4b cut to 4 "
          "layers, mistral-nemo-12b to 2, minicpm3-4b to 8, zamba2-7b to 9, "
          "mixtral-8x22b to 2, grok-1-314b to 1, xlstm-125m, whisper-tiny, the "
          "internvl2-76b prefix, the TNN-frontend entry point, the smoke configs "
          "against the CPU)")
    lm = lm_phase(dev, smi_line)
    seconds["lm"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    phase("lm_train: LM training (llama3.2-3b: 2 layers card vs CPU, the launcher and its "
          "checkpoint, resume on the card, the full-size step)")
    lm_train = lm_train_phase(dev, smi_line)
    seconds["lm_train"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    phase("lm_mesh: LM sharding, llama3.2-3b full width 2 layers f32, DTensor steps on "
          "2x2 and 1x4 (4 ranks sharing the card over gloo) vs one process, the sharded "
          "checkpoint, the collective probe, the pipeline; the smoke train steps of "
          "minicpm3-4b, xlstm-125m, zamba2-7b, whisper-tiny and internvl2-76b at 2x2; "
          "zamba2-7b full width (one unit and the tail) at 2x2, the meshed zamba2-7b "
          "launcher; the smoke serve steps of the six other families at 2x2 and 1x4, the "
          "probe's serve cells")
    reset_counts()
    lm_mesh = lm_mesh_phase(dev, smi_line)
    if any(read_counts().values()):
        raise AssertionError(f"lm_mesh: the LM path launched TNN kernels {read_counts()}")
    seconds["lm_mesh"] = time.perf_counter() - t0
    print(f"  slice-6 to slice-13 phase seconds: {seconds}", flush=True)

    phase("report")
    print(f"  every phase's seconds: {phase_seconds()}", flush=True)
    kernels = []
    for half in ("forward", "learn"):
        t = timing[half]
        name = f"tnn_wave[{half}]"
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/tnn_wave.cu",
            "replaces": "src/repro/kernels/tnn_wave.py:70",
            "launches": counts_f[name], "max_abs_err": errs["tnn_wave"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
        })
    for name, replaces, counts in (
            ("tnn_column", "src/repro/kernels/tnn_column.py:81", counts_p),
            ("stdp_update", "src/repro/kernels/stdp_update.py:67", counts_p),
            ("wta", "src/repro/kernels/wta.py:19", counts_p),
            ("threefry", "jax.random.uniform (XLA threefry2x32; no Pallas kernel)",
             counts_t)):
        t = layer_timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": errs[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
        })
    t = mesh["window_timing"]
    kernels.append({
        "name": "threefry[window]", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/threefry.cu",
        "replaces": "jax.random.uniform sliced per shard (src/repro/core/network.py:477, "
                    "shard_u; XLA threefry2x32, no Pallas kernel)",
        "launches": mesh["window_launches"], "max_abs_err": errs["threefry[window]"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
    })

    def serve_numbers(rep):
        st = rep.stats
        return {"waves": st.waves, "requests": st.requests,
                "waves_per_s": st.waves_per_s, "images_per_s": st.images_per_s,
                "p50_ms": st.p50_ms, "p95_ms": st.p95_ms,
                "occupancy": st.occupancy, "accuracy": rep.accuracy}

    keys = ("B", "bytes", "ops", "bytes_ms", "ops_ms", "events_ms")
    shapes = {h: {k: t[k] for k in keys} for h, t in timing.items()}
    layer_timing["threefry[window]"] = mesh["window_timing"]
    for name, t in layer_timing.items():
        shapes[name] = {k: t[k] for k in keys}
        shapes[name]["per_layer"] = [
            {k: p[k] for k in ("ms", "plain_ms", "events_ms", "bound_ms",
                               "bound_by", "bytes", "ops")}
            for p in t.get("per_layer", [])]
    print(json.dumps({
        "serve": {"pallas": {**serve_numbers(rep_p), "launches": counts_p,
                             **prof["pallas"]},
                  "fused": {**serve_numbers(rep_f), "launches": counts_f,
                            **prof["fused"]},
                  "warmup_spikes": rep_p.warmup_spikes,
                  "served_spikes": rep_p.served_spikes},
        "fallback_launches": counts_fb,
        "train": train,
        "autotune": tuned,
        "firing": firing,
        "online": online,
        "online_ckpt": online_ckpt,
        "loadgen": loadgen,
        "flagship": flagship,
        "modes": modes,
        "cells": cells,
        "mesh": {k: v for k, v in mesh.items() if k not in ("window_timing",)},
        "lm": lm,
        "lm_train": lm_train,
        "lm_mesh": lm_mesh,
        "phase_seconds": seconds,
        "every_phase_seconds": phase_seconds(),
        "uniform_draw_host_ms": draw_host,
        "threefry_sass": threefry_sass,
        "shapes": shapes,
        "seconds": time.perf_counter() - t_start,
    }))
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
