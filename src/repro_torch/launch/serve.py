"""Serving launcher: the paper's TNN prototype classified through the port's
Hopper kernels on the card, or an LM served by the slot engine.

LM serving (``--arch`` one of ``repro_torch.configs.ARCHS``; the reference's
launcher, whose default arch is llama3.2-3b; the port's default stays
``tnn-mnist``):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --requests 8 --slots 4 --max-new 32 --max-len 256

draws the weights from ``PRNGKey(0)`` on the card (bit for bit the
reference's ``init_params``), submits ``--requests`` prompts of 4-15 random
tokens (``np.random.default_rng(0)``, the reference's draws) and serves
them greedily through ``serve.engine.Engine`` with ``--slots`` slots; it
prints the reference's ``served N requests / T tokens`` line, then tokens/s,
the median decode tick and the median prefill. ``--smoke`` serves the
arch's smoke config (``--smoke --device cpu`` runs on the CPU in seconds).
Every decoder family serves: the attention decoders, the SSM (xlstm-125m),
the hybrid (zamba2-7b), the VLM's text trunk. The encoder-decoder
(whisper-tiny) is refused (exit 2: requests carry no encoder frames,
``serve.engine.check_servable``), as is ``--mesh`` with an LM arch. The
parameter count printed is the spec tree's, the floats drawn.

TNN serving:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tnn-mnist \
        --sites 625 --slots 64 --requests 512 --train-waves 4 --impl pallas

``--impl pallas`` (the default, as in the reference launcher) runs every
layer through the per-layer column and STDP kernels; ``--impl fused`` runs
each wave as one wave-kernel launch; ``direct`` and ``matmul`` are the plain
per-layer forms. All give the same bits.

The sequence is the reference launcher's (``repro.launch.serve``, tnn half),
with its keys: weights from ``PRNGKey(0)``, ``--train-waves`` unsupervised
STDP warm-up waves on 16 encoded labelled images, wave ``i`` on the second
half of the ``i``-th split of the chain from ``PRNGKey(1)`` (the threefry
kernel draws its uniforms on the card), ``fit`` on
``digits(max(128, 4 * slots), seed=1)``, then serve ``digits(requests,
seed=2)`` through the continuous-batching engine. The warmed weights and
every class id equal the reference launcher's. ``--from-ckpt DIR`` serves a
training checkpoint instead (either package's), with no warm-up.
``--device cpu`` runs the same sequence on the plain PyTorch path, to the
same bits.

``--superbatch-k K`` lets one dispatch drain up to K waves of backlog.
``--online-stdp`` learns while serving: every served wave also steps a
shadow state, and every ``--swap-every`` learning waves the engine
re-labels and hot-swaps the published weights and vote table; the report
adds per-version stats. With ``--from-ckpt`` the shadow continues the
checkpoint's key and wave, and swap checkpoints go back to that directory:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tnn-mnist \
        --sites 16 --slots 8 --requests 64 --online-stdp --swap-every 4 \
        --device cpu

``--mesh DxM`` serves on a (data, model) process mesh under ``torchrun
--nproc-per-node D*M``: slots over "data" (``--slots`` rounds up to a
multiple of D), sites over "model"; every rank classifies the gathered z,
rank 0 prints (NCCL with one card per rank by default; ``--backend gloo``
when ranks share a card, and on the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import random as _random
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.configs.tnn_mnist import crop_field, launcher_network_config
from repro_torch.core.network import (
    encode_images, init_network, network_forward, network_train_wave,
)
from repro_torch.data.mnist_like import digits
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import describe, make_mesh_2d, parse_mesh
from repro_torch.models import model as lm_model
from repro_torch.serve.engine import Engine, Request, check_servable
from repro_torch.serve.tnn_engine import ClassifyRequest, ServeStats, TNNEngine

WARMUP_ROWS = 16


@dataclasses.dataclass
class ServeReport:
    """What one launcher run produced."""

    params: List[torch.Tensor]            # the served weights (after the warm-up waves)
    vote_table: torch.Tensor
    results: Dict[int, int]               # uid -> class id
    labels: np.ndarray                    # the requests' true labels
    stats: ServeStats
    accuracy: float
    warmup_spikes: List[List[int]]        # per warm-up wave, spikes per layer
    served_spikes: List[int]              # spikes per layer over the first wave of requests
    versions: Dict[int, int]              # uid -> published version it was classified under
    version_stats: Dict[int, ServeStats]  # the serve record split by version


def spike_counts(zs: Sequence[torch.Tensor], T: int) -> List[int]:
    """Number of spikes (z < T) per layer."""
    return [int((z.to(torch.int32) < T).sum()) for z in zs]


def warm_up(cfg, lab_imgs: np.ndarray, waves: int, device
            ) -> Tuple[List[torch.Tensor], List[List[int]]]:
    """The launcher's weights: ``init_network(PRNGKey(0))``, then ``waves``
    unsupervised STDP waves on the first 16 encoded labelled images, wave
    ``i`` on the second half of the ``i``-th split of the chain from
    ``PRNGKey(1)``. Returns the weights and each wave's spikes per layer."""
    T = cfg.layers[0].column.wave.T
    params = init_network(_random.PRNGKey(0), cfg, device)
    x = encode_images(torch.from_numpy(np.ascontiguousarray(lab_imgs)).to(device), cfg)
    key, spikes = _random.PRNGKey(1), []
    for _ in range(waves):
        key, k = _random.split(key)
        zs, params = network_train_wave(x[:WARMUP_ROWS], params, cfg, k)
        spikes.append(spike_counts(zs, T))
    return params, spikes


def resolve_slots(requested: int, ndata: int, say=print) -> int:
    """Fit the requested slot count to the mesh's data axis by rounding UP
    to the next multiple, never down (``say`` reports it); impossible values
    raise."""
    if ndata < 1:
        raise ValueError(f"mesh data axis size must be >= 1, got {ndata}")
    if requested < 1:
        raise ValueError(f"--slots must be >= 1, got {requested}")
    resolved = (requested + ndata - 1) // ndata * ndata
    if resolved != requested:
        say(f"[serve] --slots {requested} is not a multiple of the data "
            f"axis size {ndata}; rounding UP to {resolved} slots")
    return resolved


def serve_tnn(args: argparse.Namespace) -> ServeReport:
    mesh = (make_mesh_2d(*parse_mesh(args.mesh), device=args.device,
                         backend=args.backend) if args.mesh else None)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    say = print if mesh is None or mesh.is_main else (lambda *a, **k: None)
    n_slots = resolve_slots(args.slots, mesh.n_data if mesh is not None else 1, say)
    cfg = launcher_network_config(args.sites, depth=args.depth,
                                  impl=args.impl, packed=args.packed)
    T = cfg.layers[0].column.wave.T
    # the swap cadence has a default, but the engine refuses one without a
    # shadow state: forward it only when learning is on
    swap_every = args.swap_every if args.online_stdp else 0
    online = dict(superbatch_k=args.superbatch_k, online_stdp=args.online_stdp,
                  swap_every=swap_every, mesh=mesh)
    say(f"serving tnn-mnist ({cfg.n_neurons:,} neurons, impl={args.impl}) "
        f"on {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}, "
        f"{describe(mesh)}")
    lab_imgs, lab_labs = digits(max(128, 4 * n_slots), seed=1)
    lab_imgs = crop_field(lab_imgs, args.sites)

    warmup_spikes: List[List[int]] = []
    if args.from_ckpt:
        eng = TNNEngine.from_checkpoint(
            args.from_ckpt, cfg, n_slots=n_slots, impl=args.impl,
            label_data=(lab_imgs, lab_labs), device=device, **online)
        say(f"warm-started from {args.from_ckpt}" + (
            f" at wave {int(eng.learn_state['wave'])}" if args.online_stdp else ""))
    else:
        params, warmup_spikes = warm_up(cfg, lab_imgs, args.train_waves, device)
        eng = TNNEngine(cfg, params, n_slots=n_slots, impl=args.impl,
                        device=device, **online)
        eng.fit(lab_imgs, lab_labs)
    params = eng.logical_params()

    test_imgs, test_labs = digits(args.requests, seed=2)
    test_imgs = crop_field(test_imgs, args.sites)
    for uid in range(args.requests):
        eng.submit(ClassifyRequest(uid=uid, image=test_imgs[uid]))
    done = eng.run_until_done(pipelined=not args.lockstep)
    st = eng.stats()
    results = {u: done[u].result for u in sorted(done)}
    acc = float(np.mean([results[u] == test_labs[u] for u in results]))
    first = encode_images(torch.from_numpy(
        np.ascontiguousarray(test_imgs[:n_slots])).to(device), cfg)
    served_spikes = spike_counts(network_forward(first, params, cfg), T)

    mode = "lock-step" if args.lockstep else "pipelined"
    say(f"served {len(done)} images in {st.waves} waves / {st.wall_s:.3f}s "
          f"({mode}), accuracy {acc:.1%}")
    say(f"[serve-stats] {st.waves_per_s:.1f} waves/s  "
        f"{st.images_per_s:.1f} images/s  p50 {st.p50_ms:.3f} ms  "
        f"p95 {st.p95_ms:.3f} ms  occupancy {st.occupancy:.0%}")
    say(f"[spikes] warm-up waves (per layer): {warmup_spikes}; first "
        f"served wave (per layer): {served_spikes}")
    versions = {u: done[u].version for u in sorted(done)}
    by_version = eng.stats_by_version()
    if eng.ckpt is not None:   # the last swap's checkpoint is written by now
        eng.ckpt.wait()
    if args.online_stdp:
        say(f"[online-stdp] learned to wave {int(eng.learn_state['wave'])}, "
            f"{eng.swaps} hot swap(s), now serving v{eng.version}")
        for ver, sv in by_version.items():
            hits = [results[u] == test_labs[u] for u in results if versions[u] == ver]
            say(f"  v{ver}: {sv.requests} requests / {sv.waves} waves  "
                  f"p50 {sv.p50_ms:.3f} ms  p95 {sv.p95_ms:.3f} ms  "
                  f"accuracy {float(np.mean(hits)):.1%}")
    return ServeReport(params=params, vote_table=eng.vote_table,
                       results=results, labels=test_labs, stats=st,
                       accuracy=acc, warmup_spikes=warmup_spikes,
                       served_spikes=served_spikes, versions=versions,
                       version_stats=by_version)


@dataclasses.dataclass
class LMServeReport:
    """What one LM launcher run produced."""

    cfg: object                  # the served ModelConfig
    params: Dict                 # the float32 weights (PRNGKey(0))
    engine: Optional[Engine]     # with its compute copy and cache
    done: Dict[int, Request]     # uid -> request (prompt, out_tokens)
    wall_s: float                # submit to the last request done
    tokens: int
    tokens_per_s: float
    decode_ms: float             # median decode tick (host wall, ends in a sync)
    prefill_ms: float            # median one-row prefill


def lm_requests(cfg, n: int, max_new: int) -> List[Request]:
    """The reference launcher's requests: prompts of 4-15 tokens drawn from
    ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    return [Request(uid=uid, prompt=rng.integers(0, cfg.vocab_size, int(rng.integers(4, 16))),
                    max_new_tokens=max_new) for uid in range(n)]


def serve_lm(args: argparse.Namespace, cfg=None) -> LMServeReport:
    """Serve ``args.requests`` requests of ``args.arch`` (``cfg`` in place
    of its config, e.g. one cut in depth) with weights from ``PRNGKey(0)``."""
    device = resolve_device(args.device)
    if cfg is None:
        cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"serving {cfg.name} ({lm_model.param_count(cfg):,} parameters) on {where}",
          flush=True)
    params = lm_model.init_params(cfg, _random.PRNGKey(0), device)
    eng = Engine(cfg, params, n_slots=args.slots, max_len=args.max_len, device=device)
    t0 = time.perf_counter()
    for req in lm_requests(cfg, args.requests, args.max_new):
        eng.submit(req)
    done = eng.run_until_done()
    wall = time.perf_counter() - t0
    total = sum(len(r.out_tokens) for r in done.values())
    decode_ms = float(np.median(eng.decode_ms)) if eng.decode_ms else 0.0
    prefill_ms = float(np.median(eng.prefill_ms)) if eng.prefill_ms else 0.0
    print(f"served {len(done)} requests / {total} tokens in {wall:.2f}s")
    print(f"[lm-stats] {total / wall:.1f} tokens/s  decode {decode_ms:.3f} ms a tick "
          f"({len(eng.decode_ms)} ticks, {args.slots} slots)  prefill {prefill_ms:.3f} ms "
          f"({len(eng.prefill_ms)} prompts)", flush=True)
    return LMServeReport(cfg=cfg, params=params, engine=eng, done=done, wall_s=wall,
                         tokens=total, tokens_per_s=total / wall, decode_ms=decode_ms,
                         prefill_ms=prefill_ms)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tnn-mnist", choices=("tnn-mnist", *ARCHS),
                    help="tnn-mnist (the default) or an LM arch")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    # LM options (the reference launcher's)
    ap.add_argument("--smoke", action="store_true",
                    help="LM: serve the arch's smoke config (tiny widths)")
    ap.add_argument("--max-new", type=int, default=8,
                    help="LM: most tokens generated a request")
    ap.add_argument("--max-len", type=int, default=128,
                    help="LM: cache positions a slot holds")
    # tnn-mnist options
    ap.add_argument("--sites", type=int, default=64,
                    help="patch sites, a perfect square (625 = full width)")
    ap.add_argument("--depth", type=int, default=2,
                    help="cascade depth: 2 = the paper prototype, other "
                         "depths build the deep_config N-layer cascade")
    ap.add_argument("--impl", default="pallas",
                    choices=("direct", "matmul", "pallas", "fused"),
                    help="'pallas' = the per-layer kernels (one launch per "
                         "layer); 'fused' = one wave-kernel launch per gamma "
                         "wave; 'direct'/'matmul' = the plain per-layer forms")
    ap.add_argument("--train-waves", type=int, default=4)
    ap.add_argument("--packed", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="kept for config parity with the reference; the "
                         "kernel's IO is uint8/int8 either way")
    ap.add_argument("--lockstep", action="store_true",
                    help="serve with the blocking one-wave-at-a-time loop "
                         "instead of the continuous-batching pipeline")
    ap.add_argument("--from-ckpt", default=None, metavar="DIR",
                    help="serve the latest training checkpoint in DIR "
                         "(weights and vote table; no warm-up waves)")
    ap.add_argument("--superbatch-k", type=int, default=1,
                    help="most gamma waves one dispatch drains when the "
                         "backlog is deeper than --slots")
    ap.add_argument("--online-stdp", action="store_true",
                    help="learn while serving: every served wave also steps "
                         "a shadow state, hot-swapped in every --swap-every "
                         "learning waves")
    ap.add_argument("--swap-every", type=int, default=8,
                    help="learning waves between automatic hot swaps with "
                         "--online-stdp (0 = never automatically)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="(data, model) process mesh, e.g. --mesh 2x2 under "
                         "torchrun --nproc-per-node 4: slots shard over data "
                         "(rounded up to a multiple of D), sites over model")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="the mesh's backend (default nccl on cuda, gloo on "
                         "cpu; gloo when ranks share one card)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.arch != "tnn-mnist":
        try:
            check_servable(get_config(args.arch))
        except ValueError as e:
            ap.error(str(e))
        if args.mesh:
            ap.error("--mesh serves tnn-mnist only: the reference serves an LM "
                     "unsharded (its serve_lm builds no mesh rules), and the "
                     "sharded LM prefill and decode steps are the dry run's and "
                     "the collective probe's (train_step.make_serve_steps(mesh=))")
    return args


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    if args.arch == "tnn-mnist":
        return serve_tnn(args)
    return serve_lm(args)


if __name__ == "__main__":
    main()
