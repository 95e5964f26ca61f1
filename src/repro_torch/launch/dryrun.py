"""The TNN half of the reference's dry run, on one card: the paper's
2-layer prototype at the reference's production cells.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tnn-mnist \
        --out build/dryrun

For each cell (``tnn_train_8k``: one learning wave of 8,192 images;
``tnn_infer_64k``: one forward of 65,536) and variant (``--impl`` and, for
the learning wave, the "gauss" STDP mode), where the reference lowers and
compiles the step for a 256-chip pod, this runs it on the card at 625
sites and the reference's theta (20, 6): weights from
``init_network(PRNGKey(0))``, a (B, 625, 32) uint8 volley drawn from seed
0, the wave key ``split(PRNGKey(0))[1]``; one warm-up wave, then one
timed wave (CUDA events). Each result has the reference's fields
(``roofline`` is ``Roofline.report()`` under the ``h100-sxm`` profile, from
the analytic counts of ``roofline.analysis`` and the reference's
model-operation formula; ``memory`` holds ``torch.cuda.max_memory_allocated``;
``mesh`` is ``"1"``), the wave's ms and its launches, and is written as
``tnn-mnist__<cell><variant>__1.json`` under ``--out``. The plain backends
(``direct``, ``matmul``) run where their largest intermediates fit in the
card's free memory, else report ``status="skip"`` with the bytes they would
need. ``--device cpu`` runs the plain path at a toy size (``--sites``,
``--batch``).

The reference's column-parallel variant (625 -> 640 sites, the sites over
"model", the batch over "data") runs on a (data, model) process mesh,
one rank per process under ``torchrun`` (``--colpar --colpar-mesh DxM``;
``run_tnn_colpar_cell``): every rank builds the 640-site cell's global
inputs, cuts its window and runs the meshed wave (``network_train_step``
or the forward on its sites); the result adds the recorder's collectives
(``collectives``, wire bytes by kind) and prices them in the roofline's
collective term. Its file is ``tnn-mnist__<cell><variant>_colpar__<D>x<M>.json``.

    torchrun --nproc-per-node 4 -m repro_torch.launch.dryrun --colpar \
        --colpar-mesh 2x2 --device cpu --batch 8 --out build/dryrun_cpu

The reference's production meshes, 16x16 and 2x16x16, need 256 and 512
cards: the TNN cells refuse them.

The LM half (``--arch <LM>`` or ``all``; ``--cell``, ``--mesh single|multi|
both``, default both) is analytic: for every arch x ``SHAPE_GRID`` cell the
reference lowers and compiles on 256 or 512 forced host devices, this
prices the same step on the *logical* 16x16 or 2x16x16 mesh shape with no
processes (``run_lm_cell``), with the reference's profile choices
(``long_context`` for long_500k over 1B dense parameters, ``fsdp`` for
decode only where a 16-way TP shard of the bf16 weights passes 8e9 bytes)
and ``moe_groups`` tiled to the data shards. Each row carries the
reference's keys: per-rank ``memory`` (``analytic_args_bytes`` from the
rules' specs and ceil-divided blocks, the reference's
``analytic_activation_bytes``, their total and ``fits_80g_hbm`` against
an H100's 80 GB), ``roofline`` (``t_compute_s``, ``t_memory_s``,
``t_collective_s``, ``bottleneck``, ``roofline_fraction``,
``useful_flop_fraction``) against the H100's dense bf16 rate
(``h100-sxm-bf16``), ``n_params`` (the reference's ``n_params()``) beside
``n_params_spec`` (the spec tree's), and ``"analytic": true``. Compute and
memory come from ``roofline.analysis``'s counts (``lm_train_work``,
``lm_decode_work``); where it has none (prefill; training outside the
dense and MoE decoders) ``roofline`` is null with ``roofline_reason``. The
collective term is a ring model of the rules' per-layer collectives
(``collective_model``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all         --out build/dryrun_lm
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import random as _random
from repro_torch.core.network import (
    NetworkConfig, init_network, network_forward, network_mesh_spec,
    network_train_step, network_train_wave, prototype_config,
)
from repro_torch.device import resolve_device
from repro_torch.models.model import param_count
from repro_torch.models.params import tree_flatten, tree_map
from repro_torch.roofline import analysis as RL
from repro_torch.sharding import partition as PT
from repro_torch.utils.tracing import (
    collectives_recorded, read_counts, reset_counts,
)

TNN_CELLS = {
    # one gamma wave of unsupervised STDP learning over a global image batch
    "tnn_train_8k": ("train", 8192),
    # inference-only wave (forward + WTA, no STDP)
    "tnn_infer_64k": ("infer", 65536),
}
THETA = (20, 6)        # the reference's dry-run thresholds
SITES = 625
SEED = 0
IMPLS = ("direct", "matmul", "pallas", "fused")
MULTI_GPU = ("is the reference's production mesh (16x16 = 256 cards; "
             "multi-pod 2x16x16 = 512): a TNN cell runs its wave, and a process "
             "mesh of that size needs that many cards; run --colpar on a DxM "
             "process mesh instead (the LM rows are analytic and take it)")
COLPAR_SITES = 640     # the reference's column-parallel variant: 625 -> 640


def _tnn_variant_cfg(cfg: NetworkConfig, impl: str, gauss: bool) -> NetworkConfig:
    new_layers = []
    for l in cfg.layers:
        col = dataclasses.replace(
            l.column, impl=impl,
            stdp=dataclasses.replace(
                l.column.stdp, batch_reduce="gauss" if gauss else "sum"))
        new_layers.append(dataclasses.replace(l, column=col))
    return dataclasses.replace(cfg, layers=tuple(new_layers))


def variant_suffix(impl: str, gauss: bool) -> str:
    """The reference's file-name suffix: ``_<impl>`` (none for "direct"),
    then ``_gauss``."""
    return ("" if impl == "direct" else f"_{impl}") + ("_gauss" if gauss else "")


def model_flops(cfg: NetworkConfig, kind: str, B: int) -> float:
    """The reference's algorithmic operations of one wave: the V contraction
    at all T = 16 wave positions of its formula, per image, x 1.5 for the
    STDP case generation and update when learning."""
    per_img = sum(l.n_cols * l.column.p * l.column.q * 16 for l in cfg.layers)
    if kind == "train":
        per_img *= 1.5
    return per_img * B


def cell_inputs(cfg: NetworkConfig, B: int, device: torch.device):
    """(x, params, key): a (B, sites, p1) uint8 volley drawn from ``SEED`` on
    ``device`` (spike times 0..T, T = no spike), the weights
    ``init_network(PRNGKey(SEED))`` and the wave key
    ``split(PRNGKey(SEED))[1]``."""
    T = cfg.layers[0].column.wave.T
    g = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randint(0, T + 1, (B, cfg.layers[0].n_cols, cfg.layers[0].column.p),
                      generator=g, dtype=torch.uint8, device=device)
    params = init_network(_random.PRNGKey(SEED), cfg, device)
    return x, params, _random.split(_random.PRNGKey(SEED))[1]


def plain_peak_bytes(cfg: NetworkConfig, kind: str, B: int, impl: str,
                     gauss: bool) -> int:
    """Bytes of the plain backends' largest live intermediates in one wave
    (the layer with the most): "direct"'s per-tick (C, B, p, q) int32
    minimum beside the (C, B, T, q) potentials; "matmul"'s (C, B*T, p*T)
    ramp matrix at 8 bytes an element (its float32 copy and as much again
    of bool and int32 intermediates: the forward of ``tnn_train_8k`` ran
    out of an H100's 79 GiB with 44 GiB live when it asked for the 39 GiB
    float32 matrix); learning adds the STDP's (C, B, p, q) planes (about
    32 bytes an element with the uniforms under "sum", 8 under "gauss")."""
    worst = 0
    for l in cfg.layers:
        C, p, q, T = l.n_cols, l.column.p, l.column.q, l.column.wave.T
        e = C * B * p * q
        fwd = (4 * e + 8 * C * B * T * q if impl == "direct"
               else 8 * C * B * T * p * T + 8 * C * B * T * q)
        learn = 0 if kind == "infer" else (8 * e if gauss else 32 * e)
        worst = max(worst, fwd, learn)
    return worst


def _route_works(cfg: NetworkConfig, kind: str, impl: str, gauss: bool, x, params,
                 zs) -> List[Tuple[str, RL.Work]]:
    """The work of every kernel (or plain step) the wave runs, in order,
    from :mod:`repro_torch.roofline.analysis`."""
    T = cfg.layers[0].column.wave.T
    thetas = [l.column.theta for l in cfg.layers]
    B, C = x.shape[0], x.shape[1]
    shapes = [(l.column.p, l.column.q) for l in cfg.layers]
    if kind == "infer":
        if impl == "pallas":
            return [(f"tnn_column[{i}]", w) for i, w in
                    enumerate(RL.layer_works(x, params, thetas, T))]
        return [("tnn_wave[forward]", RL.forward_work(x, params, thetas, T))]
    if gauss:
        out = []
        for i, (w, (p, q)) in enumerate(zip(RL.layer_works(x, params, thetas, T),
                                            shapes)):
            out += [(f"threefry[{i}]", RL.threefry_work(C * p * q)),
                    (f"tnn_column[{i}]", w),
                    (f"gauss_update[{i}]", RL.gauss_update_work(C, B, p, q))]
        return out
    draws = [(f"threefry[{i}]", RL.threefry_work(2 * C * B * p * q))
             for i, (p, q) in enumerate(shapes)]
    if impl != "pallas":
        learn = (RL.forward_work(x, params, thetas, T)
                 + RL.learn_epilogue_work(C, B, [p * q for p, q in shapes]))
        return draws + [("tnn_wave[learn]", learn)]
    out = []
    for i, (w, (p, q)) in enumerate(zip(RL.layer_works(x, params, thetas, T),
                                        shapes)):
        out += [draws[i], (f"tnn_column[{i}]", w),
                (f"stdp_update[{i}]", RL.stdp_work(C, B, p, q))]
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_ms(fn, dev: torch.device) -> Tuple[float, Any]:
    """One call's ms: CUDA events on the card, the host clock on the CPU."""
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end), out
    t0 = time.perf_counter()
    out = fn()
    return 1e3 * (time.perf_counter() - t0), out


def run_tnn_cell(cell_name: str, multi_pod: bool = False, verbose: bool = True,
                 column_parallel: bool = False, impl: str = "pallas",
                 gauss: bool = False, *, sites: int = SITES,
                 batch: Optional[int] = None, device="cuda",
                 outputs: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Run one cell's wave on one card (the reference lowers it for a pod):
    warm up once, time one wave; returns the reference's result fields plus
    ``wave_ms``, the timed wave's ``launches`` and ``kernel_bound_ms`` (the
    sum of its kernels' bounds, which run one after another). ``batch`` and
    ``sites`` cut the cell for a toy run. When ``outputs`` is a dict it
    receives the wave's inputs and outputs (``x``, ``params``, ``key``,
    ``zs`` and, learning, ``new_params``) and ``wave``, a function that
    runs the same wave again."""
    if multi_pod:
        raise ValueError(f"multi_pod {MULTI_GPU}")
    if column_parallel:
        raise ValueError("column_parallel runs on a process mesh: "
                         "run_tnn_colpar_cell(cell, mesh)")
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} is not one of {IMPLS}")
    kind, B = TNN_CELLS[cell_name]
    if gauss and kind != "train":
        raise ValueError("the gauss variant changes only the learning wave")
    B = B if batch is None else int(batch)
    dev = resolve_device(device)
    cfg = _tnn_variant_cfg(prototype_config(sites=sites, theta1=THETA[0],
                                            theta2=THETA[1]), impl, gauss)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    tag = f"tnn-mnist x {cell_name}{variant_suffix(impl, gauss)} x 1 ({name})"
    result: Dict[str, Any] = {
        "arch": "tnn-mnist", "cell": cell_name, "mesh": "1",
        "column_parallel": False, "impl": impl, "gauss": gauss,
        "device": name, "sites": sites, "batch": B, "theta": list(THETA)}
    if impl in ("direct", "matmul") and dev.type == "cuda":
        need = plain_peak_bytes(cfg, kind, B, impl, gauss)
        gc.collect()                 # what an earlier run left is free
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info(dev)[0]
        if need > free:
            why = (f"the plain {impl} path needs about {need:,} bytes of "
                   f"intermediates, {free:,} are free on the card")
            if verbose:
                print(f"[skip] {tag}: {why}", flush=True)
            return dict(result, status="skip", reason=why, needs_bytes=need)
    t0 = time.perf_counter()
    try:
        x, params, key = cell_inputs(cfg, B, dev)
        if kind == "train":
            def wave():
                return network_train_wave(x, params, cfg, key)
        else:
            def wave():
                return network_forward(x, params, cfg), None
        resident = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        wave()
        _sync(dev)
        compile_s = time.perf_counter() - t0
        reset_counts()
        wave_ms, (zs, new_params) = _time_ms(wave, dev)
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        works = _route_works(cfg, kind, impl, gauss, x, params, zs)
        total = sum((w for _, w in works), RL.Work())
        roof = RL.from_counts(total.peak_ops(), total.bytes,
                              model_flops(cfg, kind, B))
        r = roof.report()
        result.update(
            status="ok", compile_s=round(compile_s, 2), wave_ms=wave_ms,
            roofline=r, collectives={}, launches=launches,
            kernel_bound_ms=sum(w.bound()[0] for _, w in works),
            kernels={n: {"bytes": w.bytes, "ops": w.ops, "bound_ms": w.bound()[0],
                         "bound_by": w.bound()[1]} for n, w in works},
            memory={"temp_size_in_bytes": float(peak - resident),
                    "max_memory_allocated": float(peak)},
            spikes=[int((z < cfg.layers[0].column.wave.T).sum()) for z in zs])
        if outputs is not None:
            outputs.update(x=x, params=params, key=key, zs=zs,
                           new_params=new_params, wave=wave)
        if verbose:
            print(f"[ok]   {tag}: wave {wave_ms:.3f} ms (bound "
                  f"{result['kernel_bound_ms']:.3f} ms over its kernels) | "
                  f"bottleneck={r['bottleneck']} "
                  f"t=({r['t_compute_s']:.2e},{r['t_memory_s']:.2e},"
                  f"{r['t_collective_s']:.2e})s roofline={r['roofline_fraction']:.2%} "
                  f"| peak {peak / 2**30:.2f} GiB | launches {launches}", flush=True)
    except Exception as e:  # noqa: BLE001 - report, keep sweeping
        result.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[ERR]  {tag}: {type(e).__name__}: {e}", flush=True)
    return result


def run_tnn_colpar_cell(cell_name: str, mesh, impl: str = "pallas", *,
                        verbose: bool = True, sites: int = COLPAR_SITES,
                        batch: Optional[int] = None,
                        outputs: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The reference's column-parallel variant of a cell on ``mesh`` (a
    ``launch.mesh.Mesh2D``; every rank calls this): 640 sites over "model",
    the batch over "data". Every rank builds the cell's global inputs
    (:func:`cell_inputs`), cuts its window and runs one warm-up and one
    timed wave on it: the meshed ``network_train_step`` (its counters
    all-reduced over "data") or the forward on its sites. Returns the
    reference's fields, this rank's ``wave_ms`` and ``launches``, and the
    timed wave's ``collectives`` (the recorder's, priced by the ring model
    into the roofline's collective term). ``outputs`` receives the global
    ``x``, ``params`` and ``key``, the rank's ``zs`` windows and, learning,
    its ``new_params`` slices, and ``spec``."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} is not one of {IMPLS}")
    kind, B = TNN_CELLS[cell_name]
    B = B if batch is None else int(batch)
    dev = mesh.device
    cfg = _tnn_variant_cfg(prototype_config(sites=sites, theta1=THETA[0],
                                            theta2=THETA[1]), impl, False)
    spec = network_mesh_spec(cfg, mesh)
    mesh_name = f"{mesh.n_data}x{mesh.n_model}"
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    tag = (f"tnn-mnist x {cell_name}{variant_suffix(impl, False)}_colpar x "
           f"{mesh_name} rank {mesh.rank} ({name})")
    result: Dict[str, Any] = {
        "arch": "tnn-mnist", "cell": cell_name, "mesh": mesh_name,
        "column_parallel": True, "impl": impl, "gauss": False, "device": name,
        "sites": sites, "batch": B, "theta": list(THETA), "rank": mesh.rank,
        "backend": mesh.backend}
    t0 = time.perf_counter()
    try:
        x, params, key = cell_inputs(cfg, B, dev)
        T = cfg.layers[0].column.wave.T
        x_loc = spec.local_spikes(x, T)
        ps_loc = spec.local_weights(params)
        if kind == "train":
            def wave():
                return network_train_step(x_loc, ps_loc, cfg, key, mesh=mesh)
        else:
            def wave():
                return network_forward(x_loc, ps_loc, cfg), None
        wave()
        _sync(dev)
        compile_s = time.perf_counter() - t0
        reset_counts()
        with collectives_recorded() as entries:
            wave_ms, (zs, new_params) = _time_ms(wave, dev)
        launches = read_counts()
        stats = RL.collective_stats(entries)
        works = _route_works(cfg, kind, impl, False, x_loc, ps_loc, zs)
        total = sum((w for _, w in works), RL.Work())
        roof = RL.from_counts(total.peak_ops(), total.bytes,
                              model_flops(cfg, kind, B) / mesh.size,
                              collective_bytes=stats.total_bytes,
                              collectives=dict(stats.bytes_by_kind))
        r = roof.report()
        result.update(
            status="ok", compile_s=round(compile_s, 2), wave_ms=wave_ms,
            roofline=r, collectives=roof.collectives,
            collective_counts=dict(stats.count_by_kind), launches=launches,
            kernel_bound_ms=sum(w.bound()[0] for _, w in works))
        if outputs is not None:
            outputs.update(x=x, params=params, key=key, zs=zs,
                           new_params=new_params, spec=spec, wave=wave)
        if verbose and mesh.is_main:
            print(f"[ok]   {tag}: wave {wave_ms:.3f} ms | collective "
                  f"{stats.total_bytes:,} wire bytes "
                  f"{ {k: v for k, v in roof.collectives.items() if v} } | "
                  f"bottleneck={r['bottleneck']} t=({r['t_compute_s']:.2e},"
                  f"{r['t_memory_s']:.2e},{r['t_collective_s']:.2e})s | "
                  f"launches {launches}", flush=True)
    except Exception as e:  # noqa: BLE001 - report, keep sweeping
        result.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[ERR]  {tag}: {type(e).__name__}: {e}", flush=True)
    return result


# ---------------------------------------------------------------------------
# LM cells: analytic numbers per rank on the production mesh shapes
# ---------------------------------------------------------------------------

PRODUCTION_MESHES = {"16x16": {"data": 16, "model": 16},
                     "2x16x16": {"pod": 2, "data": 16, "model": 16}}
HBM_BYTES = 80e9       # an H100 80GB's device memory
COLLECTIVE_MODEL = ("ring model of the rules' per-layer collectives: FSDP "
                    "all-gathers of each weight over its data axes at each use "
                    "(forward, backward and remat recompute in training), grads "
                    "reduce-scattered over them (all-reduced where a weight is "
                    "not data-sharded), and a tensor-parallel all-reduce of the "
                    "activations over the model axis after each row-parallel "
                    "product")
MEMORY_MODEL = ("the counted bytes of the step times this rank's share of the "
                "step's inputs (its block bytes over the whole inputs' bytes)")
# row-parallel products a block ends with (each a TP all-reduce)
_ROW_PARALLEL = {"dense": 2, "moe": 2, "enc": 2, "mla": 2, "shared_attn": 2,
                 "dec": 3, "mamba": 1, "mlstm": 1, "slstm": 1}


def _dp_size(mesh) -> int:
    shape = PT.mesh_shape(mesh)
    return int(shape.get("pod", 1) * shape["data"])


def arg_bytes_per_chip(args, shardings) -> float:
    """Per-rank resident bytes of all inputs (params, optimizer state,
    caches, batch): each leaf's block under its sharding (ceil-divided, the
    reference's padded shards) times its element size."""
    total = 0
    leaves = tree_flatten(args)
    shs = [s for _, s in tree_flatten(shardings, lambda x: isinstance(x, PT.NamedSharding))]
    for (_, t), sh in zip(leaves, shs):
        total += math.prod(sh.shard_shape(tuple(t.shape))) * t.element_size()
    return float(total)


def analytic_activation_bytes(cfg, cell, mesh) -> float:
    """The reference's checkpointed-residual + logits live bytes per rank
    (remat "full")."""
    dp = _dp_size(mesh)
    tp = int(PT.mesh_shape(mesh)["model"])
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "decode":
        return float(B * cfg.d_model * 4 * cfg.n_layers / dp)  # tiny carries
    n_ckpt = cfg.layout_repeat + len(cfg.layout_tail)
    resid = n_ckpt * B * S * cfg.d_model * 2 / dp
    v_shard = tp if cfg.vocab_size % tp == 0 else 1
    logits = B * S * cfg.vocab_size * 4 / (dp * v_shard)
    work = 4 * B * S * cfg.n_heads * cfg.head_dim * 4 / dp  # flash accum f32
    if cell.kind == "prefill":
        resid = B * S * cfg.d_model * 2 / dp * 2  # no grad residuals kept
        logits = B * cfg.vocab_size * 4 / dp
    return float(resid + logits + work)


def model_flops_per_chip(cfg, cell, n_chips: int) -> float:
    """The reference's model operations per rank (6 N B S training, 2 N B S
    prefill, 2 N B decode) with N the active weights of the spec tree
    (``analysis.lm_active_params``: ROADMAP Queue 3 item 10)."""
    n_active = RL.lm_active_params(cfg)
    if cell.kind == "train":
        flops = 6.0 * n_active * cell.global_batch * cell.seq_len
    elif cell.kind == "prefill":
        flops = 2.0 * n_active * cell.global_batch * cell.seq_len
    else:
        flops = 2.0 * n_active * cell.global_batch
    return flops / n_chips


def build_abstract(cfg, cell, mesh, prof: PT.RunProfile):
    """The reference's ``build_lowerable`` without the function: ``(args,
    shardings)`` of the cell's step as ``meta`` tensors and
    :class:`~repro_torch.sharding.partition.NamedSharding` trees."""
    from repro_torch.launch import specs as SPECS
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS

    p_rules, a_rules = PT.param_rules(mesh, prof), PT.act_rules(mesh, prof)
    dp = _dp_size(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in PT.mesh_shape(mesh))

    def batch_shard(tree):
        def one(t):
            div = t.dim() > 0 and t.shape[0] % dp == 0
            first = dp_axes if div else None
            return PT.NamedSharding(mesh, (first,) + (None,) * (t.dim() - 1)
                                    if t.dim() else ())
        return tree_map(one, tree)

    def cache_shard(cache):
        return PT.shardings_for_tree(cache, M.cache_axes(cfg, cache), mesh, a_rules)

    if cell.kind == "train":
        opt_cfg = OPT.OptConfig(name=OPT.default_opt_for(cfg.n_params()))
        state = TS.abstract_state(cfg, opt_cfg)
        state_sh = PT.shardings_for_tree(state, TS.state_axes(cfg, opt_cfg), mesh, p_rules)
        batch = SPECS.train_batch_specs(cfg, cell)
        return (state, batch), (state_sh, batch_shard(batch))
    params = M.abstract_params(cfg)
    params_sh = PT.shardings_for_tree(params, M.param_axes(cfg), mesh, p_rules)
    if cell.kind == "prefill":
        sp = SPECS.prefill_specs(cfg, cell)
        args = [params, sp["tokens"], sp["cache"]]
        shs = [params_sh, batch_shard(sp["tokens"]), cache_shard(sp["cache"])]
        for k in ("embeds", "frames"):
            if k in sp:
                args.append(sp[k])
                shs.append(batch_shard(sp[k]))
        return tuple(args), tuple(shs)
    sp = SPECS.decode_specs(cfg, cell)
    return ((params, sp["token"], sp["pos"], sp["cache"]),
            (params_sh, batch_shard(sp["token"]), PT.replicated(mesh),
             cache_shard(sp["cache"])))


def _group_of(spec, mshape) -> int:
    return math.prod(PT._axes_size(mshape, p) for p in spec)


def collective_model(cfg, cell, mesh, prof: PT.RunProfile) -> Dict[str, float]:
    """Modelled wire bytes per rank of one step by collective kind
    (:data:`COLLECTIVE_MODEL`), through ``analysis.wire_bytes``."""
    from repro_torch.models import model as M

    mshape = PT.mesh_shape(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in mshape)
    p_rules = PT.param_rules(mesh, prof)
    r = 1 if cfg.remat == "full" else 0
    uses = {"train": 2 + r, "prefill": 1, "decode": 1}[cell.kind]
    out = {k: 0.0 for k in ("all-gather", "all-reduce", "reduce-scatter")}
    specs = M.build_specs(cfg)
    for _, s in tree_flatten(specs, lambda x: hasattr(x, "axes")):
        spec = PT.spec_for(s.shape, s.axes, mesh, p_rules)
        data_g = math.prod(mshape[a] for part in spec if part is not None
                           for a in ((part,) if isinstance(part, str) else part)
                           if a in dp_axes)
        all_g = _group_of(spec, mshape)
        n = math.prod(s.shape)
        if data_g > 1:   # gathered over its data axes at each use
            gathered = 2 * n * data_g // all_g     # bf16 block, data axes gathered
            out["all-gather"] += uses * RL.wire_bytes("all-gather", gathered, data_g)
        if cell.kind == "train":
            dp = math.prod(mshape[a] for a in dp_axes)
            if data_g > 1:
                out["reduce-scatter"] += RL.wire_bytes("reduce-scatter", 4 * n // all_g,
                                                       data_g)
            elif dp > 1:
                out["all-reduce"] += RL.wire_bytes("all-reduce", 4 * n // all_g, dp)
    tp_axes = ("data", "model") if prof.long_context else ("model",)
    tp = math.prod(mshape.get(a, 1) for a in tp_axes)
    if not prof.seq_parallel and tp > 1:
        dp = _dp_size(mesh)
        B = cell.global_batch
        rows = B // dp if B % dp == 0 else B
        S = cell.seq_len if cell.kind != "decode" else 1
        act = 2 * rows * S * cfg.d_model
        per_pass = sum(_ROW_PARALLEL[k] for k in cfg.layer_kinds)
        passes = {"train": 2 + r, "prefill": 1, "decode": 1}[cell.kind]
        out["all-reduce"] += passes * per_pass * RL.wire_bytes("all-reduce", act, tp)
    return out


def _counted_work(cfg, cell):
    """(ops, bytes) of the whole step from ``roofline.analysis``, or None
    and why where it has no count."""
    from repro_torch.train import optimizer as OPT

    if cell.kind == "train":
        opt_cfg = OPT.OptConfig(name=OPT.default_opt_for(cfg.n_params()))
        try:
            w = RL.lm_train_work(cfg, opt_cfg, cell.global_batch, cell.seq_len)
        except ValueError as e:
            return None, f"roofline.analysis has no train count here: {e}"
        return (w["ops"], w["bytes"]), ""
    if cell.kind == "decode":
        return RL.lm_decode_work(cfg, [cell.seq_len] * cell.global_batch), ""
    return None, "roofline.analysis has no prefill count"


def run_lm_cell(arch: str, cell, multi_pod: bool,
                prof: PT.RunProfile = PT.RunProfile(),
                verbose: bool = True) -> Dict[str, Any]:
    """One LM (arch x cell x production mesh) row, analytic: no processes,
    the mesh a logical shape. Per rank: the inputs' block bytes under the
    rules, the reference's activation formula, the model operations of the
    spec tree, a fit flag against an H100's 80 GB, and the roofline terms
    against the H100's dense bf16 rate (compute and memory from
    ``roofline.analysis``'s counts, the collective term modelled)."""
    from repro_torch.configs import cell_applicable, get_config

    mesh_name = "2x16x16" if multi_pod else "16x16"
    mesh = PRODUCTION_MESHES[mesh_name]
    n_chips = math.prod(mesh.values())
    cfg = get_config(arch)
    tag = f"{arch} x {cell.name} x {mesh_name}"
    ok, why = cell_applicable(cfg, cell)
    if not ok:
        if verbose:
            print(f"[skip] {tag}: {why}")
        return {"arch": arch, "cell": cell.name, "mesh": mesh_name, "status": "skip",
                "reason": why, "analytic": True}
    prof = dataclasses.replace(
        prof, long_context=(cell.name == "long_500k" and cfg.n_params() > 1e9
                            and not cfg.n_experts))
    if cell.kind == "decode":
        # serving keeps params TP-resident where a 16-way TP shard fits
        params_tp_bytes = cfg.n_params() * 2 / mesh["model"]
        prof = dataclasses.replace(prof, fsdp=params_tp_bytes > 8e9, seq_parallel=False)
    cfg = PT.tuned_config(cfg, mesh, prof)
    result: Dict[str, Any] = {"arch": arch, "cell": cell.name, "mesh": mesh_name,
                              "profile": dataclasses.asdict(prof), "analytic": True}
    try:
        args, shardings = build_abstract(cfg, cell, mesh, prof)
        mem = {"analytic_args_bytes": arg_bytes_per_chip(args, shardings),
               "analytic_activation_bytes": analytic_activation_bytes(cfg, cell, mesh)}
        mem["analytic_total_bytes"] = (mem["analytic_args_bytes"]
                                       + mem["analytic_activation_bytes"])
        mem["fits_80g_hbm"] = mem["analytic_total_bytes"] < HBM_BYTES
        whole = float(sum(t.numel() * t.element_size() for _, t in tree_flatten(args)))
        coll = collective_model(cfg, cell, mesh, prof)
        mflops = model_flops_per_chip(cfg, cell, n_chips)
        counted, reason = _counted_work(cfg, cell)
        result.update(status="ok", memory=mem, collectives=coll,
                      collective_model=COLLECTIVE_MODEL,
                      n_params=cfg.n_params(), n_active_params=cfg.n_active_params(),
                      n_params_spec=param_count(cfg),
                      n_active_params_spec=RL.lm_active_params(cfg),
                      model_flops_per_chip=mflops)
        if counted is None:
            result.update(roofline=None, roofline_reason=reason)
        else:
            ops, nbytes = counted
            share = mem["analytic_args_bytes"] / whole
            roof = RL.from_counts(ops / n_chips, nbytes * share, mflops,
                                  collective_bytes=sum(coll.values()),
                                  profile=RL.H100_SXM_BF16, collectives=coll)
            result.update(roofline=roof.report(), memory_model=MEMORY_MODEL)
        if verbose:
            rf = result["roofline"]
            terms = (f"bottleneck={rf['bottleneck']} t=({rf['t_compute_s']:.2e},"
                     f"{rf['t_memory_s']:.2e},{rf['t_collective_s']:.2e})s "
                     f"roofline={rf['roofline_fraction']:.2%}" if rf else
                     f"roofline: {reason}")
            print(f"[ok]   {tag}: args {mem['analytic_args_bytes'] / 1e9:.2f} GB "
                  f"total {mem['analytic_total_bytes'] / 1e9:.2f} GB "
                  f"fits 80G={mem['fits_80g_hbm']} | {terms}")
    except Exception as e:  # noqa: BLE001 - report, keep sweeping
        result.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[ERR]  {tag}: {type(e).__name__}: {e}")
    return result


def run_lm(archs: Sequence[str], cells, meshes: Sequence[bool], out: str,
           prof: PT.RunProfile = PT.RunProfile()) -> int:
    """Every (arch x cell x mesh) row as ``<arch>__<cell>__<mesh>.json``
    under ``out``; returns the exit code (1 on any error)."""
    os.makedirs(out, exist_ok=True)
    n = {"ok": 0, "skip": 0, "error": 0}
    for arch in archs:
        for cell in cells:
            for mp in meshes:
                res = run_lm_cell(arch, cell, mp, prof)
                n[res["status"]] += 1
                fname = f"{arch.replace('.', '_')}__{cell.name}__{res['mesh']}.json"
                with open(os.path.join(out, fname), "w") as f:
                    json.dump(res, f, indent=1)
    print(f"\ndry-run complete: {n['ok']} ok (analytic), {n['skip']} documented skips, "
          f"{n['error']} errors")
    return 1 if n["error"] else 0


def variants(cell_name: str, impls: Sequence[str]):
    """(impl, gauss) pairs of a cell: every impl, and for the learning cell
    each again in the "gauss" mode; the kernels' backends first, the plain
    ones (the largest intermediates) last."""
    impls = sorted(impls, key=lambda i: i in ("direct", "matmul"))
    modes = (False, True) if TNN_CELLS[cell_name][0] == "train" else (False,)
    return [(impl, gauss) for impl in impls for gauss in modes]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tnn-mnist",
                    help="tnn-mnist, an LM of the registry, a comma list of "
                         "LMs, or all (every LM)")
    ap.add_argument("--cell", default="all",
                    help="all, or a comma list of " + ", ".join(TNN_CELLS)
                         + " (tnn-mnist) or of the shape grid's cells (LMs)")
    ap.add_argument("--mesh", default=None, choices=["single", "multi", "both"],
                    help="production mesh shape(s): tnn-mnist runs single "
                         "only; the LM rows default to both")
    ap.add_argument("--fsdp", default=1, type=int,
                    help="LM rows: FSDP sharding of the weights' embed axis")
    ap.add_argument("--colpar", action="store_true",
                    help="the reference's column-parallel variant, on the "
                         "--colpar-mesh process mesh (under torchrun)")
    ap.add_argument("--colpar-mesh", default="1x4", metavar="DxM",
                    help="(data, model) process mesh of --colpar")
    ap.add_argument("--impl", default="pallas,fused",
                    help="comma list of " + ", ".join(IMPLS))
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--sites", type=int, default=SITES)
    ap.add_argument("--batch", type=int, default=None,
                    help="cut every cell's batch to this (a toy run)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.arch != "tnn-mnist":
        return _main_lm(ap, args)
    args.mesh = args.mesh or "single"
    if args.mesh != "single":
        ap.error(f"--mesh {args.mesh} {MULTI_GPU}")
    if args.colpar and "WORLD_SIZE" not in os.environ:
        ap.error("--colpar runs one rank per process: start it with torchrun "
                 "--nproc-per-node D*M (D x M = --colpar-mesh)")
    impls = args.impl.split(",")
    bad = [i for i in impls if i not in IMPLS]
    if bad:
        ap.error(f"--impl {bad}: choose from {IMPLS}")
    cells = list(TNN_CELLS) if args.cell == "all" else args.cell.split(",")
    for c in cells:
        if c not in TNN_CELLS:
            ap.error(f"--cell {c}: choose from {list(TNN_CELLS)}")
    os.makedirs(args.out, exist_ok=True)
    n = {"ok": 0, "skip": 0, "error": 0}
    if args.colpar:
        from repro_torch.launch.mesh import make_mesh_2d, parse_mesh

        mesh = make_mesh_2d(*parse_mesh(args.colpar_mesh), device=args.device)
        for cell_name in cells:
            for impl in impls:
                res = run_tnn_colpar_cell(cell_name, mesh, impl=impl,
                                          batch=args.batch)
                n[res["status"]] += 1
                if mesh.is_main:
                    fname = (f"tnn-mnist__{cell_name}{variant_suffix(impl, False)}"
                             f"_colpar__{res['mesh']}.json")
                    with open(os.path.join(args.out, fname), "w") as f:
                        json.dump(res, f, indent=1)
        if mesh.is_main:
            print(f"\ncolumn-parallel dry run complete on rank 0: {n['ok']} ok, "
                  f"{n['error']} errors")
        return 1 if n["error"] else 0
    for cell_name in cells:
        for impl, gauss in variants(cell_name, impls):
            res = run_tnn_cell(cell_name, impl=impl, gauss=gauss,
                               sites=args.sites, batch=args.batch,
                               device=args.device)
            n[res["status"]] += 1
            fname = (f"tnn-mnist__{cell_name}{variant_suffix(impl, gauss)}__"
                     f"{res['mesh']}.json")
            with open(os.path.join(args.out, fname), "w") as f:
                json.dump(res, f, indent=1)
    print(f"\ndry-run complete: {n['ok']} ok, {n['skip']} documented skips, "
          f"{n['error']} errors")
    return 1 if n["error"] else 0


def _main_lm(ap: argparse.ArgumentParser, args: argparse.Namespace) -> int:
    from repro_torch.configs import ARCHS, SHAPE_GRID

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    for a in archs:
        if a not in ARCHS:
            ap.error(f"--arch {a}: unknown arch; choose tnn-mnist, all, or from {ARCHS}")
    names = [c.name for c in SHAPE_GRID]
    cells = (list(SHAPE_GRID) if args.cell == "all"
             else [c for c in SHAPE_GRID if c.name in args.cell.split(",")])
    for c in ([] if args.cell == "all" else args.cell.split(",")):
        if c not in names:
            ap.error(f"--cell {c}: choose from {names}")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh or "both"]
    return run_lm(archs, cells, meshes, args.out, PT.RunProfile(fsdp=bool(args.fsdp)))


if __name__ == "__main__":
    raise SystemExit(main())
