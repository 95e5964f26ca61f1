"""The top collectives of one fused TNN K-wave superbatch dispatch on a
(data, model) process mesh, by modelled wire bytes: the TNN half of the
reference's ``repro.launch.collective_probe``, in its report format.

    torchrun --nproc-per-node 4 -m repro_torch.launch.collective_probe \
        --arch tnn-mnist --mesh 2x2 --device cpu

Where the reference reads the collectives off the compiled HLO, every rank
here runs the dispatch (``make_superbatch_step(cfg, mesh)`` on a seeded
volley of ``--waves`` x ``--batch`` images) under
``utils.tracing.collectives_recorded`` and prices what it issued with the
reference's ring model (``roofline.analysis.collective_stats``); rank 0
prints. The psum'd STDP counters show up as the all-reduce over the data
axis; the model axis issues nothing.

The LM half (``--arch <LM> --cell <cell>``) runs one step of the cell's
kind (train, prefill or decode, built as the reference's dry run builds
it: its profile choices, ``moe_groups`` tiled to the data shards, the
trunk cut to ``--repeat`` units) for the arch on the real ``--mesh DxM``
process mesh, at ``--batch`` rows of ``--seq`` tokens (``--smoke`` for the
arch's smoke config), from ``PRNGKey(0)`` params and seeded tokens. Every
collective DTensor issues is recorded with its kind, type, result shape and
group (``utils.tracing.dtensor_collectives``, whose ``CommDebugMode``
gives the counts by op) and the report prices them by the same ring model:

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.collective_probe \
        --arch llama3.2-3b --cell train_4k --smoke --batch 4 --seq 32 --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch import random as _random
from repro_torch.configs.tnn_mnist import default_thetas, network_config
from repro_torch.core.network import (
    init_train_state, local_tree, make_superbatch_step, network_mesh_spec,
)
from repro_torch.launch.mesh import make_mesh_2d, parse_mesh
from repro_torch.roofline import analysis as RL
from repro_torch.utils.tracing import CollectiveEntry, collectives_recorded



def top_lines(entries: Sequence[CollectiveEntry], top: int, label: str) -> List[str]:
    """The reference's report: total modelled wire bytes, then one line per
    (kind, type, shape, group) by bytes, then the bytes by kind."""
    per: Dict[str, List[int]] = defaultdict(lambda: [0, 0])
    for e in entries:
        if e.group <= 1:
            continue
        wire = RL.wire_bytes(e.kind, RL.entry_bytes(e), e.group)
        dims = ",".join(str(d) for d in e.shape)
        key = f"{e.kind} {RL.HLO_DTYPES[e.dtype]}[{dims}] g={e.group}"
        per[key][0] += wire
        per[key][1] += 1
    rows = sorted(per.items(), key=lambda kv: -kv[1][0])
    total = sum(v[0] for v in per.values())
    out = [f"total modelled wire bytes ({label}): {total/1e9:.2f} GB"]
    for k, (b, n) in rows[:top]:
        out.append(f"  {b/1e9:8.3f} GB  x{n:<3d} {k}")
    stats = RL.collective_stats(entries)
    kinds = {k: v for k, v in stats.bytes_by_kind.items() if v}
    out.append(f"by kind: {kinds or '(no collectives)'}")
    return out


def probe_tnn(args: argparse.Namespace) -> Dict[str, object]:
    """Run one fused K-wave superbatch dispatch on the mesh under the
    recorder; returns the entries and the printed lines."""
    data, model = parse_mesh(args.mesh)
    mesh = make_mesh_2d(data, model, device=args.device, backend=args.backend)
    theta1, theta2 = default_thetas(args.sites)
    cfg = network_config(sites=args.sites, theta1=theta1, theta2=theta2,
                         impl=args.impl)
    spec = network_mesh_spec(cfg, mesh)
    state = init_train_state(_random.PRNGKey(0), cfg, mesh.device)
    state["params"] = local_tree(state["params"], cfg, mesh)
    T = cfg.layers[0].column.wave.T
    g = torch.Generator(device=mesh.device).manual_seed(0)
    x_k = torch.randint(0, T + 1, (args.waves, args.batch, args.sites,
                                   cfg.layers[0].column.p),
                        generator=g, dtype=torch.uint8, device=mesh.device)
    step = make_superbatch_step(cfg, mesh)
    with collectives_recorded() as entries:
        step(state, spec.local_spikes(x_k, T, row_axis=1, site_axis=2))
    lines = [f"tnn-mnist {args.sites}+{args.sites} sites, impl={args.impl}, "
             f"K={args.waves} x batch {args.batch} on mesh {data}x{model}"]
    lines += top_lines(entries, args.top, f"mesh {data}x{model}, K={args.waves}")
    if mesh.is_main:
        print("\n".join(lines), flush=True)
    return {"entries": list(entries), "lines": lines}


def probe_lm(args: argparse.Namespace, mesh=None, state=None) -> Dict[str, object]:
    """One sharded step of ``--cell``'s kind for ``--arch`` on the mesh
    under the recorder; returns the entries, the counts by op, the printed
    lines and the step's outputs (gathered). A caller that already holds
    the mesh and a sharded train state of the probed config (a train cell)
    may pass them, and the probe steps that state instead of drawing one."""
    import dataclasses

    from repro_torch.configs import cell_by_name, get_config, smoke_config
    from repro_torch.models import model as M
    from repro_torch.sharding import partition as PT
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS
    from repro_torch.utils.tracing import dtensor_collectives

    data, model = parse_mesh(args.mesh)
    if mesh is None:
        mesh = make_mesh_2d(data, model, device=args.device, backend=args.backend)
    cell = cell_by_name(args.cell)
    base = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    prof = PT.RunProfile(fsdp=bool(args.fsdp), long_context=cell.name == "long_500k",
                         seq_parallel=bool(args.seq_parallel))
    if cell.kind == "decode":
        prof = dataclasses.replace(prof, fsdp=base.n_params() * 2 / model > 8e9)
    cfg = PT.tuned_config(base, mesh, prof)
    cfg = dataclasses.replace(cfg, layout_repeat=args.repeat, dtype=args.dtype,
                              n_enc_layers=min(cfg.n_enc_layers, args.repeat)
                              if cfg.n_enc_layers else 0)
    cfg = dataclasses.replace(cfg, n_layers=len(cfg.layout_unit) * cfg.layout_repeat
                              + len(cfg.layout_tail))
    B, S = args.batch, args.seq
    dev = mesh.device
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g)
    key = _random.PRNGKey(0)
    out: Dict[str, object] = {}
    if cell.kind == "train":
        opt_cfg = OPT.OptConfig(name=OPT.default_opt_for(cfg.n_params()))
        if state is None:
            state = TS.init_state(cfg, opt_cfg, key, dev,
                                  TS.state_shardings(cfg, opt_cfg, mesh, prof))
        step = TS.make_train_step(cfg, opt_cfg, TS.TrainConfig(kv_chunk=args.kv_chunk),
                                  mesh=mesh, prof=prof)
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

        def run():
            return step(state, batch)[1]
    else:
        params = PT.shard_tree(M.init_params(cfg, key, dev),
                               TS.param_shardings(cfg, mesh, prof))
        cache = M.init_cache(cfg, B, S, torch.bfloat16, dev)
        cache = PT.shard_tree(cache, TS.cache_shardings(cfg, cache, mesh, prof))
        prefill, decode = TS.make_serve_steps(cfg, kv_chunk=args.kv_chunk,
                                              cast_weights=prof.fsdp, mesh=mesh, prof=prof)
        if cell.kind == "prefill":
            def run():
                return prefill(params, tokens[:, :S].to(dev), cache)[0]
        else:
            def run():
                return decode(params, tokens[:, S].to(dev), S - 1, cache)[0]
    with torch.no_grad() if cell.kind != "train" else contextlib.nullcontext():
        with collectives_recorded() as entries, dtensor_collectives() as comm:
            res = run()
    counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    label = f"{args.arch}{' (smoke)' if args.smoke else ''} {cell.name}"
    lines = [f"{label} ({cell.kind}), repeat={args.repeat}, batch {B} x seq {S}, "
             f"{cfg.dtype}, on mesh {data}x{model} ({mesh.backend}); "
             f"profile {dataclasses.asdict(prof)}"]
    lines += top_lines(entries, args.top, f"mesh {data}x{model}, repeat={args.repeat}")
    lines.append(f"DTensor collectives by op: {counts or '(none)'}")
    if mesh.is_main:
        print("\n".join(lines), flush=True)
    out.update(entries=list(entries), counts=counts, lines=lines,
               result=({k: float(v) for k, v in res.items()} if isinstance(res, dict)
                       else PT.gather_tensor(res)))
    return out


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True,
                    help="tnn-mnist, or an LM of the registry (with --cell)")
    ap.add_argument("--cell", default=None, help="LM: the shape-grid cell whose "
                    "step kind (train, prefill, decode) and profile to probe")
    ap.add_argument("--repeat", type=int, default=1,
                    help="LM: trunk units kept (the reference's cost probe's)")
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--seq-parallel", type=int, default=0)
    ap.add_argument("--smoke", action="store_true", help="LM: its smoke config")
    ap.add_argument("--seq", type=int, default=128, help="LM: tokens a row")
    ap.add_argument("--kv-chunk", type=int, default=512)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"),
                    help="LM compute dtype")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--mesh", default="2x2", metavar="DxM",
                    help="(data, model) process mesh")
    ap.add_argument("--sites", type=int, default=16)
    ap.add_argument("--impl", default="fused",
                    choices=("direct", "matmul", "pallas", "fused"))
    ap.add_argument("--batch", type=int, default=8, help="images (TNN) or rows (LM)")
    ap.add_argument("--waves", type=int, default=4,
                    help="superbatch K of the probed dispatch")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    from repro_torch.configs import ARCHS, SHAPE_GRID

    if args.arch != "tnn-mnist" and args.arch not in ARCHS:
        ap.error(f"--arch {args.arch}: unknown arch; choose tnn-mnist or from {ARCHS}")
    cells = [c.name for c in SHAPE_GRID]
    if args.arch != "tnn-mnist" and args.cell not in cells:
        ap.error(f"--cell is required for an LM probe: one of {cells}")
    return args


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    if args.arch == "tnn-mnist":
        return probe_tnn(args)
    return probe_lm(args)


if __name__ == "__main__":
    main()
