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
axis; the model axis issues nothing. Its LM half is refused: the LM
architectures wait for ROADMAP Queue 1 item 6 (LM substrate).
"""
from __future__ import annotations

import argparse
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

LM_HALF = ("the LM probe is not ported: the LM architectures wait for ROADMAP "
           "Queue 1 item 6 (LM substrate)")


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


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--mesh", default="2x2", metavar="DxM",
                    help="(data, model) factorization for the TNN probe")
    ap.add_argument("--sites", type=int, default=16)
    ap.add_argument("--impl", default="fused",
                    choices=("direct", "matmul", "pallas", "fused"))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--waves", type=int, default=4,
                    help="superbatch K of the probed dispatch")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    if args.arch != "tnn-mnist":
        raise SystemExit(f"--arch {args.arch}: {LM_HALF}")
    return probe_tnn(args)


if __name__ == "__main__":
    main()
