"""TNN-as-a-service launcher: the paper's prototype classified through the
port's fused wave kernel on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tnn-mnist \
        --sites 625 --slots 64 --requests 512 --train-waves 4 --impl fused

The sequence is the reference launcher's (``repro.launch.serve``, tnn half):
random weights from a seed, ``--train-waves`` unsupervised STDP warm-up
waves on 16 encoded labelled images (the wave kernel's learning half),
``fit`` on ``digits(max(128, 4 * slots), seed=1)``, then serve
``digits(requests, seed=2)`` through the continuous-batching engine.
``--device cpu`` runs the same sequence on the plain PyTorch path; the
weights and uniforms are drawn on the host, so both devices compute the
same bits.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.tnn_mnist import crop_field, launcher_network_config
from repro_torch.core.network import (
    encode_images, init_network, network_forward, network_train_wave,
)
from repro_torch.data.mnist_like import digits
from repro_torch.device import resolve_device
from repro_torch.serve.tnn_engine import ClassifyRequest, ServeStats, TNNEngine

WARMUP_ROWS = 16


@dataclasses.dataclass
class ServeReport:
    """What one launcher run produced."""

    params: List[torch.Tensor]            # weights after the warm-up waves
    vote_table: torch.Tensor
    results: Dict[int, int]               # uid -> class id
    labels: np.ndarray                    # the requests' true labels
    stats: ServeStats
    accuracy: float
    warmup_spikes: List[List[int]]        # per warm-up wave, spikes per layer
    served_spikes: List[int]              # spikes per layer over the first wave of requests


def spike_counts(zs: Sequence[torch.Tensor], T: int) -> List[int]:
    """Number of spikes (z < T) per layer."""
    return [int((z.to(torch.int32) < T).sum()) for z in zs]


def serve_tnn(args: argparse.Namespace) -> ServeReport:
    device = resolve_device(args.device)
    cfg = launcher_network_config(args.sites, depth=args.depth,
                                  impl=args.impl, packed=args.packed)
    T = cfg.layers[0].column.wave.T
    print(f"serving tnn-mnist ({cfg.n_neurons:,} neurons, impl={args.impl}) "
          f"on {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    lab_imgs, lab_labs = digits(max(128, 4 * args.slots), seed=1)
    lab_imgs = crop_field(lab_imgs, args.sites)

    params = init_network(torch.Generator().manual_seed(0), cfg, device)
    x = encode_images(torch.from_numpy(lab_imgs).to(device), cfg)
    gen = torch.Generator().manual_seed(1)  # host draws: same bits on any device
    warmup_spikes = []
    for _ in range(args.train_waves):  # short unsupervised warm-up
        zs, params = network_train_wave(x[:WARMUP_ROWS], params, cfg, gen)
        warmup_spikes.append(spike_counts(zs, T))

    eng = TNNEngine(cfg, params, n_slots=args.slots, impl=args.impl,
                    device=device)
    eng.fit(lab_imgs, lab_labs)

    test_imgs, test_labs = digits(args.requests, seed=2)
    test_imgs = crop_field(test_imgs, args.sites)
    for uid in range(args.requests):
        eng.submit(ClassifyRequest(uid=uid, image=test_imgs[uid]))
    done = eng.run_until_done(pipelined=not args.lockstep)
    st = eng.stats()
    results = {u: done[u].result for u in sorted(done)}
    acc = float(np.mean([results[u] == test_labs[u] for u in results]))
    first = encode_images(torch.from_numpy(
        np.ascontiguousarray(test_imgs[:args.slots])).to(device), cfg)
    served_spikes = spike_counts(network_forward(first, params, cfg), T)

    mode = "lock-step" if args.lockstep else "pipelined"
    print(f"served {len(done)} images in {st.waves} waves / {st.wall_s:.3f}s "
          f"({mode}), accuracy {acc:.1%}")
    print(f"[serve-stats] {st.waves_per_s:.1f} waves/s  "
          f"{st.images_per_s:.1f} images/s  p50 {st.p50_ms:.3f} ms  "
          f"p95 {st.p95_ms:.3f} ms  occupancy {st.occupancy:.0%}")
    print(f"[spikes] warm-up waves (per layer): {warmup_spikes}; first "
          f"served wave (per layer): {served_spikes}")
    return ServeReport(params=params, vote_table=eng.vote_table,
                       results=results, labels=test_labs, stats=st,
                       accuracy=acc, warmup_spikes=warmup_spikes,
                       served_spikes=served_spikes)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tnn-mnist", choices=("tnn-mnist",),
                    help="the port serves the TNN prototype only")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--sites", type=int, default=64,
                    help="patch sites, a perfect square (625 = full width)")
    ap.add_argument("--depth", type=int, default=2,
                    help="cascade depth: 2 = the paper prototype, other "
                         "depths build the deep_config N-layer cascade")
    ap.add_argument("--impl", default="fused", choices=("direct", "fused"),
                    help="'fused' = one wave-kernel launch per gamma wave; "
                         "'direct' = the plain per-layer reference")
    ap.add_argument("--train-waves", type=int, default=4)
    ap.add_argument("--packed", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="kept for config parity with the reference; the "
                         "kernel's IO is uint8/int8 either way")
    ap.add_argument("--lockstep", action="store_true",
                    help="serve with the blocking one-wave-at-a-time loop "
                         "instead of the continuous-batching pipeline")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> ServeReport:
    return serve_tnn(parse_args(argv))


if __name__ == "__main__":
    main()
