"""The paper's end-to-end run on the port, as the reference's
``examples/tnn_mnist.py``: the 2-layer prototype (625 x (32x12) -> 625 x
(12x10), 13,750 neurons, 315,000 synapses) trained with unsupervised STDP
on MNIST-like digits, read out by the site vote and by the winner-bit
centroid, and priced by the calibrated 7 nm PPA model (Tables I and II).

    PYTHONPATH=src python -m repro_torch.launch.tnn_mnist --train 512 --waves 8

The flags are the reference's, and ``--device`` (the card by default;
``--device cpu`` runs the plain PyTorch path). The weights come from
``PRNGKey(0)``, wave ``i`` learns on the second half of the ``i``-th split
of the chain from ``PRNGKey(1)``, on rows ``(i * B) % max(train - B, 1)``
onwards: the reference's sequence, so the same bits on every backend and
device.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import random as _random
from repro_torch.core import hwmodel
from repro_torch.core.network import (
    build_centroids, build_vote_table, classify, classify_centroid,
    encode_images, init_network, network_forward, network_train_wave,
    prototype_config, with_impl,
)
from repro_torch.data.mnist_like import digits
from repro_torch.device import resolve_device


def ppa_lines() -> list:
    """The PPA model's prototype lines for both libraries, and the paper's
    Table II beside them."""
    out = []
    for lib in ("standard", "custom"):
        ppa = hwmodel.prototype_ppa(lib)
        out.append(f"7nm {lib:8s}: {ppa.power_mw:.2f} mW, {ppa.time_ns:.2f} ns/image, "
                   f"{ppa.area_mm2:.2f} mm2, EDP {ppa.power_mw * ppa.time_ns ** 2 * 1e-3:.2f} nJ-ns")
    out.append("(paper Table II: standard 2.54/24.14/2.36/1.48, custom 1.69/19.15/1.56/0.62)")
    return out


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train", type=int, default=512)
    ap.add_argument("--test", type=int, default=256)
    ap.add_argument("--waves", type=int, default=60)
    ap.add_argument("--wave-batch", type=int, default=16)
    ap.add_argument("--theta1", type=int, default=12)
    ap.add_argument("--theta2", type=int, default=3)
    ap.add_argument("--impl", default="direct",
                    choices=("direct", "matmul", "pallas", "fused"),
                    help="backend: pallas = the per-layer kernels, fused = "
                         "one wave-kernel launch per wave")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = with_impl(prototype_config(theta1=args.theta1, theta2=args.theta2),
                    args.impl)
    print(f"prototype: {cfg.n_neurons:,} neurons, {cfg.n_synapses:,} synapses "
          f"(impl={args.impl}, {device.type})")
    params = init_network(_random.PRNGKey(0), cfg, device)

    imgs, labs = digits(args.train, seed=1)
    x = encode_images(torch.from_numpy(imgs).to(device), cfg)
    key = _random.PRNGKey(1)
    bs = args.wave_batch
    t0 = time.perf_counter()
    for i in range(args.waves):
        key, k = _random.split(key)
        o = (i * bs) % max(args.train - bs, 1)
        _, params = network_train_wave(x[o:o + bs], params, cfg, k)
        if (i + 1) % 10 == 0:
            print(f"wave {i + 1}/{args.waves} done ({time.perf_counter() - t0:.1f}s)")
    if device.type == "cuda":
        torch.cuda.synchronize()
    ms_wave = 1e3 * (time.perf_counter() - t0) / max(args.waves, 1)
    print(f"training: {ms_wave:.3f} ms/gamma-wave (impl={args.impl})")

    T = cfg.layers[-1].column.wave.T
    z_train = network_forward(x, params, cfg)[-1]
    labels = torch.as_tensor(labs, dtype=torch.int64, device=device)
    vt = build_vote_table(z_train, labels, cfg.n_classes, T)
    cents = build_centroids(z_train, labels, cfg.n_classes, T)
    ti, tl = digits(args.test, seed=2)
    z_test = network_forward(encode_images(torch.from_numpy(ti).to(device), cfg),
                             params, cfg)[-1]
    acc = float((classify(z_test, vt, T).cpu().numpy() == tl).mean())
    acc_c = float((classify_centroid(z_test, cents, T).cpu().numpy() == tl).mean())
    w1 = params[0].cpu().numpy().astype(np.int32)
    rails = float(np.mean((w1 <= 1) | (w1 >= 6)))
    print(f"\nsoft-vote accuracy on held-out digits: {acc:.1%} (chance 10%)")
    print(f"centroid (winner-bit) accuracy:         {acc_c:.1%}")
    print(f"layer-1 weight bimodality: {rails:.0%} at rails")
    lines = ppa_lines()
    for line in lines:
        print(line)
    return {"params": params, "vote_table": vt, "centroids": cents,
            "accuracy": acc, "centroid_accuracy": acc_c, "rails": rails,
            "ms_per_wave": ms_wave, "ppa": lines}


if __name__ == "__main__":
    main()
