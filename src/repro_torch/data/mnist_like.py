"""Deterministic MNIST-like digit generator (offline substitute).

A copy of ``repro.data.mnist_like``: importing that module would import the
JAX package, which the port never does. The two give identical arrays for
the same ``(n, seed)``; the tests hold them equal.

Real MNIST is not downloadable in this container (DESIGN.md §8), so the
paper's prototype trains on structurally similar data: 10 digit classes
drawn as stroke/arc templates on a 28x28 grid, with random shifts, thickness
jitter and pixel noise. The TNN's unsupervised STDP + vote readout is
evaluated as cluster purity / voted accuracy on this stream; the paper's
93% MNIST claim itself is validated indirectly (see EXPERIMENTS.md).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_H = _W = 28

# 7-segment-style templates on a 28x28 canvas (segments per digit)
#   a: top, b: top-right, c: bottom-right, d: bottom, e: bottom-left,
#   f: top-left, g: middle
_SEGMENTS = {
    "a": ((5, 7), (5, 20)),
    "b": ((5, 20), (14, 20)),
    "c": ((14, 20), (23, 20)),
    "d": ((23, 7), (23, 20)),
    "e": ((14, 7), (23, 7)),
    "f": ((5, 7), (14, 7)),
    "g": ((14, 7), (14, 20)),
}
_DIGIT_SEGS = {
    0: "abcdef", 1: "bc", 2: "abged", 3: "abgcd", 4: "fgbc",
    5: "afgcd", 6: "afgedc", 7: "abc", 8: "abcdefg", 9: "abcdfg",
}


def _draw_line(img: np.ndarray, p0, p1, thick: int) -> None:
    (r0, c0), (r1, c1) = p0, p1
    n = max(abs(r1 - r0), abs(c1 - c0)) + 1
    rs = np.linspace(r0, r1, n).round().astype(int)
    cs = np.linspace(c0, c1, n).round().astype(int)
    for dr in range(-thick // 2, thick // 2 + 1):
        for dc in range(-thick // 2, thick // 2 + 1):
            r = np.clip(rs + dr, 0, _H - 1)
            c = np.clip(cs + dc, 0, _W - 1)
            img[r, c] = 1.0


def digits(n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images (n, 28, 28) float in [0,1], labels (n,) int)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    imgs = np.zeros((n, _H, _W), np.float32)
    for i, lab in enumerate(labels):
        img = np.zeros((_H, _W), np.float32)
        thick = int(rng.integers(1, 3))
        for seg in _DIGIT_SEGS[int(lab)]:
            _draw_line(img, *_SEGMENTS[seg], thick=thick)
        # random shift
        dr, dc = rng.integers(-2, 3, 2)
        img = np.roll(np.roll(img, dr, axis=0), dc, axis=1)
        # blur-ish dilation + noise
        img = np.clip(img + 0.25 * np.roll(img, 1, 0) + 0.25 * np.roll(img, 1, 1), 0, 1)
        noise = rng.random((_H, _W)) < 0.02
        img = np.clip(img + noise * rng.random((_H, _W)), 0, 1)
        imgs[i] = img
    return imgs, labels.astype(np.int32)
