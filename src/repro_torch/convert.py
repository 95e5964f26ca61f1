"""Weights across the two packages: the reference's per-layer weights (numpy
arrays, a list of them, or its ``{"layer_NN": ...}`` tree) to the port's
int8 tensors, and back."""
from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from repro_torch.core.network import NetworkConfig
from repro_torch.device import resolve_device

ArraysOrTree = Union[Sequence[np.ndarray], Dict[str, np.ndarray]]


def params_from_numpy(arrays_or_tree: ArraysOrTree, cfg: NetworkConfig,
                      device="cuda") -> List[torch.Tensor]:
    """Per-layer weights -> list of contiguous int8 tensors on ``device``.

    Accepts a sequence of arrays in layer order or a ``layer_NN`` tree, and
    checks each layer's shape (n_cols, p, q), integer dtype and range
    [0, w_max] before converting."""
    if isinstance(arrays_or_tree, dict):
        missing = [f"layer_{i:02d}" for i in range(len(cfg.layers))
                   if f"layer_{i:02d}" not in arrays_or_tree]
        if missing or len(arrays_or_tree) != len(cfg.layers):
            raise KeyError(f"tree {sorted(arrays_or_tree)} does not hold "
                           f"exactly layer_00..layer_{len(cfg.layers) - 1:02d}")
        arrays = [arrays_or_tree[f"layer_{i:02d}"] for i in range(len(cfg.layers))]
    else:
        arrays = list(arrays_or_tree)
        if len(arrays) != len(cfg.layers):
            raise ValueError(f"{len(arrays)} weight arrays for "
                             f"{len(cfg.layers)} layers")
    dev = resolve_device(device)
    out = []
    for i, (a, lcfg) in enumerate(zip(arrays, cfg.layers)):
        a = np.asarray(a)
        want = (lcfg.n_cols, lcfg.column.p, lcfg.column.q)
        if a.shape != want:
            raise ValueError(f"layer {i}: shape {a.shape} != {want}")
        if not np.issubdtype(a.dtype, np.integer):
            raise TypeError(f"layer {i}: weights must be integers, got {a.dtype}")
        w_max = lcfg.column.wave.w_max
        if a.size and (a.min() < 0 or a.max() > w_max):
            raise ValueError(f"layer {i}: weights outside [0, {w_max}]")
        out.append(torch.from_numpy(a.astype(np.int8)).to(dev).contiguous())
    return out


def params_to_numpy(params: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """The inverse: per-layer int8 numpy arrays (copied to the host)."""
    return [w.detach().to("cpu").numpy().astype(np.int8) for w in params]
