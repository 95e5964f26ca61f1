"""Weights and training states across the two packages: the reference's
per-layer weights (numpy arrays, a list of them, or its ``{"layer_NN": ...}``
tree) to the port's int8 tensors, and back; its training state (params
tree, key data, wave counter) to the port's state, and back; a state
into a mesh rank's local, site-padded shard, and back through the gather;
an LM's param tree (``lm_params_from_numpy`` / ``lm_params_to_numpy``),
name for name; and an LM's training state, params, optimizer state and step
(``lm_state_from_numpy`` / ``lm_state_to_numpy``)."""
from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from repro_torch import random as _random
from repro_torch.checkpoint.checkpointer import LeafSpec, lm_abstract_state
from repro_torch.core.network import (
    NetworkConfig, local_tree, logical_params, params_to_tree,
)
from repro_torch.device import resolve_device
from repro_torch.models.model import build_specs
from repro_torch.models.params import is_spec, tree_flatten, tree_map, tree_map_with_path

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


def state_from_numpy(tree: Dict, cfg: NetworkConfig, device="cuda") -> Dict:
    """A training state as numpy (the reference's ``init_train_state`` /
    ``make_train_step`` state after ``np.asarray``: ``{"params": {"layer_NN":
    ...}, "rng": (2,) uint32 key data, "wave": int32}``) -> the port's state:
    the weights on ``device``, the key and the wave counter on the host. Other
    leaves (a checkpoint's ``vote_table``) come along as float32 on
    ``device``."""
    dev = resolve_device(device)
    params = params_from_numpy(tree["params"], cfg, dev)
    out = {"params": {f"layer_{i:02d}": w for i, w in enumerate(params)},
           "rng": _random.as_key(np.asarray(tree["rng"])),
           "wave": torch.tensor(int(np.asarray(tree["wave"])), dtype=torch.int32)}
    if out["rng"].shape != (2,):
        raise ValueError(f"rng: one key is (2,), got {tuple(out['rng'].shape)}")
    for name, v in tree.items():
        if name not in out:
            out[name] = torch.from_numpy(np.asarray(v, np.float32)).to(dev)
    return out


def state_to_numpy(state: Dict) -> Dict:
    """The inverse: the reference's numpy form of a training state (int8
    weights, uint32 key data, int32 wave; any other leaf as float32)."""
    out = {"params": {k: w.detach().to("cpu").numpy().astype(np.int8)
                      for k, w in sorted(state["params"].items())},
           "rng": _random.as_key(state["rng"]).numpy().astype(np.uint32),
           "wave": np.asarray(int(state["wave"]), np.int32)}
    for name, v in state.items():
        if name not in out:
            out[name] = np.asarray(v.detach().to("cpu").numpy()
                                   if isinstance(v, torch.Tensor) else v, np.float32)
    return out


def params_from_local(params: Sequence[torch.Tensor], cfg: NetworkConfig,
                      mesh) -> List[np.ndarray]:
    """A rank's local weights -> the logical per-layer int8 numpy arrays,
    through the gather over the model axis (a collective: every rank calls
    it)."""
    return params_to_numpy(logical_params(params_to_tree(params), cfg, mesh))


def state_to_local(tree: Dict, cfg: NetworkConfig, mesh) -> Dict:
    """A training state as numpy (as :func:`state_from_numpy` takes it) ->
    this rank's local state: site-padded weight slices on the mesh's
    device, the key and wave counter replicated on the host."""
    state = state_from_numpy(tree, cfg, mesh.device)
    return dict(state, params=local_tree(state["params"], cfg, mesh))


def state_from_local(state: Dict, cfg: NetworkConfig, mesh) -> Dict:
    """The inverse (a collective): the reference's numpy form of a rank's
    local state, its weights gathered to the logical extent."""
    return state_to_numpy(dict(state, params=params_to_tree(
        logical_params(state["params"], cfg, mesh))))


def lm_params_from_numpy(tree: Dict, cfg, device="cuda") -> Dict:
    """An LM param tree as numpy (the reference's ``init_params`` after
    ``jax.tree.map(np.asarray, ...)``) -> the port's tree of float32 tensors
    on ``device``. The tree must hold exactly the leaves of
    ``build_specs(cfg)``, at their shapes."""
    dev = resolve_device(device)
    specs = build_specs(cfg)
    want = {path: s.shape for path, s in tree_flatten(specs, is_spec)}
    got = {path: np.shape(a) for path, a in tree_flatten(tree)}
    if set(got) != set(want):
        raise KeyError(f"leaves differ from {cfg.name}'s: missing "
                       f"{sorted(set(want) - set(got))}, extra {sorted(set(got) - set(want))}")
    for path, shape in want.items():
        if tuple(got[path]) != tuple(shape):
            raise ValueError(f"{'/'.join(map(str, path))}: shape {got[path]} != {shape}")

    def leaf(path, _spec):
        a = tree
        for k in path:
            a = a[k]
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dev)

    return tree_map_with_path(leaf, specs, is_spec)


def lm_params_to_numpy(params: Dict) -> Dict:
    """The inverse: the same tree as float32 numpy arrays on the host."""
    return tree_map(lambda t: t.detach().to("cpu", torch.float32).numpy(), params)


def lm_state_from_numpy(tree: Dict, cfg, opt_cfg, device="cuda") -> Dict:
    """An LM training state as numpy (the reference's ``init_state`` or
    ``Trainer`` state after ``jax.tree.map(np.asarray, ...)``, or a restored
    checkpoint: ``{"params", "opt", "step"}``) -> the port's state: float32
    params and optimizer moments on ``device``, the int32 ``count`` and
    ``step`` on the host. The tree must hold exactly the leaves of
    ``lm_abstract_state(cfg, opt_cfg)``, at their shapes and dtypes."""
    dev = resolve_device(device)
    abstract = lm_abstract_state(cfg, opt_cfg)
    is_leaf = lambda x: isinstance(x, LeafSpec)  # noqa: E731
    want = dict(tree_flatten(abstract, is_leaf))
    got = dict(tree_flatten(tree, lambda x: isinstance(x, np.ndarray)))
    if set(got) != set(want):
        raise KeyError(f"leaves differ from {cfg.name}'s {opt_cfg.name} state: missing "
                       f"{sorted(set(want) - set(got))}, extra {sorted(set(got) - set(want))}")
    out = {}
    for path, spec in want.items():
        a = np.asarray(got[path])
        if tuple(a.shape) != tuple(spec.shape) or a.dtype != spec.dtype:
            raise ValueError(f"{'/'.join(map(str, path))}: {a.dtype}{list(a.shape)} != "
                             f"{spec.dtype}{list(spec.shape)}")
        t = torch.from_numpy(a.copy())
        out[path] = t if a.dtype == np.int32 else t.to(dev)
    return tree_map_with_path(lambda path, _: out[path], abstract, is_leaf)


def lm_state_to_numpy(state: Dict) -> Dict:
    """The inverse: the same tree as numpy on the host (float32 leaves,
    int32 ``count`` and ``step``)."""
    return tree_map(lambda t: t.detach().to("cpu").numpy().copy(), state)
