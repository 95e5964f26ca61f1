"""Parameter specification trees: the shape, logical axes and initialization
of every LM parameter, as ``repro.models.params`` declares them.

A model is a nested dict of :class:`ParamSpec`. :func:`tree_init` draws it
bit for bit as the reference's ``tree_init``: the leaves in
``jax.tree.flatten`` order (dict keys sorted), one key each from
``split(key, n_leaves)``, and a normal leaf is ``f32(std) * normal(key,
shape)`` with ``std = min(0.02, (1 / max(fan_in, 1)) ** 0.5)`` in Python
floats. The draws run on the device of the call, a chunk of
:data:`DRAW_CHUNK` floats at a time (the counter offset of
``random.normal``), so a leaf of hundreds of millions of floats never
materialises its indices and threefry temporaries at once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import random as _random
from repro_torch.device import resolve_device

DRAW_CHUNK = 1 << 24   # floats drawn per call: ~2.5 GB of float64/int64 temporaries


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis names (None = never sharded)
    init: str = "normal"  # normal | zeros | ones
    dtype: torch.dtype = torch.float32
    scale: Optional[float] = None  # stddev override for init

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"axes {self.axes} do not match shape {self.shape}")

    @property
    def std(self) -> float:
        """The normal leaf's standard deviation: ``scale``, else the fan-in
        rule (the first axis is the fan-in by convention)."""
        if self.scale is not None:
            return self.scale
        fan_in = self.shape[0] if len(self.shape) > 1 else self.shape[-1]
        return min(0.02, (1.0 / max(fan_in, 1)) ** 0.5)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_flatten(tree, is_leaf: Callable[[Any], bool] = lambda x: False
                 ) -> List[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs of a tree of dicts, tuples and lists, in
    ``jax.tree.flatten`` order: dict keys sorted, sequences in order.
    ``None`` is an empty subtree, as in jax."""
    out: List[Tuple[Tuple, Any]] = []

    def walk(node, path):
        if node is None:
            return
        if not is_leaf(node) and isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif not is_leaf(node) and isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out.append((path, node))

    walk(tree, ())
    return out


def tree_map_with_path(fn: Callable, tree, is_leaf: Callable[[Any], bool] = lambda x: False,
                       path: Tuple = ()):
    """``fn(path, leaf)`` at every leaf, keeping the dict/tuple/list
    structure (paths as in :func:`tree_flatten`)."""
    if tree is None:
        return None
    if not is_leaf(tree) and isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, is_leaf, path + (k,)) for k, v in tree.items()}
    if not is_leaf(tree) and isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, is_leaf, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_map(fn: Callable, tree, is_leaf: Callable[[Any], bool] = lambda x: False):
    """``fn`` applied to every leaf, keeping the dict/tuple/list structure."""
    return tree_map_with_path(lambda _, leaf: fn(leaf), tree, is_leaf)


def tree_abstract(specs) -> Any:
    """Spec tree -> tensors on the ``meta`` device with each spec's shape and
    dtype (the reference's ``ShapeDtypeStruct`` tree: nothing allocated)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                    specs, is_spec)


def tree_axes(specs) -> Any:
    """Spec tree -> logical-axes tree (the same structure, a tuple of axis
    names at each leaf)."""
    return tree_map(lambda s: s.axes, specs, is_spec)


def draw_normal(key, n: int, device, offset: int = 0) -> torch.Tensor:
    """Flat elements ``[offset, offset + n)`` of ``jax.random.normal(key,
    (N,))`` for any N >= offset + n, in chunks of :data:`DRAW_CHUNK`."""
    out = torch.empty(n, dtype=torch.float32, device=device)
    for lo in range(0, n, DRAW_CHUNK):
        hi = min(n, lo + DRAW_CHUNK)
        out[lo:hi] = _random.normal(key, (hi - lo,), device, offset=offset + lo)
    return out


def materialize(spec: ParamSpec, key, device) -> torch.Tensor:
    """One leaf of :func:`tree_init`."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init != "normal" or spec.dtype != torch.float32:
        raise ValueError(f"unsupported init {spec.init!r} at {spec.dtype}")
    out = draw_normal(key, math.prod(spec.shape), device)
    # the reference's `std * normal`: the Python float taken to float32, one
    # float32 multiply
    out.mul_(torch.tensor(spec.std, dtype=torch.float32, device=device))
    return out.reshape(spec.shape)


def tree_init(specs, key, device="cuda") -> Any:
    """Spec tree -> materialized param tree on ``device``: leaf ``i`` of the
    flatten order drawn from ``split(key, n_leaves)[i]``."""
    dev = resolve_device(device)
    keys = leaf_keys(specs, key)
    return tree_map_with_path(lambda path, s: materialize(s, keys[path], dev),
                              specs, is_spec)


def leaf_keys(specs, key) -> Dict[Tuple, torch.Tensor]:
    """Each leaf's path -> its key in :func:`tree_init`'s draw."""
    leaves = tree_flatten(specs, is_spec)
    keys = _random.split(key, len(leaves))
    return {path: keys[i] for i, (path, _) in enumerate(leaves)}


def stack_specs(spec_tree, n: int, axis_name: Optional[str] = "layers"):
    """Stack a block's spec tree n times along a new leading 'layers' axis
    (the reference scans over it; the port loops over it)."""

    def stack(s: ParamSpec) -> ParamSpec:
        return ParamSpec((n,) + s.shape, (axis_name,) + s.axes, s.init, s.dtype, s.scale)

    return tree_map(stack, spec_tree, is_spec)
