"""Logical-axis sharding context, as ``repro.sharding.context``.

Model code annotates activations with *logical* axis names
(``shard_activation(x, ("batch", "seq", "embed"))``). A launcher installs a
mesh and a rule set with :func:`use_partitioning`; outside any context, and
on a tensor that is not a DTensor, an annotation returns its argument, so
the same model code runs in one process unchanged.

Inside a context a DTensor annotation is a ``redistribute`` to the rule's
placements: a dimension whose rule group divides it is sharded over the
group, every other dimension is replicated (as the reference's
``with_sharding_constraint`` of ``P(None)`` replicates it), and a partial
sum is made whole. The context also enters DTensor's
``implicit_replication``: a plain tensor the model makes (positions, RoPE
tables, masks) meets a DTensor as a replicated one, which it is, since
every rank makes the same.
"""
from __future__ import annotations

import contextlib
import types
from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch.sharding.partition import mesh_shape, placements

MeshAxes = Union[None, str, Tuple[str, ...]]

# one state for the process, not a thread's: the autograd engine runs a
# CUDA backward (and remat's recompute in it) in its own thread
_state = types.SimpleNamespace(rules=None, mesh=None)


def _rules() -> Optional[Dict[str, MeshAxes]]:
    return _state.rules


def _mesh():
    return _state.mesh


@contextlib.contextmanager
def use_partitioning(mesh, rules: Dict[str, MeshAxes]):
    """Install ``mesh`` (a ``DeviceMesh`` with dims named by mesh axes, or a
    shape mapping for rules alone) and logical -> mesh rules for the
    enclosed calls."""
    prev = (_rules(), _mesh())
    _state.rules, _state.mesh = dict(rules), mesh
    try:
        if hasattr(mesh, "mesh_dim_names"):
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                yield
        else:
            yield
    finally:
        _state.rules, _state.mesh = prev


def active() -> bool:
    return _rules() is not None and _mesh() is not None


def logical_to_spec(axes: Sequence[Optional[str]], rules=None, mesh=None) -> Tuple:
    """Logical axis names -> a spec under the current rules, names only (the
    divisibility check is ``partition.spec_for``'s)."""
    rules = rules if rules is not None else (_rules() or {})
    return tuple(rules.get(name) if name else None for name in axes)


def _spec(shape, axes, mshape, rules) -> Tuple:
    parts = []
    for dim, name in zip(shape, axes):
        assign = rules.get(name) if name else None
        if assign is None:
            parts.append(None)
            continue
        group = (assign,) if isinstance(assign, str) else tuple(assign)
        group = tuple(a for a in group if a in mshape)  # smaller meshes
        size = 1
        for a in group:
            size *= mshape[a]
        # only constrain where the group divides the dimension
        if not group or dim % size or size == 1:
            parts.append(None)
        else:
            parts.append(group if len(group) > 1 else group[0])
    return tuple(parts)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard_activation(x, axes: Sequence[Optional[str]]):
    """Constrain an activation's sharding by logical axes (returns ``x``
    outside a context or when ``x`` is not a DTensor)."""
    if not active() or not _is_dtensor(x):
        return x
    dm = x.device_mesh
    spec = _spec(tuple(x.shape), axes, mesh_shape(dm), _rules())
    want = placements(spec, dm)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(dm, want)


def replicate(x):
    """``x`` whole on every rank (a DTensor all-gathered and made whole; any
    other value as it is): around an op DTensor has no sharding rule for,
    or one whose rule is wrong on a 2-D mesh."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    want = tuple(Replicate() for _ in x.placements)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)
