"""Launch counts of the port's hand-written kernels.

:func:`kernel_launch_count` is the port's counterpart of the reference's
``pallas_launch_count``: where the reference counts ``pallas_call``
equations in a jaxpr, the port counts the launches its kernel wrappers make
during one call, from the wrappers' ``LAUNCHES`` counters (each wrapper adds
one where it launches its kernel, and nowhere else; a plain version on the
CPU launches nothing). Under ``impl="pallas"`` a learning wave of an
N-layer cascade launches N column, N STDP and N threefry kernels; under
``impl="fused"`` one wave kernel and N threefry draws; a "seq" or "gauss"
network launches N column kernels and N threefry draws, and no wave or
STDP kernel.

:func:`collectives_recorded` records the collectives ``launch.mesh`` issues
(kind, dtype, result shape, group size), which ``roofline.analysis``
prices with the reference's ring model. :func:`dtensor_collectives` adds
the collectives DTensor issues for the sharded LM steps (its
redistributions' functional collectives), through a
``CommDebugMode``, which also counts them by op.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.kernels import stdp_update, threefry, tnn_column, tnn_wave, wta


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    tnn_wave.LAUNCHES.reset()
    for mod in (tnn_column, stdp_update, wta, threefry):
        mod.LAUNCHES.reset()


def read_counts() -> Dict[str, int]:
    """Every kernel's launch count, by name (the wave kernel's two halves
    apart)."""
    return {"tnn_wave[forward]": tnn_wave.LAUNCHES.forward,
            "tnn_wave[learn]": tnn_wave.LAUNCHES.learn,
            "tnn_column": tnn_column.LAUNCHES.n,
            "stdp_update": stdp_update.LAUNCHES.n, "wta": wta.LAUNCHES.n,
            "threefry": threefry.LAUNCHES.n}


def kernel_launch_count(fn: Callable, *args, **kwargs) -> Tuple[Dict[str, int], object]:
    """Call ``fn(*args, **kwargs)`` with every count set to 0 just before it
    and read just after; returns ``(launches by kernel, fn's result)``.
    The counts are left as the call made them."""
    reset_counts()
    out = fn(*args, **kwargs)
    return read_counts(), out


# ---------------------------------------------------------------------------
# The collectives the mesh issues
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CollectiveEntry:
    """One collective as ``launch.mesh`` issued it: its kind (the
    reference's HLO names: "all-reduce", "all-gather"; and "broadcast"), the
    element type, the RESULT shape (an all-gather's gathered extent, as HLO
    writes it) and the group size."""

    kind: str
    dtype: torch.dtype
    shape: Tuple[int, ...]
    group: int


_RECORDER: Optional[List[CollectiveEntry]] = None


def record_collective(kind: str, dtype: torch.dtype, shape: Tuple[int, ...],
                      group: int) -> None:
    """Note one collective while a :func:`collectives_recorded` block is
    open (nothing otherwise)."""
    if _RECORDER is not None:
        _RECORDER.append(CollectiveEntry(kind, dtype, tuple(int(s) for s in shape),
                                         int(group)))


@contextlib.contextmanager
def collectives_recorded() -> Iterator[List[CollectiveEntry]]:
    """Record every collective issued inside the block into the yielded
    list: the port's counterpart of reading them off compiled HLO."""
    global _RECORDER
    outer, _RECORDER = _RECORDER, []
    try:
        yield _RECORDER
    finally:
        entries, _RECORDER = _RECORDER, outer
        if outer is not None:
            outer.extend(entries)


# DTensor's functional collectives, by the reference's HLO names
_FUNCTIONAL_KINDS = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
                     "reduce_scatter_tensor": "reduce-scatter",
                     "all_to_all_single": "all-to-all", "broadcast": "broadcast"}


def _group_size(func_name: str, args) -> int:
    if func_name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return int(args[-2])
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(args[-1]).size()


@contextlib.contextmanager
def dtensor_collectives():
    """Inside the block, every functional collective DTensor issues (an
    all-gather, all-reduce, reduce-scatter, all-to-all or broadcast of a
    redistribution) is noted by :func:`record_collective` with its result's
    type and shape and its group's size. Yields the ``CommDebugMode`` that
    watched them (``get_comm_counts()``)."""
    from torch.distributed.tensor.debug import CommDebugMode

    class _Mode(CommDebugMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if func.namespace == "_c10d_functional":
                name = func.overloadpacket.__name__
                kind = _FUNCTIONAL_KINDS.get(name)
                if kind is not None:
                    record_collective(kind, out.dtype, tuple(out.shape),
                                      _group_size(name, args))
            return out

    with _Mode() as mode:
        yield mode
