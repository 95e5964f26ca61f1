"""The ("data", "model") device mesh on ``torch.distributed``, as the
reference's ``repro.launch.mesh``.

One process per rank. Rank ``r`` sits at ``(d, m) = divmod(r, n_model)`` of
the (data, model) grid, the row-major order in which the reference reshapes
its devices. Batch rows shard over "data", TNN sites over "model". The
cascade is same-site, so a learning step needs one collective only: the
``all_reduce(SUM)`` of each layer's int32 STDP counters over the data group
(:meth:`Mesh2D.all_reduce_sum`). Serving gathers the last layer's spike
times over both axes (:meth:`Mesh2D.gather_grid`); checkpoints and
evaluation gather the weights over the model axis
(:meth:`Mesh2D.gather_sites`); the engine's stats and the checkpoint step a
restore reads are broadcast from rank 0 (:meth:`Mesh2D.broadcast`). Every
collective is noted by ``utils.tracing``'s recorder, even over a group of
one (where a sum is not issued: it would move nothing). No kernel does
remote copies.

The backend is the caller's, never switched: ``"nccl"`` is the default for
``device="cuda"`` (one card per rank) and ``"gloo"`` for ``device="cpu"``.
NCCL refuses two ranks on one card ("Duplicate GPU detected"), so a mesh
of more ranks than visible cards under NCCL raises and names
``backend="gloo"``: gloo over CUDA tensors is the transport when ranks
share one card. Gloo takes CUDA tensors for every collective the mesh
issues (``all_reduce``, ``all_gather`` and ``broadcast``, int32, uint8,
int8, int64 and float64; checked on an H100 by ``chip_smoke.py``'s mesh
phase), so no collective is copied through the host on any backend.

Ranks start under ``torchrun --nproc-per-node D*M`` for the launchers
(``init_method="env://"``), and through :func:`spawn_ranks` with a
``FileStore`` (no ports) for tests and ``chip_smoke.py``. The production
meshes of the reference (16x16 and 2x16x16) need 256 and 512 cards; the
port builds process meshes of what one host has.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import re
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.utils import tracing

_MESH_RE = re.compile(r"^(\d+)x(\d+)$")
BACKENDS = ("nccl", "gloo")


def parse_mesh(spec: str) -> Tuple[int, int]:
    """Parse a ``--mesh DxM`` factorization string ("2x2" -> (2, 2)).
    Rejects anything that is not two positive integers joined by "x"."""
    m = _MESH_RE.match(spec.strip().lower())
    if not m:
        raise ValueError(
            f"--mesh wants DxM (two positive integers, e.g. 4x1, 2x2), "
            f"got {spec!r}")
    data, model = int(m.group(1)), int(m.group(2))
    if data < 1 or model < 1:
        raise ValueError(f"--mesh axes must be >= 1, got {data}x{model}")
    return data, model


@dataclasses.dataclass
class Mesh2D:
    """A (data, model) process mesh: this rank's place in it, its device,
    the backend and the three process groups its collectives run over."""

    n_data: int
    n_model: int
    rank: int
    backend: str
    device: torch.device
    data_group: Any          # this rank's column of the grid (same m)
    model_group: Any         # this rank's row of the grid (same d)
    world_group: Any
    _device_mesh: Any = dataclasses.field(default=None, repr=False)

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def device_mesh(self):
        """This mesh as a ``torch.distributed`` ``DeviceMesh`` with dims
        ("data", "model"), over the mesh's own groups and rank order (what
        DTensor places LM tensors on); made on first use."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh

            if self.backend == "gloo" and self.device.type == "cuda":
                from repro_torch.sharding import gloo_cuda

                gloo_cuda.install()
            grid = torch.arange(self.size).reshape(self.n_data, self.n_model)
            self._device_mesh = DeviceMesh.from_group(
                [self.data_group, self.model_group], self.device.type, mesh=grid,
                mesh_dim_names=("data", "model"))
        return self._device_mesh

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def is_main(self) -> bool:
        """Rank 0: the rank that writes checkpoints and prints."""
        return self.rank == 0

    def _group(self, axis: str):
        return {"data": self.data_group, "model": self.model_group,
                "world": self.world_group}[axis]

    def _group_size(self, axis: str) -> int:
        return {"data": self.n_data, "model": self.n_model,
                "world": self.size}[axis]

    # -- the collectives ------------------------------------------------------

    def all_reduce_sum(self, t: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """Sum ``t`` over ``axis``'s group, in place; returns ``t``. Over a
        group of one the sum is ``t`` itself: recorded, not issued (a
        learning wave reduces each layer's counters, and under 1xM meshes
        the data group is one rank)."""
        g = self._group_size(axis)
        tracing.record_collective("all-reduce", t.dtype, tuple(t.shape), g)
        if g > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self._group(axis))
        return t

    def all_gather(self, t: torch.Tensor, axis: str = "world") -> List[torch.Tensor]:
        """Every rank's ``t`` over ``axis``'s group, in group-rank order (the
        grid order: d for "data", m for "model", the rank for "world")."""
        g = self._group_size(axis)
        t = t.contiguous()
        tracing.record_collective("all-gather", t.dtype, (g, *t.shape), g)
        out = [torch.empty_like(t) for _ in range(g)]
        dist.all_gather(out, t, group=self._group(axis))
        return out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place; returns ``t``."""
        tracing.record_collective("broadcast", t.dtype, tuple(t.shape), self.size)
        dist.broadcast(t, src=src, group=self.world_group)
        return t

    def broadcast_floats(self, values: Sequence[float]) -> List[float]:
        """Rank 0's float64 ``values`` on every rank."""
        t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                         device=self.device)
        return self.broadcast(t).tolist()

    # -- gathers that rebuild a logical tensor ------------------------------

    def gather_sites(self, t: torch.Tensor, spec, axis: int = 0) -> torch.Tensor:
        """The logical (unpadded) tensor from every model shard's site slice
        (``t``, ``axis`` its site axis): weights, which the data axis
        replicates."""
        pieces = self.all_gather(t, "model")
        return spec.slice_sites(torch.cat(pieces, dim=axis), axis=axis)

    def gather_grid(self, t: torch.Tensor, spec, *, row_axis: int,
                    site_axis: int) -> torch.Tensor:
        """The logical tensor from every rank's (rows, sites) window ``t``:
        spike times, sharded over both axes."""
        return spec.assemble(self.all_gather(t, "world"), row_axis=row_axis,
                             site_axis=site_axis)

    def barrier(self) -> None:
        """Wait until every rank is here (moves no data)."""
        tracing.record_collective("barrier", torch.uint8, (0,), self.size)
        dist.barrier(group=self.world_group)


def _check_cards(data: int, model: int, backend: str) -> None:
    """NCCL needs one card per rank of this host; refuse before any process
    group exists."""
    need = data * model
    local = int(os.environ.get("LOCAL_WORLD_SIZE", need))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl" and local > cards:
        raise ValueError(
            f"mesh {data}x{model} puts {local} ranks on this host but it has "
            f"{cards} CUDA card(s): backend='nccl' needs one card per rank "
            f"and refuses two ranks on one card ('Duplicate GPU detected'); "
            f"pass backend='gloo' to share a card")


def make_mesh_2d(data: int, model: int, device="cuda",
                 backend: Optional[str] = None, *, store=None,
                 rank: Optional[int] = None, world_size: Optional[int] = None,
                 timeout_s: float = 600.0) -> Mesh2D:
    """A ("data", "model") mesh of ``data * model`` ranks on ``device``.

    Starts the default process group when none exists: over ``store`` (a
    ``FileStore``) with ``rank`` and ``world_size`` when given, else from
    ``torchrun``'s environment. Its size must be ``data * model``. Each rank
    takes card ``LOCAL_RANK`` (``rank`` without torchrun) modulo the cards
    it sees. ``backend`` defaults to NCCL on the card and gloo on the CPU,
    and is never changed here."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got {data}x{model}")
    want = torch.device(device).type
    backend = backend or ("nccl" if want == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if backend == "nccl" and want != "cuda":
        raise ValueError("backend='nccl' runs on CUDA tensors: use "
                         "device='cuda', or backend='gloo' on the CPU")
    _check_cards(data, model, backend)
    dev = resolve_device(device)
    if not dist.is_initialized():
        kw = dict(timeout=datetime.timedelta(seconds=timeout_s))
        if store is not None:
            kw.update(store=store, rank=rank, world_size=world_size)
        else:
            kw.update(init_method="env://")
        dist.init_process_group(backend, **kw)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not backend={backend!r}")
    world, r = dist.get_world_size(), dist.get_rank()
    need = data * model
    if need != world:
        raise ValueError(
            f"mesh {data}x{model} needs {need} ranks but this process group "
            f"has {world} (start it with torchrun --nproc-per-node {need})")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", r))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    # every rank creates every group, in one order
    data_groups = [dist.new_group([d * model + m for d in range(data)])
                   for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)])
                    for d in range(data)]
    mesh = Mesh2D(n_data=data, n_model=model, rank=r, backend=backend,
                  device=dev, data_group=data_groups[r % model],
                  model_group=model_groups[r // model],
                  world_group=dist.group.WORLD)
    # one collective on each of this rank's groups now, so that NCCL builds
    # their communicators here and not inside the first step that uses them
    probe = torch.zeros(1, device=dev)
    for group in (mesh.data_group, mesh.model_group, mesh.world_group):
        dist.all_reduce(probe, group=group)
    return mesh


def describe(mesh: Optional[Mesh2D]) -> str:
    if mesh is None:
        return "no mesh (one process)"
    return (f"mesh{mesh.shape} on {mesh.size} ranks ({mesh.backend}, "
            f"{mesh.device.type})")


# ---------------------------------------------------------------------------
# Starting ranks without torchrun
# ---------------------------------------------------------------------------


def _rank_main(i: int, fn: Callable, world: int, path: str, out_dir: str,
               device: str, backend: Optional[str], threads: int,
               args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    store = dist.FileStore(path, world)
    dist.init_process_group(backend or ("nccl" if device == "cuda" else "gloo"),
                            store=store, rank=i, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
        out = fn(*args)
        torch.save(out, os.path.join(out_dir, f"rank_{i}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, *, work_dir: str, device: str = "cpu",
                backend: Optional[str] = None, threads: int = 0,
                timeout_s: float = 600.0, args: tuple = ()) -> List[Any]:
    """Run ``fn(*args)`` in ``world`` new processes (``spawn``) that share one
    default process group over a ``FileStore`` in ``work_dir``; ``fn``
    builds its meshes with :func:`make_mesh_2d` and returns something
    ``torch.save`` can write. Returns every rank's value, in rank order.
    A rank that raises, or the ``timeout_s`` passing, stops every rank and
    raises here. ``threads`` > 0 sets each rank's torch thread count."""
    import torch.multiprocessing as mp

    os.makedirs(work_dir, exist_ok=True)
    path = os.path.join(work_dir, "store")
    if os.path.exists(path):
        os.remove(path)
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, path, work_dir, device, backend, threads,
                          args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(work_dir, f"rank_{i}.pt"), weights_only=False)
            for i in range(world)]
