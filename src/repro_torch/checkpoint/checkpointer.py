"""Async, crash-atomic checkpoints on the reference's on-disk layout
(``repro.checkpoint.checkpointer``), so either package restores the other's.

Layout: ``<dir>/step_<N:08d>/`` holding ``meta.json`` (leaf paths, files,
shapes, dtypes, the step and extra metadata) and one ``.npy`` per leaf. A
leaf's path is the reference's ``jax.tree_util.keystr`` of a nested dict,
keys in sorted order (``['params']['layer_00']``, ``['rng']``,
``['vote_table']``, ``['wave']``), made here from the dict itself; its file
is ``sha1(path)[:16] + ".npy"``. Writes go to ``step_N.tmp`` and are renamed
into place; re-saving a step moves the live directory aside first, so every
visible step directory is complete at every instant.

The TNN training checkpoint is ``{"params": {"layer_NN": int8 (C, p, q)},
"rng": uint32 (2,), "wave": int32 (), "vote_table": float32 (S, q,
n_classes)}``; :func:`restore_tnn` refuses a checkpoint written for another
network (``tnn_config_fingerprint``) before it loads any array. The LM
training checkpoint is the reference ``Trainer``'s ``{"params", "opt",
"step"}`` (:func:`lm_abstract_state`), with the data cursor in ``extra``.

Checkpoints carry no mesh: on a (data, model) mesh :func:`save_tnn` gathers
the logical weights (every rank calls it) and rank 0 writes them, and
:func:`restore_tnn` reads the full tree on every rank and cuts the rank's
window, so a state saved under one factorization restores under any other
or none, file for file the reference's.

An LM state whose leaves are DTensors (``train.train_step`` on a mesh) saves
the same way: :meth:`Checkpointer.save` is then a collective that gathers
the state leaf by leaf (so a rank's device holds one whole leaf at a time),
rank 0 writes the step before every rank returns, and the files are those a
one-process run writes. :meth:`Checkpointer.restore` with ``shardings``
reads each rank's block of each leaf alone (a memory-mapped file sliced)
into a DTensor.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch


class LeafSpec(NamedTuple):
    """Shape and dtype of one checkpoint leaf (the restore target)."""

    shape: Tuple[int, ...]
    dtype: np.dtype


def tnn_abstract_state(cfg) -> Dict[str, Any]:
    """The restore target of a TNN training checkpoint: per-layer int8
    weights ``layer_NN``, the uint32 threefry key, the int32 wave counter
    and the last layer's (sites, q, n_classes) float32 vote table."""
    params = {f"layer_{i:02d}": LeafSpec((l.n_cols, l.column.p, l.column.q),
                                         np.dtype(np.int8))
              for i, l in enumerate(cfg.layers)}
    last = cfg.layers[-1]
    return {"params": params,
            "rng": LeafSpec((2,), np.dtype(np.uint32)),
            "wave": LeafSpec((), np.dtype(np.int32)),
            "vote_table": LeafSpec((last.n_cols, last.column.q, cfg.n_classes),
                                   np.dtype(np.float32))}


def lm_abstract_state(cfg, opt_cfg) -> Dict[str, Any]:
    """The restore target of an LM training checkpoint, the reference
    ``Trainer``'s state: float32 ``params`` (the spec tree of ``cfg``), the
    optimizer state of ``opt_cfg`` (AdamW ``m``/``v``, or Adafactor's
    factored ``vr``/``vc``, ``vc`` (1,) for a 1-D leaf; ``residual`` under
    gradient compression) with an int32 ``count``, and the int32 ``step``.
    Its checkpoints carry ``extra={"data_step": N}``."""
    from repro_torch.models.model import build_specs
    from repro_torch.models.params import is_spec, tree_map

    def f32(shape):
        return LeafSpec(tuple(shape), np.dtype(np.float32))

    specs = build_specs(cfg)
    params = tree_map(lambda s: f32(s.shape), specs, is_spec)
    count = LeafSpec((), np.dtype(np.int32))
    if opt_cfg.name == "adamw":
        opt: Dict[str, Any] = {"m": params, "v": params, "count": count}
    elif opt_cfg.name == "adafactor":
        opt = {"vr": tree_map(lambda s: f32(s.shape[:-1] if len(s.shape) >= 2 else s.shape),
                              specs, is_spec),
               "vc": tree_map(lambda s: f32(s.shape[:-2] + s.shape[-1:]
                                            if len(s.shape) >= 2 else (1,)), specs, is_spec),
               "count": count}
    else:
        raise ValueError(opt_cfg.name)
    if opt_cfg.compress_grads:
        opt["residual"] = params
    return {"params": params, "opt": opt, "step": count}


def tnn_config_fingerprint(cfg) -> str:
    """The network's structure and thresholds, one segment per layer, as the
    reference writes it into a checkpoint's metadata (the backend is left
    out: weights do not depend on it)."""
    layers = ";".join(
        f"{l.n_cols}x{l.column.p}x{l.column.q}t{l.column.theta}"
        for l in cfg.layers)
    T = cfg.layers[0].column.wave.T
    return f"tnn[{layers}]T{T}c{cfg.n_classes}"


def agreed_latest_step(ckpt: "Checkpointer", mesh=None) -> Optional[int]:
    """The latest step under ``ckpt``; on a mesh rank 0's (a collective),
    so every rank restores one step while rank 0 may still be writing."""
    step = ckpt.latest_step()
    if mesh is not None:
        step = int(mesh.broadcast_floats([-1 if step is None else step])[0])
        step = None if step < 0 else step
    return step


def restore_tnn(ckpt: "Checkpointer", cfg, step: Optional[int] = None,
                device="cuda", mesh=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(state, extra)`` of the TNN checkpoint at ``step`` (default: the
    latest), the state in the port's form (``convert.state_from_numpy``: the
    weights and the vote table on ``device``, the key and the wave counter
    on the host). Refuses a checkpoint whose fingerprint is not ``cfg``'s
    before loading any array. With a ``mesh`` (a collective) the latest
    step is rank 0's, and the weights are the rank's local site slices on
    the mesh's device (``convert.state_to_local``)."""
    from repro_torch.convert import state_from_numpy, state_to_local

    if step is None:
        step = agreed_latest_step(ckpt, mesh)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt.dir}")
    want = tnn_config_fingerprint(cfg)
    got = ckpt.peek_extra(step).get("config")
    if got != want:
        raise ValueError(
            f"checkpoint step {step} under {ckpt.dir!r} was written for "
            f"{got!r}, not this run's {want!r}: point it at the matching "
            f"run or a fresh directory")
    tree, extra = ckpt.restore(step, tnn_abstract_state(cfg))
    if mesh is not None:
        return state_to_local(tree, cfg, mesh), extra
    return state_from_numpy(tree, cfg, device), extra


def save_tnn(ckpt: "Checkpointer", cfg, step: int, state, extra: Dict[str, Any],
             *, mesh=None, block: bool = False) -> None:
    """Save a TNN state (the port's form; any further leaf, such as
    ``vote_table``, as it is) as ``step``. With a ``mesh`` the state holds
    the rank's local weights: every rank gathers the logical weights (a
    collective) and rank 0 alone writes; with ``block`` every rank waits
    until the step is in place."""
    if mesh is not None:
        from repro_torch.core.network import logical_params, params_to_tree

        state = dict(state, params=params_to_tree(
            logical_params(state["params"], cfg, mesh)))
        if mesh.is_main:
            ckpt.save(step, state, extra=extra, block=block)
        if block:
            mesh.barrier()
        return
    ckpt.save(step, state, extra=extra, block=block)


def _leaf_paths(tree, prefix: str = "", leaf=lambda x: False) -> List[Tuple[str, Any]]:
    """(keystr path, leaf) of a nested dict, keys in sorted order, as
    ``jax.tree_util`` flattens and names it."""
    if isinstance(tree, dict) and not leaf(tree):
        out: List[Tuple[str, Any]] = []
        for k in sorted(tree):
            out += _leaf_paths(tree[k], f"{prefix}[{k!r}]", leaf)
        return out
    return [(prefix, tree)]


def _unflatten(like, values: Dict[str, Any], prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten(like[k], values, f"{prefix}[{k!r}]") for k in like}
    return values[prefix]


def _fname(path: str) -> str:
    return hashlib.sha1(path.encode()).hexdigest()[:16] + ".npy"


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu").numpy().copy()
    return np.asarray(v)


def _is_dtensor(v) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(v, DTensor)


def _meta(step: int, leaves, extra) -> Dict[str, Any]:
    return {
        "step": int(step),
        "leaves": [{"path": p, "file": _fname(p), "shape": list(a.shape),
                    "dtype": str(a.dtype)} for p, a in leaves],
        "extra": extra or {},
    }


def _read_block(path: str, sharding) -> torch.Tensor:
    """This rank's block of the ``.npy`` at ``path`` under ``sharding`` (a
    ``sharding.partition.NamedSharding``), as a DTensor on the mesh's
    device; only the block is read."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.partition import device_mesh, local_slices

    dm = device_mesh(sharding.mesh)
    places = sharding.placements()
    arr = np.load(path, mmap_mode="r")
    block = np.ascontiguousarray(arr[local_slices(arr.shape, dm, places)])
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dm.device_type == "cuda" else torch.device("cpu"))
    return DTensor.from_local(torch.from_numpy(block).to(dev), dm, places,
                              run_check=False)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- write ---------------------------------------------------------------

    def save(self, step: int, state, extra: Optional[Dict[str, Any]] = None,
             block: bool = False) -> None:
        """Write ``state`` (a nested dict of tensors or arrays) as step
        ``step``. The leaves are copied to the host here, before the writer
        thread starts, so the caller may update its tensors in place at
        once; it writes in the background unless ``block``, and
        :meth:`wait` joins it."""
        flat = _leaf_paths(state)
        if any(_is_dtensor(v) for _, v in flat):
            self._save_sharded(step, flat, extra)
            return
        leaves = [(p, _host(v)) for p, v in flat]
        meta = _meta(step, leaves, extra)
        self.wait()
        if not block:
            self._thread = threading.Thread(
                target=self._write, args=(step, leaves, meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, leaves, meta)

    def _save_sharded(self, step: int, flat, extra) -> None:
        """Every rank gathers each leaf in turn; rank 0 keeps the host copies
        and writes them; all ranks leave once the step is in place."""
        import torch.distributed as dist

        main = dist.get_rank() == 0
        leaves = []
        for p, v in flat:
            whole = v.full_tensor() if _is_dtensor(v) else v
            if main:
                leaves.append((p, _host(whole)))
            del whole
        if main:
            self.wait()
            self._write(step, leaves, _meta(step, leaves, extra))
        dist.barrier()

    def _write(self, step: int, leaves, meta) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp, old = final + ".tmp", final + ".old"
        for stale in (tmp, old):
            if os.path.exists(stale):
                shutil.rmtree(stale)
        os.makedirs(tmp)
        for p, a in leaves:
            np.save(os.path.join(tmp, _fname(p)), a)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        # re-saving a live step: move it aside in one rename, the new one in
        # with a second, so a crash between them leaves the previous step as
        # the latest and never a half-written one
        if os.path.exists(final):
            os.rename(final, old)
        os.rename(tmp, final)
        shutil.rmtree(old, ignore_errors=True)
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # -- read ----------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def peek_extra(self, step: int) -> Dict[str, Any]:
        """A checkpoint's extra metadata, without loading any array."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "meta.json")) as f:
            return json.load(f).get("extra", {})

    def restore(self, step: int, abstract_state, shardings=None
                ) -> Tuple[Any, Dict[str, Any]]:
        """Load step ``step`` into the structure of ``abstract_state`` (a
        nested dict of :class:`LeafSpec`, or of arrays whose shapes are the
        target's); returns (the tree of numpy arrays, extra metadata). With
        ``shardings`` (a tree of ``NamedSharding`` for the state's leaves)
        each leaf of more than 0 dims is the rank's block, a DTensor."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        by_path = {l["path"]: l for l in meta["leaves"]}
        sh = dict(_leaf_paths(shardings, leaf=lambda x: hasattr(x, "spec"))
                  ) if shardings is not None else {}
        vals = {}
        for p, spec in _leaf_paths(abstract_state):
            if p not in by_path:
                raise KeyError(f"checkpoint missing leaf {p}")
            file = os.path.join(d, by_path[p]["file"])
            got = tuple(by_path[p]["shape"])
            want = tuple(spec.shape) if hasattr(spec, "shape") else got
            if got != want:
                raise ValueError(f"{p}: checkpoint shape {got} != {want}")
            vals[p] = (_read_block(file, sh[p]) if len(got) and p in sh
                       else np.load(file))
        return _unflatten(abstract_state, vals), meta["extra"]
