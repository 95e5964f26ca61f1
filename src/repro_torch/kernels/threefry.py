"""A layer's STDP uniforms drawn on the card, bit for bit ``jax.random``'s: the
reference's ``layer_uniforms`` (``repro.core.layer``), ``jax.random.uniform``
of shape (2, B, p, q) vmapped over ``split(layer_key, n_cols)``.

    layer_uniforms(key, n_cols, (2, B, p, q), device=...)  ->  (n_cols, 2, B, p, q) float32

and, one split level deeper, the "seq" STDP mode's per-image draws
(``uniform(split(split(key, n_cols)[c], n_rows)[b], shape)``):

    nested_uniforms(key, n_cols, n_rows, (2, p, q), device=...)  ->  (n_cols, n_rows, 2, p, q) float32

and one rank's window of the first draw on a (data, model) mesh: local
columns ``col0 .. col0 + n_local - 1`` (1.0 at and beyond ``n_cols``, the
pad sites) and batch rows ``row0 .. row0 + b_local - 1`` of ``B``, the
reference's global draw padded and sliced (``shard_u``,
``repro.core.network``), drawn without the rest of it:

    window_uniforms(key, n_cols, B, (p, q), (col0, n_local, row0, b_local), device=...)
        ->  (n_local, 2, b_local, p, q) float32

The key is host data (two uint32 words, ``repro_torch.random``), so the
draw's device is named by ``device``. The CPU runs the plain versions
:func:`layer_uniforms_plain` and :func:`nested_uniforms_plain`
(``random.uniform`` over ``random.split``). The card launches the
hand-written Hopper kernel ``csrc/threefry.cu`` or raises; nothing falls
back to a host draw. ``LAUNCHES`` counts the kernel launches of both
entries (``LAUNCHES.nested`` those of the second, ``LAUNCHES.window`` those
of the third).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Sequence, Tuple

import torch

from repro_torch import random as _random
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.padding import pad_uniform_sites

THREADS = 256  # per block (TNN_TF_MAX_THREADS at most); 4 floats a thread



@dataclasses.dataclass
class LaunchCount(_build.LaunchCounter):
    """Launches of the threefry kernel: ``n`` of every entry, ``nested``
    of the two-level one, ``window`` of the mesh window's."""

    nested: int = 0
    window: int = 0

    def reset(self) -> None:
        self.n = self.nested = self.window = 0


LAUNCHES = LaunchCount()

# tnn_threefry_uniform_launch(out, key0, key1, n_cols, n, threads, stream)
LAUNCH_ARGTYPES = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
# tnn_threefry_nested_launch(out, key0, key1, n_cols, n_rows, n, threads, stream)
NESTED_ARGTYPES = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint, ctypes.c_int,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
# tnn_threefry_window_launch(out, key0, key1, n_cols, col0, n_local, B, row0,
#                            b_local, pq, threads, stream)
WINDOW_ARGTYPES = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
# tnn_threefry_hash_launch(x0, x1, y0, y1, key0, key1, n, stream)
HASH_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_uint, ctypes.c_uint,
                                         ctypes.c_longlong, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("threefry")
    lib.tnn_threefry_uniform_launch.argtypes = LAUNCH_ARGTYPES
    lib.tnn_threefry_uniform_launch.restype = ctypes.c_int
    lib.tnn_threefry_nested_launch.argtypes = NESTED_ARGTYPES
    lib.tnn_threefry_nested_launch.restype = ctypes.c_int
    lib.tnn_threefry_window_launch.argtypes = WINDOW_ARGTYPES
    lib.tnn_threefry_window_launch.restype = ctypes.c_int
    lib.tnn_threefry_hash_launch.argtypes = HASH_ARGTYPES
    lib.tnn_threefry_hash_launch.restype = ctypes.c_int
    lib.tnn_threefry_error_string.argtypes = [ctypes.c_int]
    lib.tnn_threefry_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build (if needed) and load the kernel library now."""
    _lib()


def layer_uniforms_plain(key, n_cols: int, shape: Sequence[int],
                         device="cpu") -> torch.Tensor:
    """Plain version of :func:`layer_uniforms`, computed on ``device``."""
    return _random.uniform(_random.split(key, n_cols), tuple(shape), device)


def _uniforms_cuda(key, n_cols: int, shape, device: torch.device) -> torch.Tensor:
    k0, k1 = _random.key_words(key)
    out = torch.empty((n_cols, *shape), dtype=torch.float32, device=device)
    n = math.prod(shape)
    if n_cols < 1 or n == 0:
        return out
    lib = _lib()
    _build.launch("threefry", lib.tnn_threefry_uniform_launch,
                  lib.tnn_threefry_error_string, device,
                  out.data_ptr(), k0, k1, n_cols, n, THREADS)
    LAUNCHES.n += 1
    return out


def nested_uniforms_plain(key, n_cols: int, n_rows: int, shape: Sequence[int],
                          device="cpu") -> torch.Tensor:
    """Plain version of :func:`nested_uniforms`, computed on ``device``."""
    keys = _random.split(_random.split(key, n_cols), n_rows)  # (C, B, 2)
    return _random.uniform(keys, tuple(shape), device)


def _nested_cuda(key, n_cols: int, n_rows: int, shape, device: torch.device
                 ) -> torch.Tensor:
    k0, k1 = _random.key_words(key)
    out = torch.empty((n_cols, n_rows, *shape), dtype=torch.float32, device=device)
    n = math.prod(shape)
    if n_cols < 1 or n_rows < 1 or n == 0:
        return out
    lib = _lib()
    _build.launch("threefry nested", lib.tnn_threefry_nested_launch,
                  lib.tnn_threefry_error_string, device,
                  out.data_ptr(), k0, k1, n_cols, n_rows, n, THREADS)
    LAUNCHES.n += 1
    LAUNCHES.nested += 1
    return out


def nested_uniforms(key, n_cols: int, n_rows: int, shape: Sequence[int], *,
                    device="cuda") -> torch.Tensor:
    """(n_cols, n_rows, *shape) float32 uniforms in [0, 1): row (c, b) is
    ``jax.random.uniform(split(split(key, n_cols)[c], n_rows)[b], shape)``.
    One kernel launch on the card."""
    dev = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    if dev.type == "cpu":
        return nested_uniforms_plain(key, n_cols, n_rows, shape, dev)
    return _nested_cuda(key, int(n_cols), int(n_rows), shape, dev)


Window = Tuple[int, int, int, int]   # (col0, n_local, row0, b_local)


def _check_window(n_cols: int, B: int, window: Window) -> Window:
    col0, n_local, row0, b_local = (int(v) for v in window)
    if col0 < 0 or n_local < 1 or row0 < 0 or b_local < 1 or row0 + b_local > B:
        raise ValueError(f"window (col0={col0}, n_local={n_local}, row0={row0}, "
                         f"b_local={b_local}) does not lie in {n_cols} columns "
                         f"(padded at the end) x {B} rows")
    return col0, n_local, row0, b_local


def window_uniforms_plain(key, n_cols: int, B: int, pq: Sequence[int],
                          window: Window, device="cpu") -> torch.Tensor:
    """Plain version of :func:`window_uniforms`: the window's columns of the
    global (n_cols, 2, B, p, q) draw (each column's draw is its own), its
    rows sliced out, the pad columns appended as 1.0."""
    col0, n_local, row0, b_local = _check_window(n_cols, B, window)
    real = max(0, min(col0 + n_local, n_cols) - col0)
    keys = _random.split(key, n_cols)[col0:col0 + real]
    u = _random.uniform(keys, (2, B, *pq), device)[:, :, row0:row0 + b_local]
    return pad_uniform_sites(u, n_local).contiguous()


def _window_cuda(key, n_cols: int, B: int, pq, window: Window,
                 device: torch.device) -> torch.Tensor:
    col0, n_local, row0, b_local = window
    k0, k1 = _random.key_words(key)
    out = torch.empty((n_local, 2, b_local, *pq), dtype=torch.float32, device=device)
    n = math.prod(pq)
    if n == 0:
        return out
    lib = _lib()
    _build.launch("threefry window", lib.tnn_threefry_window_launch,
                  lib.tnn_threefry_error_string, device,
                  out.data_ptr(), k0, k1, n_cols, col0, n_local, B, row0,
                  b_local, n, THREADS)
    LAUNCHES.n += 1
    LAUNCHES.window += 1
    return out


def window_uniforms(key, n_cols: int, B: int, pq: Sequence[int], window: Window,
                    *, device="cuda") -> torch.Tensor:
    """(n_local, 2, b_local, p, q) float32: one rank's window ``(col0,
    n_local, row0, b_local)`` of ``layer_uniforms(key, n_cols, (2, B, p,
    q))``, with 1.0 for local columns at and beyond ``n_cols`` (the
    reference's ``pad_uniform_sites``). One kernel launch on the card, which
    draws only the window."""
    dev = resolve_device(device)
    pq = tuple(int(s) for s in pq)
    window = _check_window(int(n_cols), int(B), window)
    if dev.type == "cpu":
        return window_uniforms_plain(key, n_cols, B, pq, window, dev)
    return _window_cuda(key, int(n_cols), int(B), pq, window, dev)


def hash_pairs(key, x0: torch.Tensor, x1: torch.Tensor):
    """The bare Threefry-2x32 hash of the counter pairs (x0, x1) (int64
    tensors of uint32 words) under ``key``, as ``random.threefry2x32``: on a
    CUDA tensor by the kernel's own hash (the known-answer check of the
    card's arithmetic; no path calls it), on the CPU by the plain version."""
    k0, k1 = _random.key_words(key)
    if x0.device.type == "cpu":
        return _random.threefry2x32(k0, k1, x0, x1)
    words = [x.to(torch.int64).bitwise_and(_random.M32).to(torch.int32).contiguous()
             for x in (x0, x1)]   # the same 32 bits, as int32
    y = [torch.empty_like(words[0]) for _ in range(2)]
    lib = _lib()
    _build.launch("threefry hash", lib.tnn_threefry_hash_launch,
                  lib.tnn_threefry_error_string, x0.device,
                  words[0].data_ptr(), words[1].data_ptr(), y[0].data_ptr(),
                  y[1].data_ptr(), k0, k1, words[0].numel())
    return tuple(v.to(torch.int64).bitwise_and(_random.M32) for v in y)


def layer_uniforms(key, n_cols: int, shape: Sequence[int], *,
                   device="cuda") -> torch.Tensor:
    """(n_cols, *shape) float32 uniforms in [0, 1): column ``c`` is
    ``jax.random.uniform(split(key, n_cols)[c], shape)``. One kernel launch
    on the card."""
    dev = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    if dev.type == "cpu":
        return layer_uniforms_plain(key, n_cols, shape, dev)
    return _uniforms_cuda(key, int(n_cols), shape, dev)
