"""The per-layer column forward: RNL accumulate, threshold crossing and
optional 1-WTA for every column of a layer in one launch, as the
reference's ``_column_kernel`` (``repro.kernels.tnn_column``) vmapped over
the columns by ``ops.layer_forward_fused``.

    x (B, C, p) spike times (uint8 on the card), w (C, p, q) weights (int8)
    ->  z (B, C, q) int32 spike times

Also the plain PyTorch versions of the bodies the reference's kernels
share: the RNL body potential as the A@N 0/1 product (``ramp_matmul``) and
threshold crossing + WTA (``crossing_wta``). Both take leading batch dims
(one per column here). The reference runs the product in bf16 with float32
accumulation; every entry of A and N is 0 or 1, so the float32 product here
is the same exact integer count.

Dispatch is by the device of ``x``. A CPU tensor runs the plain version
:func:`column_forward_layer_plain` (built from those two bodies). A CUDA
tensor launches the hand-written Hopper kernel ``csrc/tnn_column.cu`` (the
same A@N product on int8 tensor cores, exactly equal) or raises; nothing
falls back. ``LAUNCHES`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_Q = 128            # the reference keeps q un-tiled in 128 lanes
MAX_THREADS = 256      # TNN_COLUMN_MAX_THREADS in csrc/tnn_column.cu
CHUNK_TILES = 32       # m16 tiles of (row, tick) pairs per block, at most

LAUNCHES = _build.LaunchCounter()


# ---------------------------------------------------------------------------
# Plain PyTorch versions (any device; the wrapper takes them for CPU tensors)
# ---------------------------------------------------------------------------


def ramp_matmul(x: torch.Tensor, w: torch.Tensor, *, T: int) -> torch.Tensor:
    """One tile's RNL body potential as the A@N product.

    x (..., Bt, Pt) spike times; w (..., Pt, q) weights -> (..., Bt*T, q)
    float32 with row ``b*T + t``:
    V[b, t, j] = sum_{i,k} [x[b,i] + k <= t] * [k <= w[i,j]].
    """
    *lead, bt, p_tile = x.shape
    q = w.shape[-1]
    dev = x.device
    k = torch.arange(1, T + 1, dtype=torch.int32, device=dev)      # ramp step
    t = torch.arange(T, dtype=torch.int32, device=dev)             # wave position
    arrive = x.to(torch.int32)[..., None] + k                      # (..., Bt, Pt, T)
    a = (arrive.reshape(*lead, bt, 1, p_tile * T) <= t[:, None]).to(torch.float32)
    n = (k[:, None] <= w.to(torch.int32)[..., :, None, :]).to(torch.float32)
    return (a.reshape(*lead, bt * T, p_tile * T)
            @ n.reshape(*w.shape[:-2], p_tile * T, q))


def crossing_wta(V: torch.Tensor, *, T: int, theta: int, wta: bool) -> torch.Tensor:
    """Threshold crossing + optional WTA: V (..., Bt, T, q) -> (..., Bt, q)
    int32 spike times; under WTA the earliest spike wins, ties to the
    lowest index."""
    q = V.shape[-1]
    tt = torch.arange(T, dtype=torch.int32, device=V.device)[:, None]
    z = torch.where(V >= theta, tt, T).amin(dim=-2)  # (..., Bt, q)
    if wta:
        qi = torch.arange(q, dtype=torch.int32, device=V.device)
        key = z * q + qi
        winner = key.amin(dim=-1, keepdim=True)
        z = torch.where((key == winner) & (z < T), z, T)
    return z.to(torch.int32)


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def column_forward_layer_plain(x: torch.Tensor, w: torch.Tensor, *, theta: int,
                               T: int, wta: bool) -> torch.Tensor:
    """Plain version of :func:`column_forward_layer`: every column's A@N
    product at once, then crossing + WTA."""
    B, C, _ = x.shape
    q = w.shape[-1]
    V = ramp_matmul(x.transpose(0, 1), w, T=T)           # (C, B*T, q)
    z = crossing_wta(V.reshape(C, B, T, q), T=T, theta=theta, wta=wta)
    return z.transpose(0, 1).contiguous()


# ---------------------------------------------------------------------------
# The Hopper kernel's wrapper
# ---------------------------------------------------------------------------


class _ColumnArgs(ctypes.Structure):
    """``ColumnArgs`` of csrc/tnn_column.cu, field for field."""

    _fields_ = [
        ("x", ctypes.c_void_p),
        ("x_sb", ctypes.c_longlong), ("x_sc", ctypes.c_longlong),
        ("x_si", ctypes.c_longlong),
        ("w", ctypes.c_void_p), ("z", ctypes.c_void_p),
        ("B", ctypes.c_int), ("C", ctypes.c_int), ("p", ctypes.c_int),
        ("q", ctypes.c_int), ("T", ctypes.c_int), ("theta", ctypes.c_int),
        ("wta", ctypes.c_int), ("rows", ctypes.c_int), ("w_smem", ctypes.c_int),
    ]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("tnn_column")
    args_p = ctypes.POINTER(_ColumnArgs)
    lib.tnn_column_launch.argtypes = [args_p, ctypes.c_void_p]
    lib.tnn_column_launch.restype = ctypes.c_int
    lib.tnn_column_smem_bytes.argtypes = [args_p]
    lib.tnn_column_smem_bytes.restype = ctypes.c_size_t
    lib.tnn_column_error_string.argtypes = [ctypes.c_int]
    lib.tnn_column_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build (if needed) and load the kernel library now."""
    _lib()


def tile_rows(T: int) -> int:
    """Batch rows one m16 tile of (row, tick) pairs holds (1 when a row
    spans several tiles)."""
    return max(1, 16 // T)


def tile_units(rows: int, T: int) -> int:
    """The m16 tile units of a chunk of ``rows`` rows: the most warps a
    block of it can use."""
    return rows if T >= 16 else rows * T // 16


def chunk_rows(B: int, T: int) -> int:
    """Rows per block: at most CHUNK_TILES m16 tiles, the batch split into
    equal chunks (no nearly empty one), each a whole number of tiles."""
    tile = tile_rows(T)
    chunks = -(-B // max(tile, CHUNK_TILES * 16 // T))
    return _ceil_to(-(-B // chunks), tile)


def halve_rows(rows: int, T: int) -> int:
    """The next smaller chunk when one does not fit shared memory."""
    return max(tile_rows(T), _ceil_to(rows // 2, tile_rows(T)))


def _column_cuda(x: torch.Tensor, w: torch.Tensor, theta: int, T: int,
                 wta: bool) -> torch.Tensor:
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"x must be (B, C, p) and w (C, p, q), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    B, C, p = x.shape
    q = w.shape[2]
    if tuple(w.shape[:2]) != (C, p):
        raise ValueError(f"w {tuple(w.shape)} does not match x {tuple(x.shape)}")
    if q > MAX_Q:
        raise ValueError(f"q={q} > {MAX_Q}: the column kernel keeps q un-tiled, "
                         f"as the reference does")
    if T < 2 or T > 128 or T & (T - 1):
        raise ValueError(f"T={T}: the column kernel takes T = 2**time_bits, "
                         f"time_bits 1..7")
    if w.device != x.device:
        raise ValueError("weights must be on x's device")
    if x.dtype != torch.uint8:  # spike times in [0, T], T <= 128
        x = x.to(torch.uint8)
    w = w.to(torch.int8).contiguous()
    z = torch.empty((B, C, q), dtype=torch.int32, device=x.device)
    if B == 0 or C == 0:
        return z
    a = _ColumnArgs()
    a.x, a.w, a.z = x.data_ptr(), w.data_ptr(), z.data_ptr()
    a.x_sb, a.x_sc, a.x_si = x.stride()
    a.B, a.C, a.p, a.q, a.T, a.theta, a.wta = B, C, p, q, T, theta, int(wta)
    a.rows, a.w_smem = chunk_rows(B, T), 1
    lib = _lib()
    # the site's weights in shared memory when they fit beside the chunk,
    # else read from device memory; then smaller chunks until it fits
    if lib.tnn_column_smem_bytes(ctypes.byref(a)) > _build.MAX_SMEM:
        a.w_smem = 0
    tile = tile_rows(T)
    while lib.tnn_column_smem_bytes(ctypes.byref(a)) > _build.MAX_SMEM:
        if a.rows == tile:
            raise ValueError(f"p={p} is too long for {tile} rows' volleys in "
                             f"{_build.MAX_SMEM} bytes of shared memory")
        a.rows = halve_rows(a.rows, T)
    _build.launch("tnn_column", lib.tnn_column_launch,
                  lib.tnn_column_error_string, x.device, ctypes.byref(a))
    LAUNCHES.n += 1
    return z


def column_forward_layer(x: torch.Tensor, w: torch.Tensor, *, theta: int,
                         T: int, wta: bool) -> torch.Tensor:
    """Every column of a layer: x (B, C, p) spike times in [0, T], w (C, p, q)
    weights -> z (B, C, q) int32 crossing times, 1-WTA applied per (row,
    column) when ``wta``. One kernel launch on the card."""
    if x.device.type == "cpu":
        return column_forward_layer_plain(x, w, theta=theta, T=T, wta=wta)
    if x.device.type != "cuda":
        raise ValueError(f"tnn_column runs on cpu or cuda tensors, not {x.device}")
    return _column_cuda(x, w, int(theta), int(T), bool(wta))
