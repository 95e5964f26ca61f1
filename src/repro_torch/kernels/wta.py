"""Standalone 1-WTA lateral inhibition, as the reference's ``_wta_kernel``
(``repro.kernels.wta``): the minimum of the key ``z * q + j`` along each row
wins (earliest spike, ties to the lowest index); every other neuron, and a
winner that never spiked (z = T), gets T.

    z (..., q) spike times, q <= 128  ->  (..., q) int32

Dispatch is by the device of ``z``. A CPU tensor runs the plain version
:func:`wta_plain`. A CUDA tensor launches the hand-written Hopper kernel
``csrc/wta.cu`` or raises; nothing falls back. ``LAUNCHES`` counts the
kernel launches. No entry point of the port calls it: the column kernel
fuses its own WTA, as the reference's does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_Q = 128              # TNN_WTA_MAX_Q in csrc/wta.cu
MAX_TILE_BYTES = 16_384  # TNN_WTA_MAX_TILE_BYTES: one block's rows of z
TILE_BYTES = 8_192       # the most a tile aims at
BLOCKS_PER_SM = 8        # the tiles a shape is cut into, per SM, where it can
THREADS = 128            # per block (TNN_WTA_MAX_THREADS at most)

LAUNCHES = _build.LaunchCounter()


def wta_plain(z: torch.Tensor, *, T: int) -> torch.Tensor:
    """Plain version of :func:`wta`."""
    zi = z.to(torch.int32)
    q = zi.shape[-1]
    key = zi * q + torch.arange(q, dtype=torch.int32, device=z.device)
    winner = key.amin(dim=-1, keepdim=True)
    return torch.where((key == winner) & (zi < T), zi, T).to(torch.int32)


def tile_rows(rows: int, q: int, sms: int) -> int:
    """Rows per block: a multiple of 4 (so every full tile is a 16-byte
    multiple for the bulk copies), at most about TILE_BYTES of z, and few
    enough that ``rows`` make BLOCKS_PER_SM blocks per SM where they can
    (small blocks, all resident at once: the kernel is a latency chain of
    copy in, WTA, copy out)."""
    cap = max(4, TILE_BYTES // (4 * q) // 4 * 4)
    spread = -(-rows // (BLOCKS_PER_SM * sms))
    return max(4, min(cap, -(-spread // 4) * 4))


def group_lanes(q: int) -> int:
    """Lanes per row: the power of two >= q / 4 (about 4 words a lane), at
    most a warp."""
    g = 1
    while g < min(-(-q // 4), 32):
        g *= 2
    return g


# tnn_wta_launch(z, out, rows, q, T, tile, threads, group, stream) in csrc/wta.cu
LAUNCH_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("wta")
    lib.tnn_wta_launch.argtypes = LAUNCH_ARGTYPES
    lib.tnn_wta_launch.restype = ctypes.c_int
    lib.tnn_wta_error_string.argtypes = [ctypes.c_int]
    lib.tnn_wta_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def build() -> None:
    """Build (if needed) and load the kernel library now."""
    _lib()


def _wta_cuda(z: torch.Tensor, T: int) -> torch.Tensor:
    q = z.shape[-1]
    if not 1 <= q <= MAX_Q:
        raise ValueError(f"q={q}; the WTA kernel takes 1 <= q <= {MAX_Q}")
    zi = z.to(torch.int32).contiguous()
    out = torch.empty(zi.shape, dtype=torch.int32, device=z.device)
    rows = zi.numel() // q
    if rows == 0:
        return out
    lib = _lib()
    _build.launch("wta", lib.tnn_wta_launch, lib.tnn_wta_error_string, z.device,
                  zi.data_ptr(), out.data_ptr(), rows, q, T,
                  tile_rows(rows, q, _sm_count(z.device)), THREADS, group_lanes(q))
    LAUNCHES.n += 1
    return out


def wta(z: torch.Tensor, *, T: int) -> torch.Tensor:
    """1-WTA along the last axis of ``z`` (..., q); returns int32. One kernel
    launch on the card."""
    if z.device.type == "cpu":
        return wta_plain(z, T=T)
    if z.device.type != "cuda":
        raise ValueError(f"wta runs on cpu or cuda tensors, not {z.device}")
    return _wta_cuda(z, int(T))
