"""The per-layer STDP update: one wave of batched-"sum" STDP for every
synapse of a layer in one launch, as the reference's ``_stdp_kernel``
(``repro.kernels.stdp_update``) vmapped over the columns by
``ops.layer_stdp_fused``.

    w (C, p, q) int8, x (B, C, p) and z (B, C, q) spike times,
    u_up / u_dn (C, B, p, q) float32 uniforms
    ->  (C, p, q) int32: the pre-clip counters (``out="net"``) or
        clip(w + net, 0, w_max) (``out="weights"``)

Also the plain PyTorch version of the counter body the reference's kernels
share (``stdp_net_tile``), with leading batch dims (one per column here).

Dispatch is by the device of ``x``. A CPU tensor runs the plain version
:func:`stdp_update_layer_plain`. A CUDA tensor launches the hand-written
Hopper kernel ``csrc/stdp_update.cu`` or raises; nothing falls back. The
launch plan (:func:`plan`) and everything of the kernel's arguments but the
pointers are worked out once per shape, strides and constants, and cached.
``LAUNCHES`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Sequence

import torch

from repro_torch.kernels import _build

MAX_TABLE = 128        # TNN_STDP_MAX_TABLE in csrc/stdp_update.cu (w_max <= 127)
MAX_THREADS = 1024     # TNN_STDP_MAX_THREADS: a block's threads, at most
MAX_TILE = MAX_THREADS - 32  # synapses per tile (one counting thread each)
MAX_STAGES = 8         # TNN_STDP_MAX_STAGES
VOLLEYS = 4            # TNN_STDP_VOLLEYS: volley bytes a counting thread loads
STAGES = 2             # stages of the ring
STAGE_BYTES = 24_576   # uniform bytes (both halves) one stage aims at
OUTS = ("weights", "net")

LAUNCHES = _build.LaunchCounter()


# ---------------------------------------------------------------------------
# Plain PyTorch versions (any device; the wrapper takes them for CPU tensors)
# ---------------------------------------------------------------------------


def stdp_net_tile(
    w: torch.Tensor, x: torch.Tensor, z: torch.Tensor, uu: torch.Tensor,
    ud: torch.Tensor,
    *,
    T: int,
    w_max: int,
    table: Sequence[float],
    mu_capture: float,
    mu_backoff: float,
    mu_search: float,
) -> torch.Tensor:
    """One batch tile's pre-clip inc - dec counters.

    w (..., Pt, q); x (..., Bt, Pt); z (..., Bt, q); uu/ud (..., Bt, Pt, q)
    float32 -> (..., Pt, q) int32. The stabilize table is a select chain
    over the weight value, as in the reference (a weight outside
    [1, w_max] reads entry 0), and the probabilities are float32
    ``f32(mu) * F[w]``."""
    w = w.to(torch.int32)
    xs = x.to(torch.int32)[..., :, :, None]
    zs = z.to(torch.int32)[..., :, None, :]
    x_fired = xs < T
    z_fired = zs < T
    capture = x_fired & z_fired & (xs <= zs)
    backoff = (x_fired & z_fired & (xs > zs)) | (~x_fired & z_fired)
    search = x_fired & ~z_fired

    f = torch.full(w.shape, table[0], dtype=torch.float32, device=w.device)
    for wv in range(1, w_max + 1):
        f = torch.where(w == wv, torch.tensor(table[wv], dtype=torch.float32,
                                              device=w.device), f)
    f = f.unsqueeze(-3)  # (..., 1, Pt, q)

    p_up = capture * (mu_capture * f) + search * torch.tensor(
        mu_search, dtype=torch.float32, device=w.device)
    p_dn = backoff * (mu_backoff * f)
    inc = (uu < p_up).to(torch.int32).sum(dim=-3, dtype=torch.int32)
    dec = (ud < p_dn).to(torch.int32).sum(dim=-3, dtype=torch.int32)
    return inc - dec


def _check_out(out: str, table: Sequence[float]) -> None:
    if out not in OUTS:
        raise ValueError(f"out={out!r}; one of {OUTS}")
    if not table:
        raise ValueError("pass the stabilization table explicitly")


def stdp_update_layer_plain(
    w: torch.Tensor, x: torch.Tensor, z: torch.Tensor, u_up: torch.Tensor,
    u_dn: torch.Tensor, *, T: int, w_max: int, table: Sequence[float],
    mu_capture: float, mu_backoff: float, mu_search: float, out: str,
) -> torch.Tensor:
    """Plain version of :func:`stdp_update_layer`: every column's counters
    at once through :func:`stdp_net_tile`."""
    _check_out(out, table)
    net = stdp_net_tile(w, x.transpose(0, 1), z.transpose(0, 1), u_up, u_dn,
                        T=T, w_max=w_max, table=table, mu_capture=mu_capture,
                        mu_backoff=mu_backoff, mu_search=mu_search)
    if out == "net":
        return net
    return (w.to(torch.int32) + net).clamp(0, w_max)


# ---------------------------------------------------------------------------
# The Hopper kernel's wrapper
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StdpPlan:
    """How one launch cuts a layer: tiles of ``tk`` rows of i by ``tw``
    columns of j (``tiles`` per site, ``n`` synapses, one counting thread
    each; ``threads`` per block with the producer warp), ``rows`` batch rows
    per ring stage, ``stages`` stages, volley groups of up to ``group``
    chunks, and ``smem`` bytes of dynamic shared memory."""

    tk: int
    tw: int
    n: int
    tiles: int
    threads: int
    rows: int
    stages: int
    group: int
    smem: int


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def smem_bytes(n: int, rows: int, stages: int, threads: int) -> int:
    """``stdp_smem_bytes`` of csrc/stdp_update.cu: the full and empty
    mbarriers, the ring of u_up / u_dn rows (a row every round4(n) floats)
    and two volley buffers of VOLLEYS bytes per counting thread."""
    return 16 * stages + stages * 8 * rows * _round_up(n, 4) + 2 * VOLLEYS * (threads - 32)


@functools.lru_cache(maxsize=256)
def tile_shape(p: int, q: int) -> tuple:
    """(tk, tw): whole rows of the plane (tw = q, as many as MAX_TILE holds,
    a multiple of 4 synapses where the plane is, so that bulk copies stay
    aligned), or for q > MAX_TILE one row in the fewest equal pieces (a
    multiple of 4 wide)."""
    if q <= MAX_TILE:
        tk = min(p, MAX_TILE // q)
        step = 4 // math.gcd(q, 4)
        if p * q % 4 == 0 and tk * q % 4 and tk >= step:
            tk -= tk % step
        return tk, q
    return 1, _round_up(-(-q // -(-q // MAX_TILE)), 4)


def plan(B: int, p: int, q: int) -> StdpPlan:
    """The launch plan of a layer of (p, q) columns at batch ``B``: tiles
    from :func:`tile_shape`, about STAGE_BYTES of uniforms per stage, no
    more rows than one volley buffer holds beside the weights, and as many
    chunks a volley group as the buffer holds."""
    tk, tw = tile_shape(p, q)
    n = tk * tw
    threads = _round_up(n, 32) + 32
    cap, vrow, nw = VOLLEYS * (threads - 32), tk + tw, _round_up(n, 4)
    rows = max(1, min(B, STAGE_BYTES // (8 * nw), (cap - nw) // vrow))
    group = max(1, (cap - nw) // (rows * vrow))
    tiles = -(-p // tk) * -(-q // tw)
    return StdpPlan(tk=tk, tw=tw, n=n, tiles=tiles, threads=threads, rows=rows,
                    stages=STAGES, group=group,
                    smem=smem_bytes(n, rows, STAGES, threads))


def bulk_fill(u_up: torch.Tensor, u_dn: torch.Tensor) -> bool:
    """Whether the ring can be filled by bulk copies: both uniform tensors
    start 16-byte aligned and every site, row, tile and plane offset is a
    multiple of 4 floats. Otherwise the kernel fills it 4 bytes at a time."""
    p, q = u_up.shape[2:]
    tk, tw = tile_shape(p, q)
    return (all(u.data_ptr() % 16 == 0 and u.stride(0) % 4 == 0
                and u.stride(1) % 4 == 0 for u in (u_up, u_dn))
            and p * q % 4 == 0 and tk * tw % 4 == 0 and (tk > 1 or q % 4 == 0))


class _StdpArgs(ctypes.Structure):
    """``StdpArgs`` of csrc/stdp_update.cu, field for field."""

    _fields_ = [
        ("w", ctypes.c_void_p),
        ("x", ctypes.c_void_p),
        ("x_sb", ctypes.c_longlong), ("x_sc", ctypes.c_longlong),
        ("x_si", ctypes.c_longlong),
        ("z", ctypes.c_void_p),
        ("z_sb", ctypes.c_longlong), ("z_sc", ctypes.c_longlong),
        ("z_sj", ctypes.c_longlong),
        ("u_up", ctypes.c_void_p),
        ("uu_sc", ctypes.c_longlong), ("uu_sb", ctypes.c_longlong),
        ("u_dn", ctypes.c_void_p),
        ("ud_sc", ctypes.c_longlong), ("ud_sb", ctypes.c_longlong),
        ("out", ctypes.c_void_p),
        ("B", ctypes.c_int), ("C", ctypes.c_int), ("p", ctypes.c_int),
        ("q", ctypes.c_int), ("T", ctypes.c_int), ("w_max", ctypes.c_int),
        ("tk", ctypes.c_int), ("tw", ctypes.c_int), ("rows", ctypes.c_int),
        ("stages", ctypes.c_int), ("group", ctypes.c_int), ("bulk", ctypes.c_int),
        ("threads", ctypes.c_int), ("blocks", ctypes.c_int),
        ("weights_out", ctypes.c_int),
        ("mu_c", ctypes.c_float), ("mu_b", ctypes.c_float),
        ("mu_s", ctypes.c_float),
        ("table", ctypes.c_float * MAX_TABLE),
    ]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("stdp_update")
    args_p = ctypes.POINTER(_StdpArgs)
    lib.tnn_stdp_launch.argtypes = [args_p, ctypes.c_void_p]
    lib.tnn_stdp_launch.restype = ctypes.c_int
    lib.tnn_stdp_smem_bytes.argtypes = [args_p]
    lib.tnn_stdp_smem_bytes.restype = ctypes.c_size_t
    lib.tnn_stdp_blocks_per_sm.argtypes = [args_p]
    lib.tnn_stdp_blocks_per_sm.restype = ctypes.c_int
    lib.tnn_stdp_error_string.argtypes = [ctypes.c_int]
    lib.tnn_stdp_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build (if needed) and load the kernel library now."""
    _lib()


@functools.lru_cache(maxsize=256)
def _args_template(device: torch.device, B, C, p, q, x_strides, z_strides,
                   uu_strides, ud_strides, bulk, T, w_max, table, mus,
                   out) -> _StdpArgs:
    """Everything of a launch's arguments but the pointers, made once per
    shapes, strides and constants: the plan, the table, the mu values and
    the grid from the occupancy query."""
    pl = plan(B, p, q)
    a = _StdpArgs()
    a.x_sb, a.x_sc, a.x_si = x_strides
    a.z_sb, a.z_sc, a.z_sj = z_strides
    a.uu_sc, a.uu_sb = uu_strides
    a.ud_sc, a.ud_sb = ud_strides
    a.B, a.C, a.p, a.q, a.T, a.w_max = B, C, p, q, T, w_max
    a.tk, a.tw, a.rows, a.stages, a.group = pl.tk, pl.tw, pl.rows, pl.stages, pl.group
    a.bulk, a.threads = int(bulk), pl.threads
    a.weights_out = int(out == "weights")
    a.mu_c, a.mu_b, a.mu_s = mus
    for k, v in enumerate(table):
        a.table[k] = v
    lib = _lib()
    if lib.tnn_stdp_smem_bytes(ctypes.byref(a)) != pl.smem or pl.smem > _build.MAX_SMEM:
        raise RuntimeError(f"the STDP plan {pl} disagrees with the kernel's "
                           f"shared memory or exceeds {_build.MAX_SMEM} bytes")
    with torch.cuda.device(device):
        per_sm = lib.tnn_stdp_blocks_per_sm(ctypes.byref(a))
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    if per_sm <= 0:
        raise RuntimeError(f"stdp_update cannot run plan {pl}: "
                           f"{lib.tnn_stdp_error_string(-per_sm).decode()}"
                           if per_sm < 0 else f"stdp_update plan {pl} fits no SM")
    a.blocks = min(C * pl.tiles, sms * per_sm)
    return a


def _stdp_cuda(w, x, z, u_up, u_dn, *, T, w_max, table, mu_capture,
               mu_backoff, mu_search, out) -> torch.Tensor:
    if x.dim() != 3 or z.dim() != 3 or w.dim() != 3:
        raise ValueError(f"x must be (B, C, p), z (B, C, q) and w (C, p, q), got "
                         f"{tuple(x.shape)}, {tuple(z.shape)}, {tuple(w.shape)}")
    B, C, p = x.shape
    q = z.shape[2]
    if tuple(z.shape[:2]) != (B, C) or tuple(w.shape) != (C, p, q):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, z {tuple(z.shape)}, "
                         f"w {tuple(w.shape)}")
    if not 0 <= w_max < MAX_TABLE or len(table) != w_max + 1:
        raise ValueError(f"w_max={w_max} with a {len(table)}-entry table; the "
                         f"kernel takes w_max < {MAX_TABLE} and w_max + 1 entries")
    for u in (u_up, u_dn):
        if (u.dtype != torch.float32 or tuple(u.shape) != (C, B, p, q)
                or u.device != x.device or u.stride(3) != 1
                or u.stride(2) != q):
            raise TypeError(
                f"uniforms must be ({C}, {B}, {p}, {q}) float32 on x's device "
                f"with contiguous (p, q) planes, got {tuple(u.shape)} {u.dtype} "
                f"strides {u.stride()}")
    if w.device != x.device or z.device != x.device:
        raise ValueError("w, x and z must be on one device")
    if x.dtype != torch.uint8:  # spike times in [0, T], T <= 254
        x = x.to(torch.uint8)
    if z.dtype != torch.uint8:
        z = z.to(torch.uint8)
    w = w.to(torch.int8).contiguous()
    res = torch.empty((C, p, q), dtype=torch.int32, device=x.device)
    if B == 0:  # no row votes: the counters are 0
        return res.zero_() if out == "net" else res.copy_(w.clamp(0, w_max))
    a = _StdpArgs.from_buffer_copy(_args_template(
        x.device, B, C, p, q, x.stride(), z.stride(), u_up.stride()[:2],
        u_dn.stride()[:2], bulk_fill(u_up, u_dn), T, w_max, table,
        (mu_capture, mu_backoff, mu_search), out))
    a.w, a.x, a.z, a.out = w.data_ptr(), x.data_ptr(), z.data_ptr(), res.data_ptr()
    a.u_up, a.u_dn = u_up.data_ptr(), u_dn.data_ptr()
    lib = _lib()
    _build.launch("stdp_update", lib.tnn_stdp_launch, lib.tnn_stdp_error_string,
                  x.device, ctypes.byref(a))
    LAUNCHES.n += 1
    return res


def stdp_update_layer(
    w: torch.Tensor, x: torch.Tensor, z: torch.Tensor, u_up: torch.Tensor,
    u_dn: torch.Tensor, *, T: int, w_max: int, table: Sequence[float],
    mu_capture: float, mu_backoff: float, mu_search: float,
    out: str = "weights",
) -> torch.Tensor:
    """One wave of STDP for every column of a layer: w (C, p, q), x (B, C, p),
    z (B, C, q), u_up / u_dn (C, B, p, q) float32 (strided views of a
    (C, 2, B, p, q) draw are taken as they are) -> (C, p, q) int32, the
    pre-clip counters (``out="net"``) or the clipped new weights
    (``out="weights"``). One kernel launch on the card."""
    _check_out(out, table)
    if x.device.type == "cpu":
        return stdp_update_layer_plain(
            w, x, z, u_up, u_dn, T=T, w_max=w_max, table=table,
            mu_capture=mu_capture, mu_backoff=mu_backoff, mu_search=mu_search,
            out=out)
    if x.device.type != "cuda":
        raise ValueError(f"stdp_update runs on cpu or cuda tensors, not {x.device}")
    return _stdp_cuda(w, x, z, u_up, u_dn, T=int(T), w_max=int(w_max),
                      table=tuple(float(v) for v in table),
                      mu_capture=float(mu_capture), mu_backoff=float(mu_backoff),
                      mu_search=float(mu_search), out=out)
