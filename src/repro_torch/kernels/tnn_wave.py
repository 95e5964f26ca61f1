"""The fused gamma wave: every layer's RNL accumulate, threshold and WTA,
plus the optional per-layer STDP-counter epilogue, in one launch.

Same contract as ``repro.kernels.tnn_wave.wave_forward`` / ``wave_train``:

    x        (B, C, p1) spike times (uint8 on the card)
    params   per layer w_i (C, p_i, q_i) (int8 on the card)
    uniforms per layer (u_up, u_dn), each (C, B, p_i, q_i) float32
    ->  zs   per layer z_i (B, C, q_i) uint8 post-WTA spike times
        nets per layer (C, p_i, q_i) int32 counters before the clip

Dispatch is by the device of ``x``. A CPU tensor runs the plain PyTorch
version (layer by layer through ``body_potential`` -> ``crossing_time`` ->
``wta_inhibit`` and ``stdp_net_from_uniforms``). A CUDA tensor launches the
hand-written Hopper kernel ``csrc/tnn_wave.cu`` or raises; nothing falls
back. ``LAUNCHES`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence, Tuple

import torch

from repro_torch.core.column import body_potential, crossing_time, wta_inhibit
from repro_torch.core.stdp import STDPConfig, stdp_net_from_uniforms
from repro_torch.core.temporal import SPIKE_DTYPE, WaveSpec
from repro_torch.kernels import _build
from repro_torch.kernels.padding import NetworkPlan
from repro_torch.kernels.tnn_column import chunk_rows, halve_rows, tile_rows

MAX_LAYERS = 8        # TNN_MAX_LAYERS in csrc/tnn_wave.cu
MAX_THREADS = 256     # TNN_MAX_THREADS in csrc/tnn_wave.cu


@dataclasses.dataclass
class LaunchCount:
    """Launches of the wave kernel, by half. Added to only where the kernel
    is launched; the plain version never counts."""

    forward: int = 0
    learn: int = 0

    @property
    def total(self) -> int:
        return self.forward + self.learn

    def reset(self) -> None:
        self.forward = self.learn = 0


LAUNCHES = LaunchCount()


# ---------------------------------------------------------------------------
# Plain PyTorch version (any device; the wrappers take it for CPU tensors)
# ---------------------------------------------------------------------------


def _plan_spec(plan: NetworkPlan) -> WaveSpec:
    return WaveSpec(time_bits=plan.T.bit_length() - 1,
                    weight_bits=plan.w_max.bit_length())


def _layer_plain(v: torch.Tensor, w: torch.Tensor, theta: int,
                 spec: WaveSpec) -> torch.Tensor:
    """(B, C, p) volley, (C, p, q) weights -> (B, C, q) post-WTA times."""
    V = body_potential(v.transpose(0, 1), w, spec)     # (C, B, T, q)
    z = wta_inhibit(crossing_time(V, theta, spec), spec)
    return z.transpose(0, 1)


def wave_forward_plain(x: torch.Tensor, params: Sequence[torch.Tensor], *,
                       plan: NetworkPlan) -> Tuple[torch.Tensor, ...]:
    """Plain version of :func:`wave_forward`."""
    spec = _plan_spec(plan)
    zs, v = [], x
    for w, theta in zip(params, plan.thetas):
        v = _layer_plain(v, w, theta, spec)
        zs.append(v)
    return tuple(zs)


def wave_train_plain(
    x: torch.Tensor, params: Sequence[torch.Tensor],
    uniforms: Sequence[Tuple[torch.Tensor, torch.Tensor]], *,
    plan: NetworkPlan,
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Plain version of :func:`wave_train`."""
    spec = _plan_spec(plan)
    zs, nets, v = [], [], x
    for w, theta, table, mus, (uu, ud) in zip(
            params, plan.thetas, plan.tables, plan.mus, uniforms):
        z = _layer_plain(v, w, theta, spec)
        stdp = STDPConfig(mu_capture=mus[0], mu_backoff=mus[1],
                          mu_search=mus[2], stabilize=table)
        nets.append(stdp_net_from_uniforms(
            w, v.transpose(0, 1), z.transpose(0, 1), uu, ud, spec, stdp))
        zs.append(z)
        v = z
    return tuple(zs), tuple(nets)


# ---------------------------------------------------------------------------
# The Hopper kernel's wrapper
# ---------------------------------------------------------------------------

_L = MAX_LAYERS


class _WaveArgs(ctypes.Structure):
    """``WaveArgs`` of csrc/tnn_wave.cu, field for field."""

    _fields_ = [
        ("x", ctypes.c_void_p),
        ("x_sb", ctypes.c_longlong), ("x_sc", ctypes.c_longlong),
        ("x_si", ctypes.c_longlong),
        ("n_layers", ctypes.c_int), ("C", ctypes.c_int), ("B", ctypes.c_int),
        ("T", ctypes.c_int), ("w_max", ctypes.c_int), ("learn", ctypes.c_int),
        ("rows", ctypes.c_int), ("threads", ctypes.c_int),
        ("p", ctypes.c_int * _L), ("q", ctypes.c_int * _L),
        ("theta", ctypes.c_int * _L),
        ("w", ctypes.c_void_p * _L), ("z", ctypes.c_void_p * _L),
        ("u_up", ctypes.c_void_p * _L), ("u_dn", ctypes.c_void_p * _L),
        ("uu_sc", ctypes.c_longlong * _L), ("uu_sb", ctypes.c_longlong * _L),
        ("ud_sc", ctypes.c_longlong * _L), ("ud_sb", ctypes.c_longlong * _L),
        ("net", ctypes.c_void_p * _L),
        ("consts", ctypes.c_void_p),
        ("u_stage", ctypes.c_int),
    ]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("tnn_wave")
    args_p = ctypes.POINTER(_WaveArgs)
    lib.tnn_wave_launch.argtypes = [args_p, ctypes.c_void_p]
    lib.tnn_wave_launch.restype = ctypes.c_int
    lib.tnn_wave_smem_bytes.argtypes = [args_p]
    lib.tnn_wave_smem_bytes.restype = ctypes.c_size_t
    lib.tnn_wave_error_string.argtypes = [ctypes.c_int]
    lib.tnn_wave_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build (if needed) and load the kernel library now."""
    _lib()


@functools.lru_cache(maxsize=64)
def _consts(plan: NetworkPlan, device: torch.device) -> torch.Tensor:
    """Per-layer float32 row: stabilize table, then mu_capture, mu_backoff,
    mu_search (float32, as the reference's compare sees them)."""
    rows = [list(t) + list(m) for t, m in zip(plan.tables, plan.mus)]
    return torch.tensor(rows, dtype=torch.float32, device=device)


def _check_inputs(x: torch.Tensor, params, plan: NetworkPlan) -> None:
    n = plan.n_layers
    if n > MAX_LAYERS:
        raise ValueError(f"{n} layers; the wave kernel takes at most {MAX_LAYERS}")
    if len(params) != n:
        raise ValueError(f"{len(params)} weight tensors for {n} layers")
    if x.dtype != torch.uint8 or x.dim() != 3:
        raise TypeError(f"x must be (B, C, p1) uint8, got {tuple(x.shape)} {x.dtype}")
    B, C, p1 = x.shape
    if B < 1 or C != plan.n_cols or p1 != plan.ps[0]:
        raise ValueError(f"x {tuple(x.shape)} does not match the plan "
                         f"(C={plan.n_cols}, p1={plan.ps[0]})")
    for w, p, q in zip(params, plan.ps, plan.qs):
        if w.dtype != torch.int8 or tuple(w.shape) != (C, p, q):
            raise TypeError(f"weights must be ({C}, {p}, {q}) int8, got "
                            f"{tuple(w.shape)} {w.dtype}")
        if w.device != x.device or not w.is_contiguous():
            raise ValueError("weights must be contiguous and on x's device")


def _fill_common(x: torch.Tensor, params, plan: NetworkPlan,
                 learn: bool) -> Tuple[_WaveArgs, list]:
    """The launch arguments shared by both halves; returns them and the
    freshly allocated z outputs."""
    B, C, _ = x.shape
    a = _WaveArgs()
    a.x = x.data_ptr()
    a.x_sb, a.x_sc, a.x_si = x.stride()
    a.n_layers, a.C, a.B, a.T, a.w_max = plan.n_layers, C, B, plan.T, plan.w_max
    a.learn = int(learn)
    zs = []
    for l, (w, p, q, th) in enumerate(zip(params, plan.ps, plan.qs, plan.thetas)):
        a.p[l], a.q[l], a.theta[l] = p, q, th
        a.w[l] = w.data_ptr()
        z = torch.empty((B, C, q), dtype=SPIKE_DTYPE, device=x.device)
        a.z[l] = z.data_ptr()
        zs.append(z)
    # rows per chunk: at most CHUNK_TILES m16 tiles, the batch split evenly;
    # when learning, each chunk's uniforms staged in shared memory beside
    # it. Smaller chunks until it fits; then, learning, the uniforms read
    # from device memory instead.
    T, tile = plan.T, tile_rows(plan.T)
    a.rows, a.u_stage = chunk_rows(B, T), int(learn)
    lib = _lib()
    while lib.tnn_wave_smem_bytes(ctypes.byref(a)) > _build.MAX_SMEM:
        if a.rows > tile:
            a.rows = halve_rows(a.rows, T)
        elif a.u_stage:
            a.rows, a.u_stage = chunk_rows(B, T), 0
        else:
            raise ValueError(
                f"plan {plan.ps}x{plan.qs} needs more than {_build.MAX_SMEM} "
                f"bytes of shared memory per site even at {tile} rows per chunk")
    # one warp per m16 tile unit of a chunk, up to 8; all 8 when learning
    # (the copies and the epilogue use every thread)
    units = a.rows if T >= 16 else a.rows * T // 16
    a.threads = MAX_THREADS if learn else 32 * min(MAX_THREADS // 32, units)
    return a, zs


def _launch(a: _WaveArgs, device: torch.device) -> None:
    lib = _lib()
    _build.launch("tnn_wave", lib.tnn_wave_launch, lib.tnn_wave_error_string,
                  device, ctypes.byref(a))


def _wave_forward_cuda(x, params, plan: NetworkPlan):
    _check_inputs(x, params, plan)
    a, zs = _fill_common(x, params, plan, learn=False)
    _launch(a, x.device)
    LAUNCHES.forward += 1
    return tuple(zs)


def _wave_train_cuda(x, params, uniforms, plan: NetworkPlan):
    _check_inputs(x, params, plan)
    if len(uniforms) != plan.n_layers:
        raise ValueError(f"{len(uniforms)} uniform pairs for {plan.n_layers} layers")
    B, C, _ = x.shape
    a, zs = _fill_common(x, params, plan, learn=True)
    nets = []
    for l, ((uu, ud), p, q) in enumerate(zip(uniforms, plan.ps, plan.qs)):
        for u in (uu, ud):
            if (u.dtype != torch.float32 or tuple(u.shape) != (C, B, p, q)
                    or u.device != x.device or u.stride(3) != 1
                    or u.stride(2) != q):
                raise TypeError(
                    f"layer {l} uniforms must be ({C}, {B}, {p}, {q}) float32 "
                    f"on x's device with contiguous (p, q) planes, got "
                    f"{tuple(u.shape)} {u.dtype} strides {u.stride()}")
        a.u_up[l], a.u_dn[l] = uu.data_ptr(), ud.data_ptr()
        a.uu_sc[l], a.uu_sb[l] = uu.stride(0), uu.stride(1)
        a.ud_sc[l], a.ud_sb[l] = ud.stride(0), ud.stride(1)
        net = torch.empty((C, p, q), dtype=torch.int32, device=x.device)
        a.net[l] = net.data_ptr()
        nets.append(net)
    consts = _consts(plan, x.device)
    a.consts = consts.data_ptr()
    _launch(a, x.device)
    LAUNCHES.learn += 1
    return tuple(zs), tuple(nets)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def _route(x: torch.Tensor) -> str:
    if x.device.type in ("cpu", "cuda"):
        return x.device.type
    raise ValueError(f"tnn_wave runs on cpu or cuda tensors, not {x.device}")


def wave_forward(x: torch.Tensor, params: Sequence[torch.Tensor], *,
                 plan: NetworkPlan) -> Tuple[torch.Tensor, ...]:
    """One forward gamma wave through the whole cascade. Returns the
    per-layer post-WTA spike times z_i (B, C, q_i) uint8."""
    if _route(x) == "cpu":
        return tuple(z.to(SPIKE_DTYPE) for z in
                     wave_forward_plain(x, params, plan=plan))
    return _wave_forward_cuda(x, list(params), plan)


def wave_train(
    x: torch.Tensor,
    params: Sequence[torch.Tensor],
    uniforms: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    *,
    plan: NetworkPlan,
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """One learning gamma wave: the forward of every layer plus the
    per-layer STDP-counter epilogue. Returns ``(zs, nets)`` with the
    pre-clip batch-summed counters (apply once with
    ``core.stdp.apply_net``)."""
    if _route(x) == "cpu":
        return wave_train_plain(x, params, uniforms, plan=plan)
    return _wave_train_cuda(x, list(params), list(uniforms), plan)
