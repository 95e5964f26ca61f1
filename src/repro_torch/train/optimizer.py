"""Optimizers for LM training, as ``repro.train.optimizer`` defines them.

* AdamW: float32 moments, decoupled weight decay.
* Adafactor: factored second moment (row and column means) for the archs
  over 50B parameters, whose AdamW state would not fit; rank-1
  reconstruction, the beta2 ramp ``1 - count ** -0.8`` and update clipping
  to RMS <= 1.
* Global-norm clipping and the linear-warmup + cosine schedule.
* int8 gradient compression with error feedback (a per-tensor scale,
  round-half-even; the quantisation error is carried to the next step).

The state trees keep the reference's names and shapes: ``{"m", "v",
"count"}`` (AdamW), ``{"vr", "vc", "count"}`` (Adafactor; ``vc`` is (1,) for
a 1-D leaf) and ``"residual"`` under compression. ``count`` is an int32
0-dim tensor on the host, as the scalars of the schedule are computed there.

Every update works **in place**, leaf by leaf: the functions keep the
reference's signatures and return the trees they were given, with the
tensors updated. A model whose params, grads and two moments fill the card
cannot hold a second copy of any of them, so a leaf's temporaries are the
size of that leaf and freed before the next. The elementwise expressions
keep the reference's float32 order, one rounded op at a time; the scalars
(the schedule, the bias corrections, beta2) are float32 tensors computed in
the reference's order, never Python doubles. Reductions (norms, means) sum
in torch's order, so results agree with the reference within a few float32
ulps, not bit for bit.

On a mesh the leaves are DTensors, each grad on its param's placements
(``train.train_step``), and the moments placed by ``train_step.state_axes``.
The elementwise updates then run on each rank's block (``partition.local``),
in place; what reduces over a leaf (the global norm, the compression
scale, Adafactor's row and column means and its update RMS) is made whole
over the shards first, so every rank applies the same scalars.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.params import tree_flatten, tree_map
from repro_torch.sharding.partition import gather_tensor, is_sharded, local

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    compress_grads: bool = False  # int8 + error feedback at the reduce boundary


def _f32(x) -> torch.Tensor:
    """A Python number as a float32 0-dim host tensor (the rounding the
    reference's weakly typed scalars take against a float32 array)."""
    return torch.tensor(x, dtype=F32)


def _scalar(x) -> float:
    """A Python number or float32 0-dim tensor as the Python float an
    elementwise op takes, rounded to float32 first: a multiply or add by it
    rounds as by the float32 scalar, and the kernel keeps it in a register
    (a 0-dim device operand would be read as a broadcast tensor)."""
    return float(x.to(F32) if isinstance(x, torch.Tensor) else _f32(x))


def _divisor(x: torch.Tensor, dev) -> torch.Tensor:
    """A host float32 scalar as a 0-dim tensor on ``dev``, for a division:
    CUDA turns a division by a host scalar into a multiplication by its
    reciprocal, which rounds differently."""
    return x.to(dev)


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (int or int32 tensor): linear warmup,
    then cosine decay to 0.1 of ``lr``; a float32 host tensor."""
    step = torch.as_tensor(step, dtype=torch.int32).cpu()
    warm = torch.minimum(step.to(F32) / _f32(max(cfg.warmup_steps, 1)), _f32(1.0))
    t = torch.clamp((step - cfg.warmup_steps).to(F32)
                    / _f32(max(cfg.total_steps - cfg.warmup_steps, 1)), 0.0, 1.0)
    cos = _f32(0.5) * (_f32(1.0) + torch.cos(_f32(math.pi) * t))
    return _f32(cfg.lr) * warm * (_f32(0.1) + _f32(0.9) * cos)


def _leaves(tree):
    """A tree's tensors in the reference's leaf order (dict keys sorted)."""
    return [t for _, t in tree_flatten(tree)]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves
    summed in the reference's order; a 0-dim tensor on the leaves' device."""
    total = 0
    for leaf in _leaves(tree):
        total = total + gather_tensor(torch.sum(torch.square(leaf.to(F32))))
    return torch.sqrt(total)


def clip_scale(norm: torch.Tensor, max_norm: float) -> float:
    """``min(1, max_norm / max(norm, 1e-9))`` in float32, as the Python
    float the clip multiplies by."""
    return _scalar(torch.minimum(_f32(1.0), _f32(max_norm) / torch.clamp_min(
        norm.cpu(), _f32(1e-9))))


def clip_by_global_norm(tree, max_norm: float):
    """Scale every leaf, in place, by :func:`clip_scale` of the global norm.
    Returns ``(tree, norm)``, the norm before clipping."""
    norm = global_norm(tree)
    scale = clip_scale(norm, max_norm)
    if scale != 1.0:               # a multiply by 1 changes no bit
        for leaf in _leaves(tree):
            local(leaf).mul_(scale)
    return tree, norm


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback
# ---------------------------------------------------------------------------


def compress_init(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=F32), params)


def compress_decompress(grads, residual):
    """Quantise ``grad + residual`` to int8 with a per-tensor scale
    (``max |x| / 127``, round half to even) and keep the quantisation error
    as the new residual. In place: each grad leaf becomes its dequantised
    value, each residual leaf the error. Returns ``(grads, residual)``."""
    for (path, g), (rpath, r) in zip(tree_flatten(grads), tree_flatten(residual)):
        if path != rpath or g.shape != r.shape:
            raise ValueError(f"residual leaf {rpath} does not match grad {path}")
        if g.dtype != F32:
            raise TypeError(f"{path}: grads are float32, got {g.dtype}")
        x = local(r).add_(local(g))                    # g + r
        # max |x|, no temporary; over every shard of a sharded leaf
        peak = torch.maximum(gather_tensor(r.amax()), -gather_tensor(r.amin()))
        g = local(g)
        scale = torch.clamp_min(peak, 1e-9) / _divisor(_f32(127.0), x.device)
        q = torch.round(x / scale).clamp_(-127, 127)   # the int8 values, exactly
        torch.mul(q, scale, out=g)                     # deq
        del q
        x.sub_(g)                                      # x - deq
    return grads, residual


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _count():
    return torch.zeros((), dtype=torch.int32)


def adamw_init(params) -> Dict[str, Any]:
    zeros = lambda: tree_map(lambda p: torch.zeros_like(p, dtype=F32), params)  # noqa: E731
    return {"m": zeros(), "v": zeros(), "count": _count()}


def adamw_update(grads, state, params, cfg: OptConfig):
    """One AdamW step, in place on ``params`` and ``state``; returns them."""
    count = state["count"].add_(1)
    lr = _scalar(schedule(cfg, count))
    count_f = count.to(F32)
    c1 = _f32(1.0) - torch.pow(_f32(cfg.b1), count_f)
    c2 = _f32(1.0) - torch.pow(_f32(cfg.b2), count_f)
    b1, b2, eps, wd = (_scalar(x) for x in (cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay))
    one_b1, one_b2 = _scalar(1 - cfg.b1), _scalar(1 - cfg.b2)
    leaves = zip(tree_flatten(params), tree_flatten(grads), tree_flatten(state["m"]),
                 tree_flatten(state["v"]))
    divisors = {}
    for (_, p), (_, g), (_, m), (_, v) in leaves:
        p, g, m, v = local(p), local(g), local(m), local(v)
        if p.device not in divisors:
            divisors[p.device] = (_divisor(c1, p.device), _divisor(c2, p.device))
        c1_d, c2_d = divisors[p.device]
        g = g.to(F32)
        # m = b1 * m + (1 - b1) * g;  v = b2 * v + (1 - b2) * g^2
        t = torch.mul(g, one_b1)
        m.mul_(b1).add_(t)
        torch.square(g, out=t).mul_(one_b2)
        v.mul_(b2).add_(t)
        # p - lr * ((m / c1) / (sqrt(v / c2) + eps) + wd * p)
        torch.div(v, c2_d, out=t).sqrt_().add_(eps)
        step = torch.div(m, c1_d).div_(t)
        torch.mul(p, wd, out=t)
        step.add_(t).mul_(lr)
        del t
        p.sub_(step)
        del step
    return params, state


DETERMINED_EPS = 10.0   # adamw_determined's floor on sqrt(v-hat), in eps


def adamw_determined(vs, counts, cfg: OptConfig) -> torch.Tensor:
    """The elements of a leaf whose AdamW steps the data determines: where
    the bias-corrected ``sqrt(v / (1 - b2 ** count))`` is at least
    DETERMINED_EPS eps in every one of the given second moments ``vs`` (each
    after the step whose ``count`` is given). Below that the denominator is
    eps-level and the update is linear in the grad with a gain of ``lr /
    eps``, so a rounding-level grad (one that is zero in exact arithmetic)
    moves the param by a fraction of ``lr``. A bool tensor of the leaf's
    shape."""
    out = None
    for v, count in zip(vs, counts):
        corrected = v.double() / (1.0 - cfg.b2 ** int(count))
        ok = corrected.sqrt() >= DETERMINED_EPS * cfg.eps
        out = ok if out is None else out & ok
    return out


def _ulp32(x: torch.Tensor) -> torch.Tensor:
    """The float32 spacing at ``|x|`` (float64 in and out)."""
    a = x.abs().to(F32)
    return (torch.nextafter(a, torch.full_like(a, math.inf)) - a).double()


def adamw_step_bound(dprev, new, ms, vs, count: int, cfg: OptConfig,
                     ulps: int) -> torch.Tensor:
    """A bound, per element, on ``|p_a - p_b|`` after one AdamW step of two
    runs a and b of the same leaf, from the update's own formula:

        p = p_prev - lr * (u + wd * p_prev),   u = m^ / (sqrt(v^) + eps)

    so ``|p_a - p_b| <= |dprev| * |1 - lr wd| + lr * |u_a - u_b|`` plus each
    run's rounding. ``dprev`` is ``|p_a - p_b|`` before the step (zeros for
    a common start), ``new`` both runs' params after it, ``ms`` and ``vs``
    both runs' moments after it, ``count`` the step's count (1 for the first
    step). At count 1, ``m^ = g`` and ``v^ = g^2``, and ``g / (|g| + eps)``
    has a slope of at most ``1 / eps``, so ``|u_a - u_b| <= |g_a - g_b| /
    eps`` with g read off each run's m^; at later counts ``u_a - u_b`` is
    taken from both runs' m^ and v^. The rounding: ``ulps`` float32 ulps of
    each run's param and of its update ``lr (|u| + wd |p|)``. Float64, of
    the leaf's shape."""
    # the float32 scalars adamw_update applies
    lr = _scalar(schedule(cfg, count))
    count_f = torch.tensor(count, dtype=F32)
    c1 = float(_f32(1.0) - torch.pow(_f32(cfg.b1), count_f))
    c2 = float(_f32(1.0) - torch.pow(_f32(cfg.b2), count_f))
    eps, wd = _scalar(cfg.eps), _scalar(cfg.weight_decay)
    u = [(m.double() / c1) / ((v.double() / c2).sqrt() + eps) for m, v in zip(ms, vs)]
    if count == 1:
        du = (ms[0].double() - ms[1].double()).abs() / (c1 * eps)
    else:
        du = (u[0] - u[1]).abs()
    tol = sum(_ulp32(p) + lr * _ulp32(uu.abs() + wd * p.double().abs())
              for p, uu in zip(new, u))
    return dprev.double() * abs(1.0 - lr * wd) + lr * du + ulps * tol


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; beta2 ramp per Shazeer & Stern)
# ---------------------------------------------------------------------------


def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor_init(params) -> Dict[str, Any]:
    def vr(p):
        return (torch.zeros(p.shape[:-1], dtype=F32, device=p.device)
                if _factored(p.shape) else torch.zeros_like(p, dtype=F32))

    def vc(p):
        return (torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=F32, device=p.device)
                if _factored(p.shape) else torch.zeros((1,), dtype=F32, device=p.device))

    return {"vr": tree_map(vr, params), "vc": tree_map(vc, params), "count": _count()}


def adafactor_update(grads, state, params, cfg: OptConfig):
    """One Adafactor step, in place on ``params`` and ``state``; returns them."""
    count = state["count"].add_(1)
    lr = _scalar(schedule(cfg, count))
    beta2 = _f32(1.0) - torch.pow(count.to(F32), _f32(-0.8))
    b2, one_b2 = _scalar(beta2), _scalar(_f32(1.0) - beta2)
    wd = _scalar(cfg.weight_decay)
    leaves = zip(tree_flatten(params), tree_flatten(grads), tree_flatten(state["vr"]),
                 tree_flatten(state["vc"]))
    for (_, p), (_, g), (_, vr), (_, vc) in leaves:
        if is_sharded(p):
            _adafactor_sharded(p, g, vr, vc, b2, one_b2, wd, lr)
            continue
        g = g.to(F32)
        g2 = torch.square(g).add_(1e-30)
        if _factored(p.shape):
            vr.mul_(b2).add_(g2.mean(dim=-1).mul_(one_b2))
            vc.mul_(b2).add_(g2.mean(dim=-2).mul_(one_b2))
            # rsqrt(vr vc^T / max(mean(vr), 1e-30) + 1e-30), in g2's buffer
            torch.mul(vr[..., None], vc[..., None, :], out=g2)
            g2.div_(torch.clamp_min(vr.mean(dim=-1, keepdim=True)[..., None], 1e-30))
        else:
            vr.mul_(b2).add_(g2.mul_(one_b2))
            g2.copy_(vr)
        step = g2.add_(1e-30).rsqrt_().mul_(g)
        rms = torch.sqrt(torch.mean(torch.square(step)) + 1e-30)
        step.div_(torch.clamp_min(rms, 1.0))
        step.add_(torch.mul(p, wd)).mul_(lr)
        p.sub_(step)
        del g2, step
    return params, state


def _adafactor_sharded(p, g, vr, vc, b2, one_b2, wd, lr) -> None:
    """One Adafactor leaf update on DTensors, in place on the blocks of
    ``p``, ``vr`` and ``vc``: the same ops in the same order as the plain
    update, with the means over the whole leaf (DTensor reductions,
    brought to the moment's placements) and the update's RMS made whole."""
    from torch.distributed.tensor import DTensor

    def to(x, like):
        return local(x.redistribute(like.device_mesh, like.placements))

    g = g.to(F32)
    g2 = torch.square(g) + 1e-30
    if _factored(p.shape):
        local(vr).mul_(b2).add_(to(g2.mean(dim=-1), vr).mul_(one_b2))
        local(vc).mul_(b2).add_(to(g2.mean(dim=-2), vc).mul_(one_b2))
        den = torch.clamp_min(vr.mean(dim=-1, keepdim=True).unsqueeze(-1), 1e-30)
        u = to((vr.unsqueeze(-1) * vc.unsqueeze(-2)) / den, p)
    else:
        # a 1-D leaf's vr has the leaf's shape but no axes: replicated
        local(vr).mul_(b2).add_(to(g2, vr).mul_(one_b2))
        u = to(vr, p).clone()
    step = u.add_(1e-30).rsqrt_().mul_(local(g))
    whole = DTensor.from_local(step, p.device_mesh, p.placements, run_check=False)
    rms = torch.sqrt(gather_tensor(torch.mean(torch.square(whole))) + 1e-30)
    step.div_(torch.clamp_min(rms, 1.0))
    step.add_(torch.mul(local(p), wd)).mul_(lr)
    local(p).sub_(step)


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------


def opt_init(params, cfg: OptConfig) -> Dict[str, Any]:
    state = adamw_init(params) if cfg.name == "adamw" else adafactor_init(params)
    if cfg.compress_grads:
        state["residual"] = compress_init(params)
    return state


def opt_update(grads, state, params, cfg: OptConfig) -> Tuple[Any, Dict[str, Any], torch.Tensor]:
    """Compress (optional), clip, update: in place on ``grads``, ``state``
    and ``params``. Returns ``(params, state, grad_norm)``, the norm after
    compression and before clipping."""
    if cfg.name not in ("adamw", "adafactor"):
        raise ValueError(cfg.name)
    if cfg.compress_grads:
        compress_decompress(grads, state["residual"])
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    core = {k: v for k, v in state.items() if k != "residual"}
    if cfg.name == "adamw":
        adamw_update(grads, core, params, cfg)
    else:
        adafactor_update(grads, core, params, cfg)
    return params, state, gnorm


def default_opt_for(n_params: int) -> str:
    return "adafactor" if n_params > 50e9 else "adamw"
