"""Recurrent/state-space blocks: Mamba2 (zamba2), mLSTM + sLSTM (xLSTM), as
``repro.models.ssm`` defines them.

All three share one gated linear recurrence over a matrix state,
``H_t = a_t * H_{t-1} + b_t x_t^T`` read out as ``y_t = c_t H_t``, which the
train and prefill forms evaluate with the chunked algorithm (Mamba2's SSD):
intra-chunk terms through an (L x L) decay-masked product, the carry between
chunks through a loop over the chunks (the reference's ``lax.scan``). All of
it in float32. Decode takes one recurrence step on the constant-size state.

Recurrent states are float32 whatever the cache dtype (Mamba's ``h``, the
mLSTM's matrix memory and normaliser, the sLSTM's ``(c, n, h, m)``); only
Mamba's convolution window takes the cache dtype. The casts follow the
reference's order: projections in the activations' dtype, the recurrence
and the gates in float32, each result cast back where the reference casts
it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _proj
from repro_torch.models.params import ParamSpec
from repro_torch.sharding.context import shard_activation
from repro_torch.sharding.partition import (
    contiguous_grad, gather_tensor, is_sharded, local_slices, pad_blocks,
)

F32 = torch.float32


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _rms(y: torch.Tensor, eps: float, dt: torch.dtype) -> torch.Tensor:
    """The blocks' own RMS normalisation: float32 statistics, then ``dt``."""
    yf = y.to(F32)
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps)).to(dt)


# ---------------------------------------------------------------------------
# Shared chunked linear recurrence
#   state H: (B, heads, N, P);  a: (B, S, h) decay in (0,1] (log given)
#   b: (B, S, h, N) input key;  xv: (B, S, h, P) input value; c: (B, S, h, N)
#   y[t] = c_t @ H_t,  H_t = a_t H_{t-1} + b_t xv_t^T
# ---------------------------------------------------------------------------


def chunked_lrnn(log_a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 xv: torch.Tensor, h0: torch.Tensor, chunk: int = 256
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, h, P), h_final (B, h, N, P)), all float32. The chunk
    length is ``min(chunk, S)``, halved until it divides S."""
    B, S, h, N = b.shape
    P = xv.shape[-1]
    L = min(chunk, S)
    while S % L:
        L //= 2
    nc = S // L

    la = log_a.to(F32).reshape(B, nc, L, h)
    bf = b.to(F32).reshape(B, nc, L, h, N)
    cf = c.to(F32).reshape(B, nc, L, h, N)
    xf = xv.to(F32).reshape(B, nc, L, h, P)

    cum = torch.cumsum(la, dim=2)  # (B, nc, L, h) inclusive, within the chunk
    total = cum[:, :, -1]  # (B, nc, h)

    # intra-chunk: y_intra[i] = sum_{j<=i} exp(cum_i - cum_j) (c_i . b_j) xv_j.
    # For i < j the exponent is >= 0 and can be large: mask it to -inf
    # BEFORE the exponential (exp first, then a 0/1 mask, gives inf * 0).
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, i, j, h)
    ii = torch.arange(L, device=b.device)
    mask = ii[:, None] >= ii[None, :]
    decay = torch.where(mask[None, None, :, :, None], decay,
                        torch.tensor(-torch.inf, dtype=F32, device=b.device))
    g = torch.einsum("bnihk,bnjhk->bnijh", cf, bf) * torch.exp(decay)
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", g, xf)

    # what each chunk injects into the state it hands on:
    # sum_j exp(total - cum_j) b_j xv_j^T
    w = torch.exp(total[:, :, None, :] - cum)  # (B, nc, L, h)
    inj = torch.einsum("bnjhk,bnjhp->bnhkp", bf * w[..., None], xf)  # (B, nc, h, N, P)

    hprev = h0.to(F32)
    h_in = []
    for n in range(nc):
        h_in.append(hprev)  # the state entering chunk n
        hprev = torch.exp(total[:, n])[..., None, None] * hprev + inj[:, n]
    h_in = torch.stack(h_in, dim=1)  # (B, nc, h, N, P)

    # inter-chunk: y_inter[i] = exp(cum_i) c_i @ h_in
    y_inter = torch.einsum("bnihk,bnhkp->bnihp", cf * torch.exp(cum)[..., None], h_in)
    y = (y_intra + y_inter).reshape(B, S, h, P)
    return y, hprev


def lrnn_rows(log_a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
              xv: torch.Tensor, h0: torch.Tensor, chunk: int = 256
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`chunked_lrnn`; on DTensors, on each rank's batch rows
    (:func:`_on_rows`): DTensor's propagation through the recurrence's
    einsums fails a view of a permuted local block in the backward on torch
    2.11 (ROADMAP Queue 3 item 14). Plain tensors go straight through."""
    if not is_sharded(b):
        return chunked_lrnn(log_a, b, c, xv, h0, chunk)
    return _on_rows(lambda *t: chunked_lrnn(*t, chunk), (log_a, b, c, xv, h0), b)


def _on_rows(fn, tensors, like) -> Tuple[torch.Tensor, ...]:
    """``fn`` of ``tensors`` on each rank's batch rows as plain tensors (the
    rows are independent), every other dim whole; the outputs DTensors
    placed so (rows sharded as ``like``'s, the rest replicated)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dm = like.device_mesh
    want = [Shard(0) if pl.is_shard(0) else Replicate() for pl in like.placements]
    rows = local_slices(like.shape, dm, want)[0]

    def block(t):
        if is_sharded(t):
            return contiguous_grad(t.redistribute(dm, want).to_local())
        return t[rows]

    out = fn(*(block(t) for t in tensors))
    return tuple(DTensor.from_local(t.contiguous(), dm, want, run_check=False) for t in out)


def lrnn_decode_step(log_a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                     xv: torch.Tensor, h: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrence step. log_a: (B, h); b, c: (B, h, N); xv: (B, h, P);
    h: (B, h, N, P). Returns (y (B, h, P), new h), float32. On DTensors, on
    each rank's batch rows (:func:`_on_rows`): the einsum's view merges the
    sharded batch and head dims, which torch 2.11 refuses (ROADMAP Queue 3
    item 14)."""
    if is_sharded(h):
        return _on_rows(_lrnn_decode_step, (log_a, b, c, xv, h), h)
    return _lrnn_decode_step(log_a, b, c, xv, h)


def _lrnn_decode_step(log_a, b, c, xv, h):
    hn = torch.exp(log_a.to(F32))[..., None, None] * h.to(F32) + torch.einsum(
        "bhk,bhp->bhkp", b.to(F32), xv.to(F32))
    y = torch.einsum("bhk,bhkp->bhp", c.to(F32), hn)
    return y, hn


# ---------------------------------------------------------------------------
# Mamba2 block (zamba2 backbone)
# ---------------------------------------------------------------------------


def mamba_spec(cfg) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    N = cfg.ssm_state
    heads = d_in // cfg.ssm_head_dim
    conv_ch = d_in + 2 * N
    return {
        "win": ParamSpec((d, 2 * d_in + 2 * N + heads), ("embed", "mlp")),
        "conv_w": ParamSpec((cfg.conv_width, conv_ch), (None, "mlp"), scale=0.5),
        "conv_b": ParamSpec((conv_ch,), ("mlp",), init="zeros"),
        "a_log": ParamSpec((heads,), (None,), init="zeros"),
        "dt_bias": ParamSpec((heads,), (None,), init="zeros"),
        "skip_d": ParamSpec((heads,), (None,), init="ones"),
        "norm": ParamSpec((d_in,), ("mlp",), init="ones"),
        "wout": ParamSpec((d_in, d), ("mlp", "embed")),
    }


def _mamba_split(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    N = cfg.ssm_state
    heads = d_in // cfg.ssm_head_dim
    return d_in, N, heads


def pad_seq(x: torch.Tensor, before: int) -> torch.Tensor:
    """``F.pad(x, (0, 0, before, 0))``: ``before`` zeros ahead of the
    sequence (dim 1). On a DTensor each rank pads its own block (the
    sequence dim made whole first, where it is sharded, and partial sums
    reduced), so no pad op sees a DTensor: DTensor's redistribution fails
    on ``F.pad`` in torch 2.11 (ROADMAP Queue 3 item 14)."""
    return pad_blocks(x, (0, 0, before, 0))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d along the sequence, then SiLU. xbc: (B, S, C);
    w: (K, C)."""
    K = w.shape[0]
    pad = pad_seq(xbc, K - 1)
    out = torch.zeros_like(xbc)
    for k in range(K):
        out = out + pad[:, k:k + xbc.shape[1], :] * w[k]
    return F.silu(out + b)


def mamba_train(x: torch.Tensor, p: Dict, cfg, chunk: int = 256) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d). Chunked SSD scan, no cache."""
    y, _, _ = _mamba_run(x, p, cfg, h0=None, conv_state=None, chunk=chunk)
    return y


def mamba_init_state(cfg, B: int, dtype, device, lead: Tuple[int, ...] = ()):
    """(h (lead + (B, heads, N, P)) float32, conv window (lead + (B, K-1, C))
    in ``dtype``), zeros."""
    d_in, N, heads = _mamba_split(cfg)
    conv_ch = d_in + 2 * N
    return (torch.zeros(lead + (B, heads, N, cfg.ssm_head_dim), dtype=F32, device=device),
            torch.zeros(lead + (B, cfg.conv_width - 1, conv_ch), dtype=dtype, device=device))


def _mamba_run(x, p, cfg, h0, conv_state, chunk):
    """Returns (out (B, S, d), final h, the last K-1 conv inputs or None)."""
    B, S, d = x.shape
    d_in, N, heads = _mamba_split(cfg)
    dt_ = x.dtype
    z_x_bc_dt = torch.matmul(x, p["win"].to(dt_))
    z, xs, B_in, C_in, dt_raw = torch.split(z_x_bc_dt, [d_in, d_in, N, N, heads], dim=-1)
    xbc = torch.cat([xs, B_in, C_in], dim=-1)
    if conv_state is not None:
        # the concatenation promotes to the wider of the cache's and the
        # activations' dtypes, as the reference's does
        xbc_ext = torch.cat([conv_state, xbc], dim=1)
        new_conv = xbc_ext[:, -(cfg.conv_width - 1):, :]
        K = p["conv_w"].shape[0]
        short = K - 1 - conv_state.shape[1]
        # a padding of nothing (the cache's window is full) is skipped
        pad = pad_seq(xbc_ext, short) if short > 0 else xbc_ext
        w = p["conv_w"].to(dt_)
        out = 0
        for k in range(K):
            out = out + pad[:, k:k + S, :] * w[k]
        xbc = F.silu(out + p["conv_b"].to(dt_))
    else:
        new_conv = None
        xbc = _causal_conv(xbc, p["conv_w"].to(dt_), p["conv_b"].to(dt_))
    xs, B_in, C_in = torch.split(xbc, [d_in, N, N], dim=-1)

    dt = softplus(dt_raw.to(F32) + p["dt_bias"])  # (B, S, h)
    A = -torch.exp(p["a_log"].to(F32))  # (h,) negative
    log_a = dt * A
    xh = xs.reshape(B, S, heads, cfg.ssm_head_dim)
    bh = B_in[:, :, None, :].expand(B, S, heads, N) * dt[..., None]
    ch = C_in[:, :, None, :].expand(B, S, heads, N)
    if h0 is None:
        h0 = torch.zeros((B, heads, N, cfg.ssm_head_dim), dtype=F32, device=x.device)
    y, h_fin = lrnn_rows(log_a, bh, ch, xh, h0, chunk)
    y = y.to(dt_) + xh * p["skip_d"].to(dt_)[None, None, :, None]
    y = y.reshape(B, S, d_in)
    y = y * F.silu(z)
    y = _rms(y, cfg.norm_eps, dt_) * p["norm"].to(dt_)
    out = torch.matmul(y, p["wout"].to(dt_))
    return shard_activation(out, ("batch", "seq", "embed")), h_fin, new_conv


def mamba_decode(x: torch.Tensor, p: Dict, cfg, state) -> Tuple[torch.Tensor, Tuple]:
    """x: (B, d) one token; state = (h (B, h, N, P) float32, conv (B, K-1, C)).
    One direct recurrence step (``lrnn_decode_step``). Returns (out, (h,
    conv)), new tensors."""
    h, conv = state
    B, d = x.shape
    d_in, N, heads = _mamba_split(cfg)
    dt_ = x.dtype
    z_x_bc_dt = torch.matmul(x, p["win"].to(dt_))
    z, xs, B_in, C_in, dt_raw = torch.split(z_x_bc_dt, [d_in, d_in, N, N, heads], dim=-1)
    xbc = torch.cat([xs, B_in, C_in], dim=-1)  # (B, C)
    # causal conv over the stored K-1 inputs and this one
    hist = torch.cat([conv.to(dt_), xbc[:, None, :]], dim=1)  # (B, K, C)
    w = p["conv_w"].to(dt_)  # (K, C)
    out = (hist * w[None]).sum(dim=1) + p["conv_b"].to(dt_)
    xbc = F.silu(out)
    new_conv = hist[:, 1:, :].to(conv.dtype)
    xs, B_in, C_in = torch.split(xbc, [d_in, N, N], dim=-1)

    dt = softplus(dt_raw.to(F32) + p["dt_bias"])  # (B, h)
    A = -torch.exp(p["a_log"].to(F32))
    log_a = dt * A
    xh = xs.reshape(B, heads, cfg.ssm_head_dim)
    bh = B_in[:, None, :].expand(B, heads, N) * dt[..., None]
    ch = C_in[:, None, :].expand(B, heads, N)
    y, h_new = lrnn_decode_step(log_a, bh, ch, xh, h)
    y = y.to(dt_) + xh * p["skip_d"].to(dt_)[None, :, None]
    y = y.reshape(B, d_in) * F.silu(z)
    y = _rms(y, cfg.norm_eps, dt_) * p["norm"].to(dt_)
    return torch.matmul(y, p["wout"].to(dt_)), (h_new, new_conv)


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM): exponential-gated matrix memory
# ---------------------------------------------------------------------------


def mlstm_spec(cfg) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    H = cfg.n_heads
    dk = d_in // H
    return {
        "wup": ParamSpec((d, 2 * d_in), ("embed", "mlp")),
        "wq": ParamSpec((d_in, H, dk), ("mlp", "heads", "head_dim")),
        "wk": ParamSpec((d_in, H, dk), ("mlp", "heads", "head_dim")),
        "wv": ParamSpec((d_in, H, dk), ("mlp", "heads", "head_dim")),
        "wif": ParamSpec((d_in, 2 * H), ("mlp", None), scale=0.01),
        "bif": ParamSpec((2 * H,), (None,), init="zeros"),
        "norm": ParamSpec((d_in,), ("mlp",), init="ones"),
        "wdown": ParamSpec((d_in, d), ("mlp", "embed")),
    }


def _mlstm_gates(xi: torch.Tensor, p: Dict, H: int):
    """(log input gate, log forget gate), float32, (..., H) each."""
    gf = torch.matmul(xi.to(F32), p["wif"].to(F32)) + p["bif"].to(F32)
    i_raw, f_raw = torch.chunk(gf, 2, dim=-1)
    log_f = -softplus(-f_raw)  # log sigmoid(f): in (-inf, 0)
    log_i = torch.clamp_max(i_raw, 0.0) - 2.0  # bounded exponential input gate
    return log_i, log_f


def _mlstm_key(k: torch.Tensor, log_i: torch.Tensor) -> torch.Tensor:
    """The recurrence's key: ``k * exp(log_i) / sqrt(dk)`` in float32 (dk
    is the key width ``ssm_expand * d / H``, not the config's head_dim)."""
    dk = k.shape[-1]
    return k.to(F32) * torch.exp(log_i)[..., None] / (dk ** 0.5)


def _mlstm_out(y, z, p, cfg, dt_):
    y = y.to(dt_) * F.silu(z)
    y = _rms(y, cfg.norm_eps, dt_) * p["norm"].to(dt_)
    return torch.matmul(y, p["wdown"].to(dt_))


def mlstm_train(x: torch.Tensor, p: Dict, cfg, chunk: int = 256) -> torch.Tensor:
    B, S, d = x.shape
    H = cfg.n_heads
    dt_ = x.dtype
    up = torch.matmul(x, p["wup"].to(dt_))
    xi, z = torch.chunk(up, 2, dim=-1)  # (B, S, d_in) each
    q, k, v = _proj(xi, p["wq"]), _proj(xi, p["wk"]), _proj(xi, p["wv"])
    log_i, log_f = _mlstm_gates(xi, p, H)  # (B, S, H)
    dk = q.shape[-1]
    kin = _mlstm_key(k, log_i)
    h0 = torch.zeros((B, H, dk, dk), dtype=F32, device=x.device)
    y, _ = lrnn_rows(log_f, kin, q.to(F32), v.to(F32), h0, chunk)
    # the normaliser: the same recurrence with value 1
    ones = torch.ones(v.shape[:-1] + (1,), dtype=F32, device=x.device)
    n0 = torch.zeros((B, H, dk, 1), dtype=F32, device=x.device)
    nrm, _ = lrnn_rows(log_f, kin, q.to(F32), ones, n0, chunk)
    y = y / torch.clamp_min(torch.abs(nrm), 1.0)
    return _mlstm_out(y.reshape(B, S, -1), z, p, cfg, dt_)


def mlstm_init_state(cfg, B: int, device, lead: Tuple[int, ...] = ()):
    """(matrix memory (B, H, dk, dk), normaliser (B, H, dk, 1)), float32 zeros."""
    H = cfg.n_heads
    dk = cfg.ssm_expand * cfg.d_model // H
    return (torch.zeros(lead + (B, H, dk, dk), dtype=F32, device=device),
            torch.zeros(lead + (B, H, dk, 1), dtype=F32, device=device))


def mlstm_decode(x: torch.Tensor, p: Dict, cfg, state) -> Tuple[torch.Tensor, Tuple]:
    Hm, n = state
    B, d = x.shape
    H = cfg.n_heads
    dt_ = x.dtype
    up = torch.matmul(x, p["wup"].to(dt_))
    xi, z = torch.chunk(up, 2, dim=-1)
    q, k, v = _proj(xi, p["wq"]), _proj(xi, p["wk"]), _proj(xi, p["wv"])
    log_i, log_f = _mlstm_gates(xi, p, H)  # (B, H)
    kin = _mlstm_key(k, log_i)
    y, Hm = lrnn_decode_step(log_f, kin, q, v, Hm)
    ones = torch.ones((B, H, 1), dtype=F32, device=x.device)
    nv, n = lrnn_decode_step(log_f, kin, q, ones, n)
    y = y / torch.clamp_min(torch.abs(nv), 1.0)
    return _mlstm_out(y.reshape(B, -1), z, p, cfg, dt_), (Hm, n)


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM): scalar memory, a strictly sequential recurrence
# ---------------------------------------------------------------------------


def slstm_spec(cfg) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    return {
        "wx": ParamSpec((d, 4 * d), ("embed", "mlp")),  # z, i, f, o pre-activations
        "wr": ParamSpec((H, dh, 4 * dh), (None, "head_dim", None), scale=0.05),
        "b": ParamSpec((4 * d,), ("mlp",), init="zeros"),
        "norm": ParamSpec((d,), ("embed",), init="ones"),
        "wff1": ParamSpec((d, cfg.ssm_expand * d), ("embed", "mlp")),
        "wff2": ParamSpec((cfg.ssm_expand * d, d), ("mlp", "embed")),
    }


def slstm_init_state(cfg, B: int, device, lead: Tuple[int, ...] = ()):
    """(c, n, h, m), float32 (B, d) each; the stabiliser m starts at -10."""
    shape = lead + (B, cfg.d_model)
    return (torch.zeros(shape, dtype=F32, device=device),
            torch.zeros(shape, dtype=F32, device=device),
            torch.zeros(shape, dtype=F32, device=device),
            torch.full(shape, -10.0, dtype=F32, device=device))


def _slstm_cell(carry, xt, p, cfg):
    c, n, h, m = carry
    H = cfg.n_heads
    B, d = c.shape
    dh = d // H
    hh = h.reshape(B, H, dh)
    # the recurrent term is head-block-diagonal: regroup each head's (z, i,
    # f, o) quarters into the [z | i | f | o] layout of the wx pre-activations
    rec = torch.einsum("bhk,hkg->bhg", hh, p["wr"].to(F32))
    rec = rec.reshape(B, H, 4, dh).transpose(1, 2).reshape(B, 4 * d)
    pre = xt.to(F32) + rec
    z, i_raw, f_raw, o = torch.chunk(pre, 4, dim=-1)
    log_f = -softplus(-f_raw)
    m_new = torch.maximum(log_f + m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c_new = f_g * c + i_g * torch.tanh(z)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(o) * c_new / torch.clamp_min(n_new, 1.0)
    return (c_new, n_new, h_new, m_new)


def _slstm_scan(pre: torch.Tensor, state, p, cfg):
    """The cell over the sequence (B, S, 4d) from ``state``. Returns (the
    final state, every step's h (B, S, d) float32)."""
    hs = []
    for t in range(pre.shape[1]):
        state = _slstm_cell(state, pre[:, t], p, cfg)
        hs.append(state[2])
    return state, torch.stack(hs, dim=1)


def _slstm_rows(pre: torch.Tensor, state, p, cfg):
    """:func:`_slstm_scan`; on DTensors on each rank's batch rows
    (:func:`_on_rows`) with the recurrent weight made whole: torch 2.11
    fails a step's sum of the input term (rows over the data axis) and the
    recurrent term (a partial sum over the model axis) at full width
    (ROADMAP Queue 3 item 14). For the serve steps, whose state is the
    cache's."""
    if not is_sharded(pre):
        return _slstm_scan(pre, state, p, cfg)
    whole = {"wr": gather_tensor(p["wr"])}

    def scan(pre_, *st):
        st, hs = _slstm_scan(pre_, st, whole, cfg)
        return (*st, hs)

    *state, hs = _on_rows(scan, (pre, *state), pre)
    return tuple(state), hs


def _slstm_out(h, p, cfg, dt_):
    h = _rms(h.to(dt_), cfg.norm_eps, dt_) * p["norm"].to(dt_)
    f = F.gelu(torch.matmul(h, p["wff1"].to(dt_)), approximate="tanh")
    return torch.matmul(f, p["wff2"].to(dt_))


def slstm_pre(x: torch.Tensor, p: Dict) -> torch.Tensor:
    dt_ = x.dtype
    return torch.matmul(x, p["wx"].to(dt_)) + p["b"].to(dt_)


def slstm_train(x: torch.Tensor, p: Dict, cfg) -> torch.Tensor:
    """Strictly sequential over S (the sLSTM's nature)."""
    state = slstm_init_state(cfg, x.shape[0], x.device)
    _, hs = _slstm_scan(slstm_pre(x, p), state, p, cfg)
    return _slstm_out(hs, p, cfg, x.dtype)


def slstm_decode(x: torch.Tensor, p: Dict, cfg, state) -> Tuple[torch.Tensor, Tuple]:
    new, hs = _slstm_rows(slstm_pre(x, p).unsqueeze(1), state, p, cfg)
    return _slstm_out(hs[:, 0], p, cfg, x.dtype), new
