"""The port's recurrent blocks (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm``: the chunked linear recurrence, and the
Mamba2, mLSTM and sLSTM blocks' train and decode forms at smoke widths, in
float32 and bfloat16.

The blocks' weights are the reference's draw, with the leaves it
initialises to constants (Mamba's ``a_log``, ``dt_bias``, ``skip_d``,
``conv_b``, ``norm``; the mLSTM's ``bif``; the sLSTM's ``b``) replaced by
draws from a numpy seed, so a fault in their use cannot hide behind a zero
or a one. Sequences of 12 with a chunk of 8 run the chunk-length rule (8
does not divide 12, so L = 4: three chunks and two carries).

Tolerances: float32 max |diff| within 1e-4 of the largest |value| (outputs
and states; measured <= 3.7e-7); bfloat16 RMS diff within 0.05 of the RMS
(the outputs are bf16 products summed in each library's own order;
measured <= 0.0098). The recurrence itself, in float32: within 1e-5 of its
largest value against the reference and against a step-by-step loop of
``lrnn_decode_step``. The sLSTM with its head regroup left out is 0.19 off
in float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import params as JP
from repro.models import ssm as JSSM

from repro_torch.models import ssm as TSSM
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

B, S, CHUNK = 2, 12, 8
F32_TOL, BF16_TOL = 1e-4, 0.05
# leaves drawn at a constant by the reference: given random values here
RANDOMISED = {"a_log": 0.5, "dt_bias": 0.5, "skip_d": 1.0, "conv_b": 0.2,
              "norm": 1.0, "bif": 1.0, "b": 0.5}


def _cfg(block):
    arch = "zamba2-7b" if block == "mamba" else "xlstm-125m"
    return dataclasses.replace(j_smoke(arch), remat="none")


def _params(block, cfg, seed=0):
    """The block's params as numpy: the reference's draw, the constant leaves
    randomised (centred on their constant)."""
    spec = {"mamba": JSSM.mamba_spec, "mlstm": JSSM.mlstm_spec,
            "slstm": JSSM.slstm_spec}[block](cfg)
    p = jax.tree.map(np.asarray, JP.tree_init(spec, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    for name, scale in RANDOMISED.items():
        if name in p:
            base = 1.0 if name in ("skip_d", "norm") else 0.0
            p[name] = (base + scale * rng.standard_normal(p[name].shape)).astype(np.float32)
    return p


def _x(cfg, seed=3):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _j(a, dtype):
    return jnp.asarray(a).astype(jnp.dtype(dtype))


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a)).to(getattr(torch, dtype))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _err(got, want, dtype):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
    return float(np.sqrt(((got - want) ** 2).mean() / max((want ** 2).mean(), 1e-30)))


def _ok(got, want, dtype):
    return _err(got, want, dtype) <= (F32_TOL if dtype == "float32" else BF16_TOL)


def _lrnn_inputs(seed, S_, h=3, N=4, P=5, decay=1.0):
    rng = np.random.default_rng(seed)
    log_a = -decay * np.abs(rng.standard_normal((B, S_, h))).astype(np.float32)
    b, c = (rng.standard_normal((B, S_, h, N)).astype(np.float32) for _ in range(2))
    xv = rng.standard_normal((B, S_, h, P)).astype(np.float32)
    h0 = rng.standard_normal((B, h, N, P)).astype(np.float32)
    return log_a, b, c, xv, h0


@pytest.mark.parametrize("S_,chunk,decay", [(12, 8, 1.0), (13, 4, 1.0), (12, 8, 40.0)])
def test_chunked_lrnn(S_, chunk, decay):
    """Against the reference and a step-by-step loop, at S not a multiple of
    the chunk (12 by 8 runs L = 4; 13, prime, runs L = 1) and with a
    strongly decaying log_a (-40 a step: exp(cum_i - cum_j) for i < j
    overflows unless masked first; no NaN)."""
    ins = _lrnn_inputs(S_ + chunk, S_, decay=decay)
    y, hf = TSSM.chunked_lrnn(*map(torch.from_numpy, ins), chunk=chunk)
    yj, hj = JSSM.chunked_lrnn(*map(jnp.asarray, ins), chunk=chunk)
    assert np.isfinite(_np(y)).all() and np.isfinite(_np(hf)).all()
    for got, want in ((y, yj), (hf, hj)):
        assert _err(got, want, "float32") <= 1e-5
    log_a, b, c, xv, h = map(torch.from_numpy, ins)
    ys = []
    for t in range(S_):
        yt, h = TSSM.lrnn_decode_step(log_a[:, t], b[:, t], c[:, t], xv[:, t], h)
        ys.append(yt)
    assert _err(y, torch.stack(ys, 1), "float32") <= 1e-5
    assert _err(hf, h, "float32") <= 1e-5


def test_lrnn_decode_step_matches_reference():
    log_a, b, c, xv, h0 = _lrnn_inputs(9, 1)
    args = (log_a[:, 0], b[:, 0], c[:, 0], xv[:, 0], h0)
    for got, want in zip(TSSM.lrnn_decode_step(*map(torch.from_numpy, args)),
                         JSSM.lrnn_decode_step(*map(jnp.asarray, args))):
        assert _err(got, want, "float32") <= 1e-6


def _train(block, cfg, p, x, dtype, port: bool):
    if port:
        pt = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
        xt = _t(x, dtype)
        if block == "slstm":
            return TSSM.slstm_train(xt, pt, cfg)
        return getattr(TSSM, f"{block}_train")(xt, pt, cfg, chunk=CHUNK)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    xj = _j(x, dtype)
    if block == "slstm":
        return JSSM.slstm_train(xj, pj, cfg)
    return getattr(JSSM, f"{block}_train")(xj, pj, cfg, chunk=CHUNK)


def _decode(block, cfg, p, xs, dtype, port: bool, steps=3):
    """``steps`` decode steps from the zero state. Returns the outputs and
    the final state."""
    if port:
        pt = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
        if block == "mamba":
            state = TSSM.mamba_init_state(cfg, B, getattr(torch, dtype), "cpu")
        else:
            state = getattr(TSSM, f"{block}_init_state")(cfg, B, "cpu")
        step, conv = getattr(TSSM, f"{block}_decode"), lambda a: _t(a, dtype)
    else:
        pt = {k: jnp.asarray(v) for k, v in p.items()}
        if block == "mamba":
            state = JSSM.mamba_init_state(cfg, B, jnp.dtype(dtype))
        else:
            state = getattr(JSSM, f"{block}_init_state")(cfg, B)
        step, conv = getattr(JSSM, f"{block}_decode"), lambda a: _j(a, dtype)
    outs = []
    for t in range(steps):
        y, state = step(conv(xs[:, t]), pt, cfg, state)
        outs.append(y)
    return outs, state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", ["mamba", "mlstm", "slstm"])
def test_block_matches_reference(block, dtype):
    cfg = dataclasses.replace(_cfg(block), dtype=dtype)
    p = _params(block, cfg)
    x = _x(cfg)
    got = _train(block, cfg, p, x, dtype, port=True)
    want = _train(block, cfg, p, x, dtype, port=False)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    assert _ok(got, want, dtype), ("train", _err(got, want, dtype))
    g_out, g_state = _decode(block, cfg, p, x, dtype, port=True)
    w_out, w_state = _decode(block, cfg, p, x, dtype, port=False)
    for i, (g, w) in enumerate(zip(g_out, w_out)):
        assert _ok(g, w, dtype), (f"decode {i}", _err(g, w, dtype))
    for i, (g, w) in enumerate(zip(g_state, w_state)):
        assert g.dtype == (torch.float32 if block != "mamba" or i == 0
                           else getattr(torch, dtype)), i
        assert _ok(g, w, dtype), (f"state {i}", _err(g, w, dtype))


def _swapped_regroup_cell(carry, xt, p, cfg):
    """The sLSTM cell with the head regroup left out: (B, H, 4, dh) read as
    if it were already [z | i | f | o]."""
    c, n, h, m = carry
    H = cfg.n_heads
    Bc, d = c.shape
    rec = torch.einsum("bhk,hkg->bhg", h.reshape(Bc, H, d // H), p["wr"].float())
    rec = rec.reshape(Bc, 4 * d)
    pre = xt.float() + rec
    z, i_raw, f_raw, o = torch.chunk(pre, 4, dim=-1)
    log_f = -TSSM.softplus(-f_raw)
    m_new = torch.maximum(log_f + m, i_raw)
    i_g, f_g = torch.exp(i_raw - m_new), torch.exp(log_f + m - m_new)
    c_new = f_g * c + i_g * torch.tanh(z)
    n_new = f_g * n + i_g
    return (c_new, n_new, torch.sigmoid(o) * c_new / torch.clamp_min(n_new, 1.0), m_new)


def test_slstm_regroup_mutant_fails(monkeypatch):
    """The recurrent weights are drawn at std 0.05, so a wrong regroup moves
    the block's output only a little, but the float32 check sees it."""
    cfg = dataclasses.replace(_cfg("slstm"), dtype="float32")
    p = _params("slstm", cfg)
    x = _x(cfg)
    want = _train("slstm", cfg, p, x, "float32", port=False)
    monkeypatch.setattr(TSSM, "_slstm_cell", _swapped_regroup_cell)
    got = _train("slstm", cfg, p, x, "float32", port=True)
    assert not _ok(got, want, "float32"), _err(got, want, "float32")
