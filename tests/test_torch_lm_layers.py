"""The port's transformer primitives (``repro_torch.models.layers`` and
``.moe``) against the JAX package's on the same float32 inputs, made with
numpy from a seed: norms, RoPE, the MLPs, chunked flash attention (causal,
windowed, cross, KV-padded, several chunks, offset queries), decode
attention, the in-place cache write, GQA decode past the sliding window,
MLA prefill and absorbed decode, and the MoE FFN with dropped tokens,
several groups and decode's single group. Tolerance: 2e-6 absolute on
values of order 1 (float32, products of a few dozen terms; measured
differences are below 5e-7), exact for the cache write and the routing."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import layers as JL
from repro.models import moe as JMOE

from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from torch_lm_params import FAST_COMPILE
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

ATOL = 2e-6


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0, atol=atol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jit(fn, *args, **kw):
    """The reference's ``fn(*args, **kw)`` under one ``jax.jit`` (one compile
    instead of one per eager op), its keyword arguments static."""
    return jax.jit(lambda *a: fn(*a, **kw), compiler_options=FAST_COMPILE)(*args)


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x, s = _rand(rng, 3, 5, 64), _rand(rng, 64)
    _close(TL.rmsnorm(_t(x), {"scale": _t(s)}, 1e-5),
           JL.rmsnorm(jnp.asarray(x), {"scale": jnp.asarray(s)}, 1e-5))


@pytest.mark.parametrize("per_row", [False, True])
def test_rope(per_row):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 3, 16)
    pos = (rng.integers(0, 5000, (2, 7)) if per_row else np.arange(7) + 100).astype(np.int32)
    _close(TL.apply_rope(_t(x), _t(pos), 500_000.0),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0), atol=2e-5)
    _close(TL.rope_freqs(16, 1e4), JL.rope_freqs(16, 1e4), atol=1e-7)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp(act):
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 5, 64)
    p = {k: _rand(rng, *s.shape, scale=0.1) for k, s in JL.mlp_spec(64, 96, act).items()}
    _close(TL.mlp(_t(x), {k: _t(v) for k, v in p.items()}, act),
           JL.mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, act))


FLASH_CASES = {
    "causal": dict(Sq=12, Skv=12, kw=dict(causal=True, kv_chunk=512)),
    "multi_chunk": dict(Sq=12, Skv=12, kw=dict(causal=True, kv_chunk=4)),
    "kv_padded": dict(Sq=11, Skv=11, kw=dict(causal=True, kv_chunk=4)),
    "windowed": dict(Sq=13, Skv=13, kw=dict(causal=True, window=5, kv_chunk=4)),
    "cross": dict(Sq=6, Skv=9, kw=dict(cross=True, kv_chunk=4)),
    "offset": dict(Sq=4, Skv=10, kw=dict(causal=True, q_offset=6, kv_chunk=3)),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention(case):
    c = FLASH_CASES[case]
    rng = np.random.default_rng(3)
    q = _rand(rng, 2, c["Sq"], 4, 16)
    k, v = _rand(rng, 2, c["Skv"], 2, 16), _rand(rng, 2, c["Skv"], 2, 16)
    _close(TL.flash_attention(_t(q), _t(k), _t(v), **c["kw"]),
           JL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **c["kw"]))


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention(per_row):
    rng = np.random.default_rng(4)
    q = _rand(rng, 3, 4, 16)
    kc, vc = _rand(rng, 3, 9, 2, 16), _rand(rng, 3, 9, 2, 16)
    length = np.asarray([1, 5, 9], np.int32) if per_row else np.int32(6)
    _close(TL.decode_attention(_t(q), _t(kc), _t(vc), _t(length)),
           JL.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                               jnp.asarray(length)))


@pytest.mark.parametrize("slot", [3, [0, 7, 2], [5, 9, -1]])
def test_cache_write(slot):
    """In place, equal to the reference's masked select (a slot outside
    [0, S) writes nothing)."""
    rng = np.random.default_rng(5)
    cache, new = _rand(rng, 3, 8, 2, 4), _rand(rng, 3, 2, 4)
    slot = np.asarray(slot, np.int32)
    got = _t(cache.copy())
    out = TL.cache_write(got, _t(new), _t(slot))
    assert out is got
    want = JL.cache_write(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(slot))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _cfg(arch, **kw):
    return dataclasses.replace(j_smoke(arch), dtype="float32", **kw)


def _params(spec_fn, cfg, rng, scale=0.2):
    return {k: _rand(rng, *s.shape, scale=scale) + (1.0 if s.init == "ones" else 0.0)
            for k, s in spec_fn(cfg).items()}


def test_gqa_decode_past_the_window():
    """Sliding-window decode writes the ring slot pos % S and attends to the
    window; rows at different positions, some past the window."""
    cfg = _cfg("mixtral-8x22b", sliding_window=6)
    rng = np.random.default_rng(6)
    p = _params(JL.gqa_spec, cfg, rng)
    B, S = 3, cfg.sliding_window
    kc = _rand(rng, B, S, cfg.n_kv_heads, cfg.head_dim)
    vc = _rand(rng, B, S, cfg.n_kv_heads, cfg.head_dim)
    x = _rand(rng, B, cfg.d_model)
    pos = np.asarray([2, 6, 17], np.int32)
    want, (wk, wv) = _jit(JL.gqa_decode, jnp.asarray(x),
                          {k: jnp.asarray(v) for k, v in p.items()}, cfg=cfg,
                          cache=(jnp.asarray(kc), jnp.asarray(vc)), pos=jnp.asarray(pos))
    tk, tv = _t(kc.copy()), _t(vc.copy())
    got, _ = TL.gqa_decode(_t(x), {k: _t(v) for k, v in p.items()}, cfg, (tk, tv), _t(pos))
    _close(got, want)
    _close(tk, wk)
    _close(tv, wv)


def test_gqa_prefill_with_bias():
    cfg = _cfg("qwen1.5-4b")
    rng = np.random.default_rng(7)
    p = _params(JL.gqa_spec, cfg, rng)
    x = _rand(rng, 2, 9, cfg.d_model)
    pos = np.arange(9, dtype=np.int32)
    want, (wk, wv) = _jit(JL.gqa_prefill, jnp.asarray(x),
                          {k: jnp.asarray(v) for k, v in p.items()}, cfg=cfg,
                          positions=jnp.asarray(pos), kv_chunk=4)
    got, (tk, tv) = TL.gqa_prefill(_t(x), {k: _t(v) for k, v in p.items()}, cfg, _t(pos),
                                   kv_chunk=4)
    for g, w in ((got, want), (tk, wk), (tv, wv)):
        _close(g, w)


def test_mla_prefill_and_decode():
    cfg = _cfg("minicpm3-4b")
    rng = np.random.default_rng(8)
    p = _params(JL.mla_spec, cfg, rng)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    x = _rand(rng, 2, 7, cfg.d_model)
    pos = np.arange(7, dtype=np.int32)
    want, (wc, wkr) = _jit(JL.mla_prefill, jnp.asarray(x), jp, cfg=cfg,
                           positions=jnp.asarray(pos), kv_chunk=4)
    got, (tc, tkr) = TL.mla_prefill(_t(x), tp, cfg, _t(pos), kv_chunk=4)
    for g, w in ((got, want), (tc, wc), (tkr, wkr)):
        _close(g, w)
    # absorbed decode against a cache of 10 positions, rows at 7 and 4
    S = 10
    cc = np.zeros((2, S, cfg.kv_lora_rank), np.float32)
    kr = np.zeros((2, S, cfg.qk_rope_dim), np.float32)
    cc[:, :7], kr[:, :7] = np.asarray(wc), np.asarray(wkr)
    xd = _rand(rng, 2, cfg.d_model)
    dpos = np.asarray([7, 4], np.int32)
    want, (wc2, wkr2) = _jit(JL.mla_decode, jnp.asarray(xd), jp, cfg=cfg,
                             cache=(jnp.asarray(cc), jnp.asarray(kr)), pos=jnp.asarray(dpos))
    tc2, tkr2 = _t(cc.copy()), _t(kr.copy())
    got, _ = TL.mla_decode(_t(xd), tp, cfg, (tc2, tkr2), _t(dpos))
    for g, w in ((got, want), (tc2, wc2), (tkr2, wkr2)):
        _close(g, w)


MOE_CASES = {
    "drops": dict(B=2, S=8, cfg=dict(moe_capacity_factor=0.5), n_groups=0),
    "two_groups": dict(B=4, S=6, cfg=dict(moe_groups=2), n_groups=0),
    "group_shape": dict(B=4, S=6, cfg=dict(moe_group_shape=(2, 3)), n_groups=0),
    "decode": dict(B=5, S=1, cfg=dict(), n_groups=1),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn(case):
    c = MOE_CASES[case]
    cfg = _cfg("mixtral-8x22b", **c["cfg"])
    rng = np.random.default_rng(9)
    p = _params(JMOE.moe_spec, cfg, rng, scale=0.3)
    x = _rand(rng, c["B"], c["S"], cfg.d_model)
    want = _jit(JMOE.moe_ffn, jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                cfg=cfg, n_groups=c["n_groups"])
    got = TMOE.moe_ffn(_t(x), {k: _t(v) for k, v in p.items()}, cfg, n_groups=c["n_groups"])
    _close(got, want, atol=1e-5)
    if case == "drops":   # the capacity really drops tokens here
        logits = x.reshape(-1, cfg.d_model) @ p["router"]
        top = np.argsort(-logits, axis=1, kind="stable")[:, :cfg.experts_per_token]
        cap = int((c["B"] * c["S"] * cfg.experts_per_token / cfg.n_experts)
                  * cfg.moe_capacity_factor) + 1
        assert np.bincount(top.ravel(), minlength=cfg.n_experts).max() > cap


def test_top_k_takes_the_lower_index_on_ties():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0], [2.0, 2.0, 2.0, 2.0, 2.0]])
    vals, idx = TMOE.top_k(logits, 2)
    assert idx.tolist() == [[1, 2], [0, 1]]
    assert vals.tolist() == [[3.0, 3.0], [2.0, 2.0]]
