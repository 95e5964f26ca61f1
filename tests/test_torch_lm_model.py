"""The port's LM (``repro_torch.models.model``) against the JAX package's on
smoke configs: ``init_params`` bit for bit; ``forward_train``, ``prefill``
and ``decode_step`` on the reference's weights carried across by
``convert``, in float32 and bfloat16, comparing the logits AND the trunk
increment (the residual after the trunk, before ``final_norm``, minus the
embedded input: at the reference's random weights the embedding, drawn at
std 1.0, dominates the logits, so a wrong block can hide inside a logit
tolerance). A deliberately broken block must fail the increment check;
the port's own serving must equal its training, past the sliding window
too.

Tolerances, and the figures measured on this CPU (2 rows, 10 tokens):
- float32: logits within 1e-5 absolute (measured <= 1.5e-7); increment
  max |diff| within 1e-4 of its largest |value| (measured <= 2.5e-6).
- bfloat16 (bf16 residual stream; the products round differently in the
  two libraries): logits within 8e-3 absolute, four bf16 ulps at [0.5, 1)
  (measured 1.95e-3, one ulp); increment RMS diff within 0.1 of its RMS
  (measured 0.015-0.05: a single ulp of an embedding-sized residual, ~0.016,
  is a tenth of the increment's largest value).
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import layers as JL
from repro.models import model as JM

from repro_torch import convert
from repro_torch import random as t_random
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.params import tree_flatten
from torch_lm_params import FAST_COMPILE
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

PARITY_ARCHS = ("llama3.2-3b", "qwen1.5-4b", "minicpm3-4b", "mixtral-8x22b", "internvl2-76b")
SERVING_ARCHS = PARITY_ARCHS + ("mistral-nemo-12b", "grok-1-314b")
B, S, KV_CHUNK = 2, 10, 4
TOL = {"float32": dict(logits=1e-5, inc_max=1e-4),
       "bfloat16": dict(logits=8e-3, inc_rms=0.1)}


def _cfgs(arch, dtype):
    return (dataclasses.replace(j_smoke(arch), dtype=dtype, remat="none"),
            dataclasses.replace(t_smoke(arch), dtype=dtype, remat="none"))


def _no_drops(cfg):
    """An MoE config whose capacity holds every token (capacity depends on
    the token count, so a full forward and a decode step drop different
    tokens at the default factor: both packages do so)."""
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(cfg, moe_capacity_factor=cfg.n_experts / cfg.experts_per_token)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _tokens(seed=1, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, 256, shape)


def _inc_err(got, want, dtype):
    """The increment's error against its size: max |diff| / max |want| in
    float32, RMS diff / RMS want in bfloat16."""
    d = got - want
    if dtype == "float32":
        return float(np.abs(d).max() / np.abs(want).max())
    return float(np.sqrt((d ** 2).mean() / (want ** 2).mean()))


def _inc_ok(got, want, dtype):
    tol = TOL[dtype].get("inc_max", TOL[dtype].get("inc_rms"))
    return _inc_err(got, want, dtype) <= tol


def _reference(arch, dtype, params):
    """The reference's logits and trunk increments, each piece under one
    ``jax.jit``: forward_train of the tokens, prefill of all but the last,
    one decode step of the last at a shared position, then one at per-row
    positions."""
    jc, _ = _cfgs(arch, dtype)
    dt = jnp.dtype(jc.dtype)
    cdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tok = jnp.asarray(_tokens())

    @partial(jax.jit, compiler_options=FAST_COMPILE)
    def train(p, tok):
        x0 = JL.embed(tok, p["embed"], dt)
        x, _ = JM._run_trunk(x0, p, jc, "train", jnp.arange(S), kv_chunk=KV_CHUNK)
        return JM.forward_train(p, jc, tok, kv_chunk=KV_CHUNK), x - x0

    @partial(jax.jit, compiler_options=FAST_COMPILE)
    def prefill(p, tok, cache):
        x0 = JL.embed(tok, p["embed"], dt)
        x, _ = JM._run_trunk(x0, p, jc, "prefill", jnp.arange(tok.shape[1]), cache=cache,
                             kv_chunk=KV_CHUNK)
        last, cache = JM.prefill(p, jc, tok, cache, kv_chunk=KV_CHUNK)
        return last, x - x0, cache

    @partial(jax.jit, compiler_options=FAST_COMPILE)
    def decode(p, t, pos, cache):
        x0 = jnp.take(p["embed"]["embedding"].astype(dt), t, axis=0)
        x, _ = JM._run_trunk(x0, p, jc, "decode", None, cache=cache, pos=pos)
        logits, cache = JM.decode_step(p, jc, t, pos, cache)
        return logits, x - x0, cache

    out = {"train": tuple(map(_np, train(params, tok)))}
    last, inc, cache = prefill(params, tok[:, :S - 1], JM.init_cache(jc, B, S + 4, dtype=cdt))
    out["prefill"] = (_np(last), _np(inc))
    steps = []
    for t, pos in ((tok[:, S - 1], jnp.asarray([S - 1] * B, jnp.int32)),
                   (tok[:, 0], jnp.asarray([S, S - 3], jnp.int32))):
        logits, inc, cache = decode(params, t, pos, cache)
        steps.append((_np(logits), _np(inc)))
    out["decode"] = steps
    return out


@pytest.fixture(scope="module")
def reference():
    memo, drawn = {}, {}

    def get(arch, dtype):
        if arch not in drawn:
            # eager, as every caller of the reference draws (under one jit
            # XLA reassociates std * sqrt(2) * erf_inv(u) and the bits differ)
            drawn[arch] = JM.init_params(_cfgs(arch, dtype)[0], jax.random.PRNGKey(0))
        if (arch, dtype) not in memo:
            memo[(arch, dtype)] = dict(_reference(arch, dtype, drawn[arch]),
                                       params=jax.tree.map(np.asarray, drawn[arch]))
        return memo[(arch, dtype)]
    return get


def _port(arch, dtype, params_np, break_block=None):
    """The port's side of :func:`_reference` on the carried weights."""
    _, tc = _cfgs(arch, dtype)
    params = convert.lm_params_from_numpy(params_np, tc, "cpu")
    if break_block is not None:
        break_block(params)
    cdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tok = torch.from_numpy(_tokens())
    out = {"train": tuple(map(_np, TM.forward_train(params, tc, tok, kv_chunk=KV_CHUNK,
                                                    increment=True)))}
    cache = TM.init_cache(tc, B, S + 4, cdt, "cpu")
    last, cache, inc = TM.prefill(params, tc, tok[:, :S - 1], cache, kv_chunk=KV_CHUNK,
                                  increment=True)
    out["prefill"] = (_np(last), _np(inc))
    steps = []
    for t, pos in ((tok[:, S - 1], S - 1), (tok[:, 0], torch.tensor([S, S - 3]))):
        logits, cache, inc = TM.decode_step(params, tc, t, pos, cache, increment=True)
        steps.append((_np(logits), _np(inc)))
    out["decode"] = steps
    return out


def _pairs(got, want):
    yield "train", got["train"], want["train"]
    yield "prefill", got["prefill"], want["prefill"]
    for i, (g, w) in enumerate(zip(got["decode"], want["decode"])):
        yield f"decode{i}", g, w


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_init_params_bit_for_bit(arch, reference):
    want = reference(arch, "float32")["params"]
    got = TM.init_params(t_smoke(arch), t_random.PRNGKey(0), device="cpu")
    got_l, want_l = tree_flatten(got), tree_flatten(want)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, g), (_, w) in zip(got_l, want_l):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, path
        np.testing.assert_array_equal(g.numpy().view(np.uint32), w.view(np.uint32),
                                      err_msg=str(path))
    assert convert.lm_params_to_numpy(got).keys() == want.keys()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_forwards_match_reference(arch, dtype, reference):
    want = reference(arch, dtype)
    got = _port(arch, dtype, want["params"])
    tol = TOL[dtype]
    for name, (gl, gi), (wl, wi) in _pairs(got, want):
        assert gl.shape == wl.shape and gi.shape == wi.shape, name
        np.testing.assert_allclose(gl, wl, rtol=0, atol=tol["logits"], err_msg=name)
        assert _inc_ok(gi, wi, dtype), (name, _inc_err(gi, wi, dtype))


def _swap_heads(params):
    w = params["trunk"]["0_dense"]["attn"]["wq"]   # (layers, d, H, hd)
    w[0, :, [0, 1]] = w[0, :, [1, 0]]


@pytest.mark.parametrize("broken", ["swap_heads", "no_rope"])
def test_broken_block_fails_the_increment_check(broken, reference, monkeypatch):
    """Two query heads of layer 0 swapped, or RoPE dropped: the logits stay
    near the reference's, the float32 trunk increment does not. (The
    bfloat16 check cannot tell: its rounding noise is as large as these
    faults' effect at the reference's random weights, so the float32 check
    is the one that holds the blocks.)"""
    arch, dtype = "llama3.2-3b", "float32"
    want = reference(arch, dtype)
    if broken == "no_rope":
        monkeypatch.setattr(TL, "apply_rope", lambda x, positions, theta: x)
    got = _port(arch, dtype, want["params"],
                _swap_heads if broken == "swap_heads" else None)
    failed = [name for name, (_, gi), (_, wi) in _pairs(got, want)
              if not _inc_ok(gi, wi, dtype)]
    assert "train" in failed and "prefill" in failed, failed
    np.testing.assert_allclose(got["train"][0], want["train"][0], rtol=0, atol=0.05)


@pytest.mark.parametrize("arch", SERVING_ARCHS)
def test_serving_equals_training(arch):
    """The port's prefill + decode equal its own forward_train (as the
    reference's test_smoke_serving_equals_training), the trunk increments
    too."""
    cfg = _no_drops(_cfgs(arch, "float32")[1])
    params = TM.init_params(cfg, t_random.PRNGKey(0), device="cpu")
    tok = torch.from_numpy(_tokens(2))
    full, full_inc = TM.forward_train(params, cfg, tok, kv_chunk=KV_CHUNK, increment=True)
    cache = TM.init_cache(cfg, B, S + 2, torch.float32, "cpu")
    last, cache, inc = TM.prefill(params, cfg, tok[:, :S - 1], cache, kv_chunk=KV_CHUNK,
                                  increment=True)
    np.testing.assert_allclose(_np(last), _np(full[:, S - 2]), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(_np(inc), _np(full_inc[:, :S - 1]), rtol=0, atol=1e-5)
    logits, _, inc = TM.decode_step(params, cfg, tok[:, S - 1], S - 1, cache, increment=True)
    np.testing.assert_allclose(_np(logits), _np(full[:, S - 1]), rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(_np(inc), _np(full_inc[:, S - 1]), rtol=0, atol=1e-5)


def test_sliding_window_ring_beyond_window():
    """Mixtral SWA at window 8: prefill of 19 tokens rolls the last 8 into
    the ring, the decode at position 19 writes slot 19 % 8 and matches the
    full-context forward."""
    cfg = dataclasses.replace(_no_drops(_cfgs("mixtral-8x22b", "float32")[1]),
                              sliding_window=8)
    params = TM.init_params(cfg, t_random.PRNGKey(0), device="cpu")
    n = 20
    tok = torch.from_numpy(_tokens(3, (1, n)))
    full, full_inc = TM.forward_train(params, cfg, tok, kv_chunk=KV_CHUNK, increment=True)
    cache = TM.init_cache(cfg, 1, n + 2, torch.float32, "cpu")
    assert cache["trunk"]["0_moe"][0].shape[2] == 8   # ring = window
    _, cache = TM.prefill(params, cfg, tok[:, :n - 1], cache, kv_chunk=KV_CHUNK)
    logits, _, inc = TM.decode_step(params, cfg, tok[:, n - 1], n - 1, cache, increment=True)
    np.testing.assert_allclose(_np(logits), _np(full[:, n - 1]), rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(_np(inc), _np(full_inc[:, n - 1]), rtol=0, atol=1e-5)
