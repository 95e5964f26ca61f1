"""The port's LM families beyond the attention decoders against the JAX
package on smoke configs: the SSM (xlstm-125m: mLSTM + sLSTM), the hybrid
(zamba2-7b: Mamba2, the shared attention block, the unstacked tail), the
encoder-decoder (whisper-tiny: the encoder, cross-attention and its cache)
and the VLM prefix (internvl2-76b: ``embeds`` through ``frontend_proj``).

``init_params`` bit for bit (the ``tail``, ``shared``, ``encoder`` and
``frontend_proj`` subtrees in the reference's key order); ``forward_train``,
``prefill`` and ``decode_step`` on the reference's weights carried across by
``convert``, in float32 and bfloat16, comparing the logits and the trunk
increment (the residual after the trunk and tail minus the trunk's input:
the embedded tokens after the projected prefix); the port's serving equal to
its training; ``convert`` both ways. Frames and embeds are drawn from a
numpy seed, never zeros: zero frames make the encoder output zero, so a
broken cross-attention would add exactly nothing and pass (zero embeds do
the same to ``frontend_proj``).

Tolerances (2 rows, 10 tokens, a prefix of 8 embeds or 16 frames):
- float32 against the reference: logits within 3e-4 (train, prefill) and
  3e-3 (decode), the reference's own serving-vs-training bounds; increment
  max |diff| within 1e-4 of its largest |value|.
- bfloat16: logits within 8e-3 absolute (the attention decoders' bound,
  tests/test_torch_lm_model.py) or one bf16 ulp of the largest |logit|,
  whichever is larger: the tied archs' logits reach ~73, where one ulp is
  0.5 (measured: xlstm-125m and whisper-tiny 0.25, zamba2-7b 7.3e-3,
  internvl2-76b 2e-3); increment RMS diff within 0.1 of its RMS (measured
  0.005-0.039).
- measured in float32: logits <= 1.5e-5 (|logits| up to 73), increments
  <= 3.1e-6 of their largest value.
- serving against training (the port alone, float32): 3e-4 / 3e-3 on the
  logits, the increments within 1e-5.
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
from repro_torch.models import model as TM
from repro_torch.models.params import tree_flatten
from torch_lm_params import FAST_COMPILE
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

FAMILY_ARCHS = ("xlstm-125m", "zamba2-7b", "whisper-tiny", "internvl2-76b")
B, S, KV_CHUNK = 2, 10, 4
TOL = {"float32": dict(logits=3e-4, decode=3e-3, inc_max=1e-4),
       "bfloat16": dict(logits=8e-3, decode=8e-3, inc_rms=0.1)}


def _cfgs(arch, dtype):
    return (dataclasses.replace(j_smoke(arch), dtype=dtype, remat="none"),
            dataclasses.replace(t_smoke(arch), dtype=dtype, remat="none"))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _tokens(seed=1, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, 256, shape)


def _extras(cfg, seed=5):
    """The family's extra inputs, float32 numpy drawn from a seed: ``embeds``
    (B, frontend_len, d) for the VLM, ``frames`` (B, enc_seq, d) for the
    encoder-decoder; and the prefix length the embeds add to the positions."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "vision_stub":
        return {"embeds": rng.standard_normal((B, cfg.frontend_len, cfg.d_model),
                                              dtype=np.float32)}, cfg.frontend_len
    if cfg.n_enc_layers:
        return {"frames": rng.standard_normal((B, cfg.enc_seq, cfg.d_model),
                                              dtype=np.float32)}, 0
    return {}, 0


def _logit_tol(name, want, dtype):
    tol = TOL[dtype]["decode" if name.startswith("decode") else "logits"]
    if dtype == "bfloat16":
        tol = max(tol, 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7))
    return tol


def _inc_err(got, want, dtype):
    d = got - want
    if dtype == "float32":
        return float(np.abs(d).max() / np.abs(want).max())
    return float(np.sqrt((d ** 2).mean() / (want ** 2).mean()))


def _inc_ok(got, want, dtype):
    tol = TOL[dtype].get("inc_max", TOL[dtype].get("inc_rms"))
    return _inc_err(got, want, dtype) <= tol


def _reference(arch, dtype, params):
    """The reference's logits and trunk increments, each piece under one
    ``jax.jit``: forward_train, prefill of all tokens but the last, a decode
    step of the last at a shared position, then one at per-row positions."""
    jc, _ = _cfgs(arch, dtype)
    dt = jnp.dtype(jc.dtype)
    cdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tok = jnp.asarray(_tokens())
    extras_np, P = _extras(jc)
    extras = {k: jnp.asarray(v) for k, v in extras_np.items()}

    def trunk_in(p, tok, ex):
        x0 = JM._prefix_embeds(JL.embed(tok, p["embed"], dt), ex.get("embeds"), p, jc)
        enc = JM._run_encoder(p, jc, ex["frames"].astype(dt)) if "frames" in ex else None
        return x0, enc

    @partial(jax.jit, compiler_options=FAST_COMPILE)
    def train(p, tok, ex):
        x0, enc = trunk_in(p, tok, ex)
        x, _ = JM._run_trunk(x0, p, jc, "train", jnp.arange(x0.shape[1]),
                             shared=p.get("shared"), enc_out=enc, kv_chunk=KV_CHUNK)
        return JM.forward_train(p, jc, tok, kv_chunk=KV_CHUNK, **ex), x - x0

    @partial(jax.jit, compiler_options=FAST_COMPILE)
    def prefill(p, tok, cache, ex):
        x0, enc = trunk_in(p, tok, ex)
        x, _ = JM._run_trunk(x0, p, jc, "prefill", jnp.arange(x0.shape[1]), cache=cache,
                             shared=p.get("shared"), enc_out=enc, kv_chunk=KV_CHUNK)
        last, cache = JM.prefill(p, jc, tok, cache, kv_chunk=KV_CHUNK, **ex)
        return last, x - x0, cache

    @partial(jax.jit, compiler_options=FAST_COMPILE)
    def decode(p, t, pos, cache):
        x0 = jnp.take(p["embed"]["embedding"].astype(dt), t, axis=0)
        x, _ = JM._run_trunk(x0, p, jc, "decode", None, cache=cache, pos=pos,
                             shared=p.get("shared"))
        logits, cache = JM.decode_step(p, jc, t, pos, cache)
        return logits, x - x0, cache

    out = {"train": tuple(map(_np, train(params, tok, extras)))}
    cache = JM.init_cache(jc, B, P + S + 4, dtype=cdt)
    last, inc, cache = prefill(params, tok[:, :S - 1], cache, extras)
    out["prefill"] = (_np(last), _np(inc))
    steps = []
    for t, pos in ((tok[:, S - 1], jnp.asarray([P + S - 1] * B, jnp.int32)),
                   (tok[:, 0], jnp.asarray([P + S, P + S - 3], jnp.int32))):
        logits, inc, cache = decode(params, t, pos, cache)
        steps.append((_np(logits), _np(inc)))
    out["decode"] = steps
    return out


@pytest.fixture(scope="module")
def reference():
    memo, drawn = {}, {}

    def get(arch, dtype):
        if arch not in drawn:
            drawn[arch] = JM.init_params(_cfgs(arch, dtype)[0], jax.random.PRNGKey(0))
        if (arch, dtype) not in memo:
            memo[(arch, dtype)] = dict(_reference(arch, dtype, drawn[arch]),
                                       params=jax.tree.map(np.asarray, drawn[arch]))
        return memo[(arch, dtype)]
    return get


def _port(arch, dtype, params_np):
    _, tc = _cfgs(arch, dtype)
    params = convert.lm_params_from_numpy(params_np, tc, "cpu")
    cdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tok = torch.from_numpy(_tokens())
    extras_np, P = _extras(tc)
    extras = {k: torch.from_numpy(v) for k, v in extras_np.items()}
    out = {"train": tuple(map(_np, TM.forward_train(params, tc, tok, kv_chunk=KV_CHUNK,
                                                    increment=True, **extras)))}
    cache = TM.init_cache(tc, B, P + S + 4, cdt, "cpu")
    last, cache, inc = TM.prefill(params, tc, tok[:, :S - 1], cache, kv_chunk=KV_CHUNK,
                                  increment=True, **extras)
    out["prefill"] = (_np(last), _np(inc))
    steps = []
    for t, pos in ((tok[:, S - 1], P + S - 1), (tok[:, 0], torch.tensor([P + S, P + S - 3]))):
        logits, cache, inc = TM.decode_step(params, tc, t, pos, cache, increment=True)
        steps.append((_np(logits), _np(inc)))
    out["decode"] = steps
    return out


def _pairs(got, want):
    yield "train", got["train"], want["train"]
    yield "prefill", got["prefill"], want["prefill"]
    for i, (g, w) in enumerate(zip(got["decode"], want["decode"])):
        yield f"decode{i}", g, w


# the top-level subtrees each family adds to the attention decoders' tree
NEW_SUBTREES = {"xlstm-125m": (), "zamba2-7b": ("tail", "shared"),
                "whisper-tiny": ("encoder",), "internvl2-76b": ("frontend_proj",)}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_init_params_bit_for_bit(arch, reference):
    want = reference(arch, "float32")["params"]
    got = TM.init_params(t_smoke(arch), t_random.PRNGKey(0), device="cpu")
    got_l, want_l = tree_flatten(got), tree_flatten(want)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, g), (_, w) in zip(got_l, want_l):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, path
        np.testing.assert_array_equal(g.numpy().view(np.uint32), w.view(np.uint32),
                                      err_msg=str(path))
    assert set(NEW_SUBTREES[arch]) <= set(got)
    assert sorted(got) == sorted(want)
    assert TM.param_count(t_smoke(arch)) == sum(w.size for _, w in want_l)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_forwards_match_reference(arch, dtype, reference):
    want = reference(arch, dtype)
    got = _port(arch, dtype, want["params"])
    for name, (gl, gi), (wl, wi) in _pairs(got, want):
        assert gl.shape == wl.shape and gi.shape == wi.shape, name
        np.testing.assert_allclose(gl, wl, rtol=0, atol=_logit_tol(name, wl, dtype),
                                   err_msg=name)
        assert _inc_ok(gi, wi, dtype), (name, _inc_err(gi, wi, dtype))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_serving_equals_training(arch):
    """The port's prefill + decode equal its own forward_train, with the
    family's frames or embeds (the reference's
    test_smoke_serving_equals_training), the trunk increments too."""
    cfg = _cfgs(arch, "float32")[1]
    params = TM.init_params(cfg, t_random.PRNGKey(0), device="cpu")
    tok = torch.from_numpy(_tokens(2))
    extras_np, P = _extras(cfg, seed=6)
    extras = {k: torch.from_numpy(v) for k, v in extras_np.items()}
    full, full_inc = TM.forward_train(params, cfg, tok, kv_chunk=KV_CHUNK, increment=True,
                                      **extras)
    assert full.shape == (B, P + S, cfg.vocab_size)
    cache = TM.init_cache(cfg, B, P + S + 2, torch.float32, "cpu")
    last, cache, inc = TM.prefill(params, cfg, tok[:, :S - 1], cache, kv_chunk=KV_CHUNK,
                                  increment=True, **extras)
    np.testing.assert_allclose(_np(last), _np(full[:, P + S - 2]), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(_np(inc), _np(full_inc[:, :P + S - 1]), rtol=0, atol=1e-5)
    logits, _, inc = TM.decode_step(params, cfg, tok[:, S - 1], P + S - 1, cache,
                                    increment=True)
    np.testing.assert_allclose(_np(logits), _np(full[:, P + S - 1]), rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(_np(inc), _np(full_inc[:, P + S - 1]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-76b"])
def test_extras_reach_the_logits(arch):
    """Other frames or embeds change every logit: the cross-attention and
    the projected prefix are read (a zero input could not show it)."""
    cfg = _cfgs(arch, "float32")[1]
    params = TM.init_params(cfg, t_random.PRNGKey(0), device="cpu")
    tok = torch.from_numpy(_tokens(3))
    name, a = next(iter(_extras(cfg, seed=7)[0].items()))
    b = _extras(cfg, seed=8)[0][name]
    la = TM.forward_train(params, cfg, tok, kv_chunk=KV_CHUNK, **{name: torch.from_numpy(a)})
    lb = TM.forward_train(params, cfg, tok, kv_chunk=KV_CHUNK, **{name: torch.from_numpy(b)})
    P = la.shape[1] - S
    assert (la[:, P:] - lb[:, P:]).abs().amax(-1).min() > 1e-4


def test_recurrent_states_stay_float32():
    """A bf16 cache keeps the recurrent states in float32 (sLSTM's m starts
    at -10); Mamba's conv window and the attention K/V take the cache
    dtype; the tail is unstacked, the trunk stacked."""
    z = TM.init_cache(t_smoke("zamba2-7b"), 3, 8, torch.bfloat16, "cpu")
    h, conv = z["trunk"]["0_mamba"]
    assert h.dtype == torch.float32 and conv.dtype == torch.bfloat16
    assert h.shape[:2] == (2, 3) and z["tail"]["0_mamba"][0].shape[0] == 3
    assert z["trunk"]["5_shared_attn"][0].dtype == torch.bfloat16
    x = TM.init_cache(t_smoke("xlstm-125m"), 3, 8, torch.bfloat16, "cpu")
    assert all(t.dtype == torch.float32 for t in x["trunk"]["0_mlstm"] + x["trunk"]["2_slstm"])
    assert bool((x["trunk"]["2_slstm"][3] == -10.0).all())


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_convert_round_trip(arch, reference):
    want = reference(arch, "float32")["params"]
    cfg = t_smoke(arch)
    back = convert.lm_params_to_numpy(convert.lm_params_from_numpy(want, cfg, "cpu"))
    w_l, b_l = tree_flatten(want), tree_flatten(back)
    assert [p for p, _ in w_l] == [p for p, _ in b_l]
    for (path, w), (_, b) in zip(w_l, b_l):
        np.testing.assert_array_equal(b, w, err_msg=str(path))
    # a tree missing one subtree's leaf, or with an extra one, is refused
    for section in NEW_SUBTREES[arch]:
        short = dict(want)
        short.pop(section)
        with pytest.raises(KeyError, match="leaves differ"):
            convert.lm_params_from_numpy(short, cfg, "cpu")
    extra = dict(want, tail={"9_mamba": {"ln": {"scale": np.ones(cfg.d_model, np.float32)}}})
    with pytest.raises(KeyError, match="leaves differ"):
        convert.lm_params_from_numpy(extra, cfg, "cpu")
