"""The port's LM train step (``repro_torch.train.train_step``) against the
JAX package's (``repro.train.train_step``) on smoke configs, in float32:
loss and grads for one arch of each family (dense, MoE, MLA, the hybrid,
the SSM, the encoder-decoder with seeded ``frames``, the VLM with seeded
``embeds``, so the prefix slice is covered), ``micro_steps=2`` against the
reference's scan, three full steps, remat equal to no remat in the port,
the non-finite step that leaves the state as it was, and the state
carried across by ``convert``.

Params come from the reference's ``init_params(PRNGKey(0))``, carried
across by ``convert`` (drawn eagerly for llama3.2-3b and zamba2-7b, whose
shapes later tests draw eagerly again; by the port for the others, its draw
equal to the reference's bit for bit, ``tests/torch_lm_params.py``); the
reference's jits compile at ``FAST_COMPILE``; batches from the token stream
(seed 0). Tolerances:
- one loss and its grads: loss within 1e-5 relative, every leaf's grads
  within 1e-4 of that leaf's max |grad| (measured <= 3.8e-6, zamba2-7b;
  the others <= 9e-7). The port's trunk runs under remat "full".
- steps (3 of llama3.2-3b, AdamW, lr 1e-3, B = 4, S = 16): per-step
  ``loss``, ``loss_total`` and ``grad_norm`` within 1e-5 relative
  (measured 2e-7); params after the last step within 0.25 lr at most
  (measured 5.7e-6 = 0.0057 lr here; 0.066 lr between the H100 and the
  CPU on llama3.2-3b at 2 layers, chip_smoke.py, which holds the card to
  these same tolerances) and within 1e-3 of the RMS distance they moved
  in RMS (measured 3.4e-5; card against CPU 1.4e-4); moments within 1e-4
  of their RMS change (measured 1.1e-6). AdamW's normalised update turns a
  grad that differs in its last bits near ``eps`` into a step that differs
  by a fraction of lr, so params are held in lr, not in ulps.
- remat: "none", "dots" and "full" give the same grads bit for bit.
- micro-steps: the grads added into one tree equal the sum from zero of
  each microbatch's grads bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.data.tokens import TokenStream
from repro.models import model as JM
from repro.train import optimizer as JO
from repro.train import train_step as JTS

from repro_torch import convert
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.models.params import tree_flatten
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TTS
from torch_lm_params import FAST_COMPILE, reference_params
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

FAMILIES = {"dense": "llama3.2-3b", "moe": "mixtral-8x22b", "mla": "minicpm3-4b",
            "hybrid": "zamba2-7b", "ssm": "xlstm-125m", "encdec": "whisper-tiny",
            "vlm": "internvl2-76b"}
EAGER_DRAWS = ("llama3.2-3b", "zamba2-7b")
B, S, KV_CHUNK = 2, 16, 8
STEP_KW = dict(lr=1e-3, warmup_steps=1, total_steps=3)


def _cfgs(arch, remat="full"):
    return (dataclasses.replace(j_smoke(arch), dtype="float32", remat="none"),
            dataclasses.replace(t_smoke(arch), dtype="float32", remat=remat))


def _batch(cfg, rows=B, seq=S, step=0):
    """The token stream's batch, plus the family's seeded extras."""
    batch = TokenStream(cfg.vocab_size, rows, seq, seed=0).batch_at(step)
    rng = np.random.default_rng(5)
    if cfg.frontend == "vision_stub":
        batch["embeds"] = rng.standard_normal((rows, cfg.frontend_len, cfg.d_model),
                                              dtype=np.float32)
    if cfg.n_enc_layers:
        batch["frames"] = rng.standard_normal((rows, cfg.enc_seq, cfg.d_model),
                                              dtype=np.float32)
    return batch


@pytest.fixture(scope="module")
def reference():
    """arch -> (numpy params, batch, loss, aux, numpy grads) of the
    reference's loss under one jitted ``value_and_grad``."""
    memo = {}

    def get(arch):
        if arch not in memo:
            jc, tc = _cfgs(arch)
            # eager where a later test draws the same shapes eagerly (the
            # steps, the state round trip), else the port's equal draw
            params = (JM.init_params(jc, jax.random.PRNGKey(0)) if arch in EAGER_DRAWS
                      else reference_params(tc))
            batch = _batch(jc)
            loss_fn = JTS.make_loss_fn(jc, JTS.TrainConfig(kv_chunk=KV_CHUNK))
            vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True), compiler_options=FAST_COMPILE)
            (loss, aux), grads = vg(params, {k: jnp.asarray(v) for k, v in batch.items()})
            memo[arch] = (jax.tree.map(np.asarray, params), batch, float(loss),
                          {k: float(v) for k, v in aux.items()},
                          jax.tree.map(np.asarray, grads))
        return memo[arch]
    return get


def _port_grads(arch, params_np, batch, remat="full"):
    _, tc = _cfgs(arch, remat)
    params = convert.lm_params_from_numpy(params_np, tc, "cpu")
    loss_fn = TTS.make_loss_fn(tc, TTS.TrainConfig(kv_chunk=KV_CHUNK))
    return TTS.value_and_grad(loss_fn, params, TTS.device_batch(batch, "cpu"))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_grads_match_reference(family, reference):
    arch = FAMILIES[family]
    params, batch, loss, aux, grads = reference(arch)
    t_loss, t_aux, t_grads = _port_grads(arch, params, batch)
    assert abs(float(t_loss) - loss) <= 1e-5 * abs(loss)
    assert abs(float(t_aux["loss"]) - aux["loss"]) <= 1e-5 * abs(aux["loss"])
    assert float(t_aux["tokens"]) == aux["tokens"] == B * S
    want, got = tree_flatten(grads), tree_flatten(t_grads)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, w), (_, g) in zip(want, got):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, path
        top = np.abs(w).max()
        assert np.abs(g.numpy() - w).max() <= 1e-4 * top, (path, top)
    if family == "vlm":   # the prefix's logits carry no label: the projector learns
        assert np.abs(grads["frontend_proj"]["w"]).max() > 0


@pytest.mark.parametrize("arch", ["llama3.2-3b", "whisper-tiny", "zamba2-7b"])
def test_remat_changes_no_grad(arch, reference):
    params, batch, *_ = reference(arch)
    outs = {r: _port_grads(arch, params, batch, r) for r in ("none", "dots", "full")}
    for r in ("dots", "full"):
        assert float(outs[r][0]) == float(outs["none"][0])
        for (path, a), (_, b) in zip(tree_flatten(outs["none"][2]), tree_flatten(outs[r][2])):
            np.testing.assert_array_equal(b.numpy(), a.numpy(), err_msg=f"{r} {path}")


def _state_close(ref_state, port_state, start):
    """Params after the steps within 0.25 lr and 1e-3 of their RMS move;
    moments within 1e-4 of their RMS change."""
    port = convert.lm_state_to_numpy(port_state)
    ref = jax.tree.map(np.asarray, ref_state)
    assert int(port["step"]) == int(ref["step"])
    assert int(port["opt"]["count"]) == int(ref["opt"]["count"])
    for key, tol_max, tol_rms in (("params", 0.25 * STEP_KW["lr"], 1e-3), ("opt", None, 1e-4)):
        s0 = dict(tree_flatten(start[key]))
        for path, a in tree_flatten(ref[key]):
            if path == ("count",):
                continue
            b = dict(tree_flatten(port[key]))[path]
            d = np.abs(a - b)
            moved = np.sqrt(((a - s0[path]) ** 2).mean())
            if tol_max is not None:
                assert d.max() <= tol_max, (key, path, d.max())
            assert np.sqrt((d ** 2).mean()) <= tol_rms * max(moved, 1e-30), (key, path)


@pytest.mark.parametrize("micro", [1, 2])
def test_steps_match_reference(micro):
    """Three steps of llama3.2-3b (micro 1), or the first step's
    microbatches against the reference's ``lax.scan`` (micro 2, 3 steps as
    well): per-step metrics and the state after."""
    jc, tc = _cfgs("llama3.2-3b")
    jo, to = JO.OptConfig(**STEP_KW), TO.OptConfig(**STEP_KW)
    state = JTS.init_state(jc, jo, jax.random.PRNGKey(0))
    start = jax.tree.map(np.asarray, state)
    step = jax.jit(JTS.make_train_step(jc, jo, JTS.TrainConfig(micro_steps=micro,
                                                               kv_chunk=KV_CHUNK)),
                   compiler_options=FAST_COMPILE)
    t_state = convert.lm_state_from_numpy(start, tc, to, "cpu")
    t_step = TTS.make_train_step(tc, to, TTS.TrainConfig(micro_steps=micro, kv_chunk=KV_CHUNK))
    stream = TokenStream(jc.vocab_size, 4, S, seed=0)
    for i in range(3):
        batch = stream.batch_at(i)
        state, m = step(state, batch)
        out, tm = t_step(t_state, batch)
        assert out is t_state                                # in place
        assert sorted(tm) == sorted(m) == ["grad_norm", "loss", "loss_total", "tokens"]
        assert float(tm["tokens"]) == float(m["tokens"]) == 4 * S / micro
        for k in ("loss", "loss_total", "grad_norm"):
            assert abs(float(tm[k]) - float(m[k])) <= 1e-5 * abs(float(m[k])), (i, k)
    _state_close(state, t_state, start)


def test_micro_step_grads_are_the_sum_from_zero():
    """The micro-steps' grads, added into one tree by autograd (the first
    microbatch's taken as they come), equal the reference's sum from a zero
    tree of each microbatch's grads, bit for bit; bf16 compute, so the
    grads pass the cast back to the float32 leaves."""
    tc = t_smoke("llama3.2-3b")
    to = TO.OptConfig(**STEP_KW)
    params = TTS.init_state(tc, to, torch.tensor([0, 0], dtype=torch.int32), "cpu")["params"]
    loss_fn = TTS.make_loss_fn(tc, TTS.TrainConfig(kv_chunk=KV_CHUNK))
    batch = TTS.device_batch(TokenStream(tc.vocab_size, 4, S, seed=0).batch_at(0), "cpu")
    mbs = TTS._microbatches(batch, 2)
    out, got = TTS._grads_summed(loss_fn, params, mbs)
    want = {path: torch.zeros_like(p) for path, p in tree_flatten(params)}
    for i, mb in enumerate(mbs):
        loss, _, grads = TTS.value_and_grad(loss_fn, params, mb)
        assert float(loss) == float(out[i][0])
        for path, g in tree_flatten(grads):
            want[path].add_(g)
    for path, g in tree_flatten(got):
        assert g.dtype == torch.float32, path
        np.testing.assert_array_equal(g.numpy(), want[path].numpy(), err_msg=str(path))


def test_non_finite_loss_leaves_the_state():
    _, tc = _cfgs("llama3.2-3b")
    to = TO.OptConfig(**STEP_KW)
    state = TTS.init_state(tc, to, torch.tensor([0, 0], dtype=torch.int32), "cpu")
    step = TTS.make_train_step(tc, to, TTS.TrainConfig(kv_chunk=KV_CHUNK))
    batch = TokenStream(tc.vocab_size, 2, S, seed=0).batch_at(0)
    state, _ = step(state, batch)                            # moments non-zero
    state["params"]["final_norm"]["scale"][3] = float("nan")
    before = convert.lm_state_to_numpy(state)
    out, m = step(state, batch)
    assert not np.isfinite(float(m["loss_total"])) and np.isnan(float(m["grad_norm"]))
    after = convert.lm_state_to_numpy(out)
    for (path, a), (_, b) in zip(tree_flatten(before), tree_flatten(after)):
        np.testing.assert_array_equal(b, a, err_msg=str(path))
    assert int(out["step"]) == 1 and int(out["opt"]["count"]) == 1


def test_state_round_trip_and_cast():
    jc, tc = _cfgs("zamba2-7b")
    for name, compress in (("adamw", False), ("adafactor", True)):
        jo = JO.OptConfig(name=name, compress_grads=compress)
        to = TO.OptConfig(name=name, compress_grads=compress)
        want = jax.tree.map(np.asarray, JTS.init_state(jc, jo, jax.random.PRNGKey(0)))
        state = convert.lm_state_from_numpy(want, tc, to, "cpu")
        assert state["step"].dtype == torch.int32 and state["step"].device.type == "cpu"
        back = convert.lm_state_to_numpy(state)
        w, b = tree_flatten(want), tree_flatten(back)
        assert [p for p, _ in w] == [p for p, _ in b]
        for (path, x), (_, y) in zip(w, b):
            assert x.dtype == y.dtype and x.shape == y.shape, path
            np.testing.assert_array_equal(y, x, err_msg=str(path))
        port = TTS.init_state(tc, to, torch.tensor([0, 0], dtype=torch.int32), "cpu")
        for (path, x), (_, y) in zip(w, tree_flatten(convert.lm_state_to_numpy(port))):
            np.testing.assert_array_equal(y, x, err_msg=str(path))
    bad = dict(want, step=np.zeros((), np.float32))
    with pytest.raises(ValueError, match="step"):
        convert.lm_state_from_numpy(bad, tc, to, "cpu")
    with pytest.raises(KeyError, match="leaves differ"):
        convert.lm_state_from_numpy(dict(want, opt={}), tc, to, "cpu")
    bf = TTS.cast_params(state["params"], "bfloat16")
    assert all(t.dtype == torch.bfloat16 for _, t in tree_flatten(bf))
    assert TTS.cast_params(state["params"], "float32") is state["params"]


def test_serve_steps_equal_the_model():
    """``make_serve_steps`` runs the model's prefill and decode on the cast
    weights (the reference's serve steps)."""
    _, tc = _cfgs("llama3.2-3b")
    from repro_torch.models import model as TM
    params = TM.init_params(tc, torch.tensor([0, 0], dtype=torch.int32), "cpu")
    prefill, decode = TTS.make_serve_steps(tc, kv_chunk=KV_CHUNK)
    tok = torch.from_numpy(TokenStream(tc.vocab_size, 2, 8, seed=1).batch_at(0)["tokens"]).long()
    cache = TM.init_cache(tc, 2, 12, torch.float32, "cpu")
    logits, cache = prefill(params, tok, cache)
    full = TM.forward_train(params, tc, tok, kv_chunk=KV_CHUNK)
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(), rtol=0, atol=3e-4)
    step_logits, _ = decode(params, tok[:, 0], 8, cache)
    assert step_logits.shape == (2, tc.vocab_size) and torch.isfinite(step_logits).all()
