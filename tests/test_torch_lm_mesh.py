"""LM sharding on a (data, model) process mesh: the port's DTensor train and
serve steps (``repro_torch.train.train_step`` with ``mesh=``) on 4 gloo
ranks at 2x2 against the JAX package's unmeshed steps: train steps for one
arch of every family but the hybrid (the dense and MoE decoders, MLA, the
SSM, the encoder-decoder with seeded ``frames`` and the VLM prefix with
seeded ``embeds``; zamba2-7b's meshed training is refused, ROADMAP Queue 3
item 16), prefill and decode for one arch of every family, the hybrid
included; the collective probe's serve cells on the inputs the reference's
specs declare; the sharded checkpoint, ``sharding.pipeline.pipeline_apply``
against the reference's sequential ``lax.scan``, and the train launcher's
``--mesh 2x2``.

The reference runs here, in the main process, under one ``jax.jit`` per
function (compiled at ``torch_lm_params.FAST_COMPILE``); its params
(``init_params(PRNGKey(0))``, drawn by the port,
``tests/torch_lm_params.py``), batches, prompts, extras and greedy
tokens cross to the ranks as an ``.npz`` (``tests/torch_mesh.py``'s
``lm_suite`` is the rank body, one start of the 4 ranks). The configs are
the smoke configs in float32 with ``moe_groups`` tiled to the 2 data shards
(the launcher's ``tuned_config``, the reference's ``_tuned``), the same on
both sides. Meshed results are not bit-equal to one process (the tensor-
parallel splits and the data-axis grad sums change the order of the sums),
so they are held to tolerances:

- loss within 1e-5 relative; every leaf's grads within 1e-4 of that leaf's
  max |grad|; after two AdamW steps (lr 1e-3) params within 0.25 lr and
  within 1e-3 of the RMS distance they moved, PR 21's tolerances;
- a prefill of 13 tokens (mixtral-8x22b's 18, past its sliding window of
  16, so the ring buffer rolls and wraps sharded; internvl2-76b's after 8
  prefix embeds; whisper-tiny's with 16 frames) into a 24-position f32
  cache and 3 decode ticks fed the reference's greedy tokens, for
  llama3.2-3b, mixtral-8x22b, minicpm3-4b, xlstm-125m, zamba2-7b,
  whisper-tiny and internvl2-76b: every tick's logits within 1e-4 of the
  largest |logit|, and after the last tick every cache leaf (K/V, MLA's
  latent, the mLSTM/sLSTM/Mamba states, the conv window, the cross K/V,
  zamba2's unstacked tail), gathered, within 1e-4 of its largest |value|;
- the probe's ``prefill_32k`` cell of whisper-tiny and internvl2-76b
  (``collective_probe.serve_inputs``: frames, or prefix embeds and a cache
  of S + frontend_len, shaped as the reference's ``launch.specs``): logits
  equal to the meshed serve's prefill on the same inputs, and within 1e-4
  of the reference's largest |logit|;
- one Adafactor step with int8 compression on the sharded state: every
  leaf within 1e-5 of its largest value of the same step unmeshed;
- ``pipeline_apply`` over 4 stages (R = 8, B = 16, D = 32, 4 microbatches,
  the reference's own case): forward within 2e-5 of the reference's
  sequential ``lax.scan`` (and equal to the layers run in order in the
  rank); grads within 2e-5 of the layers run in order in the rank, and
  within the reference's own pipeline test's grad tolerances (rtol 5e-4,
  atol 5e-5) of its ``lax.scan``'s.

A checkpoint of the sharded state restores bit-equal, in one port process
and in the reference's ``Checkpointer``, to the gathered state; each rank's
sharded restore is bit-equal to its blocks. The launcher (smoke llama, bf16)
trains 1 step under ``--mesh 2x2``, is started again with ``--steps 2``,
resumes at step 1 and ends at 2, its last checkpoint the state it holds;
its losses are within 1e-2 relative of a one-process run's (bf16 compute,
sums in another order). The collectives that ranks sharing a card use
(``sharding.gloo_cuda``) equal gloo's own on the CPU, bit for bit.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import smoke_config as j_smoke
from repro.configs.base import cell_by_name as j_cell_by_name
from repro.data.tokens import TokenStream
from repro.launch import specs as j_specs
from repro.models import model as JM
from repro.train import optimizer as JO
from repro.train import train_step as JTS

import torch_mesh as tm
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import cell_by_name
from repro_torch.launch import collective_probe as t_probe
from repro_torch import random as t_random
from repro_torch.launch import train as t_train
from repro_torch.models import model as TM
from repro_torch.models.params import tree_flatten
from torch_lm_params import FAST_COMPILE, reference_params, reference_state
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

def _jcfg(arch):
    """The reference's smoke config as the ranks run it: float32, routing
    groups tiled to the data shards (its dry run's ``_tuned``)."""
    c = dataclasses.replace(j_smoke(arch), dtype="float32")
    return dataclasses.replace(c, moe_groups=2, moe_group_shape=(2, 1))


def _flat(tree):
    return {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _serve_reference(arch, params, arrays):
    """The reference's unmeshed, jitted ``make_serve_steps`` (f32 cache):
    the prompt's prefill and tm.LM_TICKS greedy ticks, the inputs and
    greedy tokens added to ``arrays`` for the ranks; every tick's logits
    and the cache's leaves after the last. For the probe's archs also the
    prefill of the probe's cell (``collective_probe.serve_inputs``, the
    port's, on the CPU), its inputs' shapes held to the reference's specs."""
    jc = _jcfg(arch)
    S = tm.LM_PROMPT.get(arch, 13)
    tokens = np.random.default_rng(3).integers(0, jc.vocab_size, (tm.LM_B, S)).astype(np.int32)
    extras = tm.lm_extras(jc, tm.LM_B)
    arrays[f"{arch}.serve.tokens"] = tokens
    arrays.update({f"{arch}.serve.{k}": v for k, v in extras.items()})
    prefill, decode = (jax.jit(f, compiler_options=FAST_COMPILE)
                       for f in JTS.make_serve_steps(jc, kv_chunk=tm.LM_KV_CHUNK))
    cache = JM.init_cache(jc, tm.LM_B, tm.LM_CACHE, jnp.float32)
    lg, cache = prefill(params, jnp.asarray(tokens), cache,
                        **{k: jnp.asarray(v) for k, v in extras.items()})
    pos = S + (jc.frontend_len if "embeds" in extras else 0)
    logits = [np.asarray(lg)]
    for t in range(tm.LM_TICKS):
        nxt = np.asarray(jnp.argmax(logits[-1], axis=-1)).astype(np.int32)
        arrays[f"{arch}.serve.next{t}"] = nxt
        lg, cache = decode(params, jnp.asarray(nxt), jnp.int32(pos + t), cache)
        logits.append(np.asarray(lg))
    out = {"logits": np.stack(logits), "cache": [np.asarray(a) for a in jax.tree.leaves(cache)]}
    if arch in tm.PROBE_ARCHS:
        cell = cell_by_name("prefill_32k")
        inputs = t_probe.serve_inputs(tm.lm_cfg(arch, {"data": 2, "model": 2}), cell,
                                      tm.LM_B, tm.PROBE_S, "cpu")
        spec = j_specs.prefill_specs(jc, dataclasses.replace(
            j_cell_by_name("prefill_32k"), global_batch=tm.LM_B, seq_len=tm.PROBE_S))
        got = {k: tuple(v.shape) for k, v in inputs.items() if k != "cache"}
        assert got == {k: tuple(v.shape) for k, v in spec.items() if k != "cache"}
        assert [tuple(c.shape) for _, c in tree_flatten(inputs["cache"])] == [
            tuple(c.shape) for c in jax.tree.leaves(spec["cache"])]
        cache = jax.tree.map(lambda c: jnp.asarray(c.float().numpy(), jnp.bfloat16),
                             inputs.pop("cache"))
        lg, _ = prefill(params, cache=cache, **{k: jnp.asarray(v.numpy()) for k, v in
                                                inputs.items()})
        out["probe"] = np.asarray(lg)
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm_mesh")
    arrays, out = {}, {}
    jo = JO.OptConfig(**tm.LM_OPT)
    for arch in tm.LM_ARCHS:
        jc = _jcfg(arch)
        state = reference_state(tm.lm_cfg(arch, {"data": 2, "model": 2}), jo)
        out[f"{arch}.params0"] = state["params"]
        for k, v in _flat(state["params"]).items():
            arrays[f"{arch}.params.{k}"] = v
        stream = TokenStream(jc.vocab_size, tm.LM_B, tm.LM_S, seed=0)
        batches = [dict(stream.batch_at(i), **tm.lm_extras(jc, tm.LM_B)) for i in range(2)]
        for i, b in enumerate(batches):
            arrays.update({f"{arch}.b{i}.{k}": v for k, v in b.items()})
        loss_fn = JTS.make_loss_fn(jc, JTS.TrainConfig(kv_chunk=tm.LM_KV_CHUNK))
        vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True), compiler_options=FAST_COMPILE)
        update = jax.jit(lambda g, o, p: JO.opt_update(g, o, p, jo),
                         compiler_options=FAST_COMPILE)
        p0, metrics, first = _flat(state["params"]), [], None
        for b in batches:   # the reference's train step: value_and_grad, opt_update
            (loss, aux), grads = vg(state["params"], {k: jnp.asarray(v) for k, v in b.items()})
            first = first or (float(loss), _flat(grads))
            params, opt, gnorm = update(grads, state["opt"], state["params"])
            state = {"params": params, "opt": opt, "step": state["step"] + 1}
            metrics.append({"loss": float(aux["loss"]), "loss_total": float(loss),
                            "grad_norm": float(gnorm)})
        out[arch] = {"loss": first[0], "grads": first[1], "metrics": metrics,
                     "p0": p0, "state": jax.tree.map(np.asarray, state)}
    # the reference's pipeline case, sequentially
    R, B, D = tm.PIPE["R"], tm.PIPE["B"], tm.PIPE["D"]
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    pp = {"w": 0.3 * jax.random.normal(k1, (R, D, D)), "b": 0.01 * jax.random.normal(k2, (R, D))}
    x = jax.random.normal(jax.random.PRNGKey(1), (B, D))

    def seq(p, x):
        def body(c, pr):
            return jnp.tanh(c @ pr["w"] + pr["b"]), None
        return jax.lax.scan(body, x, p)[0]

    out["pipe"] = (np.asarray(seq(pp, x)),
                   jax.tree.map(np.asarray, jax.grad(lambda p: jnp.sum(seq(p, x) ** 2))(pp)))
    arrays.update({"pipe.w": np.asarray(pp["w"]), "pipe.b": np.asarray(pp["b"]),
                   "pipe.x": np.asarray(x)})
    # every family: a prefill of the prompt (with its extras), 3 greedy ticks
    for arch in tm.LM_SERVE_ARCHS:
        params = out.pop(f"{arch}.params0", None)
        if params is None:    # zamba2-7b has no meshed train hold
            params = reference_params(tm.lm_cfg(arch, {"data": 2, "model": 2}))
            arrays.update({f"{arch}.params.{k}": v for k, v in _flat(params).items()})
        out[f"{arch}.serve"] = _serve_reference(arch, params, arrays)
    np.savez(d / "ref.npz", **arrays)
    out["dir"] = d
    return out


@pytest.fixture(scope="module")
def ranks(ref):
    return tm.spawn(ref["dir"] / "ranks", tm.lm_suite, str(ref["dir"] / "ref.npz"),
                    str(ref["dir"]))[0]


def _close_params(got, want, p0, lr):
    for k, w in want.items():
        g, moved = got[k], w - p0[k]
        assert np.abs(g - w).max() <= 0.25 * lr, k
        rms = np.sqrt(np.mean(moved.astype(np.float64) ** 2))
        assert np.sqrt(np.mean((g - w).astype(np.float64) ** 2)) <= 1e-3 * rms + 1e-12, k


def _flat_port(tree):
    return {"/".join(str(k) for k in p): v for p, v in tree_flatten(tree)}


@pytest.mark.parametrize("arch", tm.LM_ARCHS)
def test_meshed_train_steps_match_the_reference(ref, ranks, arch):
    want, got = ref[arch], ranks[arch]
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    grads = _flat_port(got["grads"])
    assert sorted(grads) == sorted(want["grads"])
    for k, w in want["grads"].items():
        assert np.abs(grads[k] - w).max() <= 1e-4 * np.abs(w).max(), k
    for g, w in zip(got["metrics"], want["metrics"]):
        for key in ("loss", "loss_total", "grad_norm"):
            assert abs(g[key] - w[key]) <= 1e-5 * abs(w[key]), key
    state = got["state"]
    assert int(state["step"]) == 2 and int(state["opt"]["count"]) == 2
    _close_params(_flat_port(state["params"]), _flat(want["state"]["params"]), want["p0"],
                  tm.LM_OPT["lr"])
    if arch == "llama3.2-3b":
        assert got["adafactor"] <= 1e-5


def test_lrnn_rows_matches_chunked_lrnn(ranks):
    """The meshed SSM recurrence (``ssm.lrnn_rows``: each rank's rows as
    plain tensors) equals the recurrence on the whole rows, forward and
    every input's grad, within 1e-6 of each one's largest value."""
    got = ranks["lrnn_rows"]
    assert sorted(got) == ["grad0", "grad1", "grad2", "grad3", "grad4", "h", "y"]
    for k, err in got.items():
        assert err <= 1e-6, k


def test_lrnn_decode_step_on_dtensors_matches_the_whole(ranks):
    """The meshed recurrence step (``ssm.lrnn_decode_step`` on each rank's
    rows, the Mamba2 decode's placements) equals the step on the whole
    tensors within 1e-6 of each output's largest value."""
    got = ranks["lrnn_decode"]
    assert sorted(got) == ["h", "y"]
    for k, err in got.items():
        assert err <= 1e-6, k


@pytest.mark.parametrize("arch", tm.LM_SERVE_ARCHS)
def test_meshed_prefill_and_decode_match_the_reference(ref, ranks, arch):
    """Every tick's logits within 1e-4 of the largest |logit|; after the last
    tick every cache leaf, gathered, within 1e-4 of its largest |value|."""
    got, want = ranks["serve"][arch], ref[f"{arch}.serve"]
    assert got["logits"].shape == want["logits"].shape == (1 + tm.LM_TICKS, tm.LM_B, 256)
    for g, w in zip(got["logits"], want["logits"]):
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
    leaves = tree_flatten(got["cache"])
    assert len(leaves) == len(want["cache"])
    for (path, g), w in zip(leaves, want["cache"]):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), path


@pytest.mark.parametrize("arch", tm.PROBE_ARCHS)
def test_probe_serve_cell_takes_the_references_inputs(ref, ranks, arch):
    """The collective probe's prefill cell at 2x2 runs on the inputs the
    reference's specs declare (held in the ``ref`` fixture: whisper's
    frames, internvl2's prefix embeds and its S + frontend_len cache): its
    logits equal the meshed serve's prefill on the same inputs and lie
    within 1e-4 of the reference's largest |logit|."""
    got, want = ranks["probe"][arch], ref[f"{arch}.serve"]["probe"]
    np.testing.assert_array_equal(got["probe"], got["serve"])
    assert got["probe"].shape == want.shape == (tm.LM_B, 256)
    assert np.abs(got["probe"] - want).max() <= 1e-4 * np.abs(want).max()


class _OpsSeen(TorchDispatchMode):
    """Records the aten ops dispatched under it."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.add(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("S", [17, 18, 31, 32, 33, 40])
def test_ring_window_is_the_references_roll(S):
    """The sliding-window prefill's ring layout (``model._ring_window``)
    equals the reference's ``jnp.roll`` of the last window positions bit for
    bit, and dispatches no ``aten.roll``, for which DTensor has no rule in torch
    2.11 (the card's; ROADMAP Queue 3 item 14)."""
    Sc = 16
    x = np.random.default_rng(S).standard_normal((2, S, 3, 4)).astype(np.float32)
    with _OpsSeen() as ops:
        got = TM._ring_window(torch.from_numpy(x), Sc)
    want = jnp.roll(jnp.asarray(x)[:, S - Sc:], shift=S % Sc, axis=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert "roll" not in ops.seen


def test_mamba_prefill_from_a_full_conv_window_dispatches_no_pad():
    """The Mamba2 prefill from the cache's conv window (K - 1 positions)
    pads nothing and dispatches no pad op, which fails DTensor's
    redistribution in torch 2.11 (ROADMAP Queue 3 item 14)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import ssm

    cfg = smoke_config("zamba2-7b")
    p = TM.init_params(cfg, t_random.PRNGKey(0), "cpu")["tail"]["0_mamba"]["mamba"]
    h0, conv = TM.init_cache(cfg, 2, 8, torch.float32, "cpu")["tail"]["0_mamba"]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 5, cfg.d_model),
                                                                  dtype=np.float32))
    with _OpsSeen() as ops:
        ssm._mamba_run(x, p, cfg, h0=h0, conv_state=conv, chunk=4)
    assert not ops.seen & {"pad", "constant_pad_nd"}


def test_meshed_checkpoint_restores_bit_equal(ref, ranks):
    got = ranks["llama3.2-3b"]
    assert got["restored_blocks_equal"] and got["restored_extra"] == {"data_step": 2}
    d = str(ref["dir"] / "lm_ckpt")
    one, extra = Checkpointer(d).restore(2, got["state"])
    assert extra == {"data_step": 2}
    for (p, a), (_, b) in zip(tree_flatten(one), tree_flatten(got["state"])):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    jc = _jcfg("llama3.2-3b")
    jtree, _ = JCheckpointer(d).restore(2, JTS.abstract_state(jc, JO.OptConfig(**tm.LM_OPT)))
    flat = _flat_port(got["state"])
    for k, v in _flat(jtree).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)


def test_pipeline_matches_the_sequential_layers(ref, ranks):
    """Forward within 2e-5 of the reference's ``lax.scan``; grads within 2e-5
    of the same layers run one after another in the rank's process (the
    microbatches sum the grads in another order), and within the
    reference's own pipeline tolerances (rtol 5e-4, atol 5e-5,
    ``tests/test_pipeline.py``) of its ``lax.scan``'s grads, which sum in
    another framework's order (measured 1.0e-4 at most, on grads of
    sum(out^2))."""
    out, grads = ref["pipe"]
    got = ranks["pipeline"]
    per = tm.PIPE["R"] // 4          # rank 0 holds layers 0 and 1
    np.testing.assert_array_equal(got["out"], got["seq_out"])
    np.testing.assert_allclose(got["out"], out, rtol=2e-5, atol=2e-5)
    for k in ("w", "b"):
        np.testing.assert_allclose(got["grads"][k], got["seq_grads"][k], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got["grads"][k], grads[k][:per], rtol=5e-4, atol=5e-5)


def test_launcher_mesh_trains_and_resumes(ref, ranks, tmp_path, monkeypatch):
    d = ref["dir"] / "lm_launch"
    assert ranks["launch"]["step"] == 2
    assert Checkpointer(str(d)).all_steps() == [1, 2]
    lines = [json.loads(l) for l in open(d / "metrics.jsonl")]
    assert [l["step"] for l in lines] == [1, 2]
    one = t_train.main(["--arch", "llama3.2-3b", "--smoke", "--batch", "4", "--seq", "16",
                        "--steps", "2", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert one["final_step"] == 2
    want = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    for a, b in zip(lines, want):
        assert abs(a["loss"] - b["loss"]) <= 1e-2 * abs(b["loss"])
    restored, _ = Checkpointer(str(d)).restore(2, ranks["launch"]["state"])
    for (p, a), (_, b) in zip(tree_flatten(restored), tree_flatten(ranks["launch"]["state"])):
        np.testing.assert_array_equal(a, b, err_msg=str(p))


def test_gloo_cuda_collectives_equal_gloos(ranks):
    """The collectives ``sharding.gloo_cuda`` registers for ranks sharing a
    card (gloo on CUDA tensors), here for the CPU key: DTensor's
    all-gather, shard-to-shard, reduce-scatter and all-reduce equal gloo's
    own, bit for bit."""
    assert ranks["gloo_cuda_equal"]
