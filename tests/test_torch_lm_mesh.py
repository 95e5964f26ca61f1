"""LM sharding on a (data, model) process mesh: the port's DTensor train and
serve steps (``repro_torch.train.train_step`` with ``mesh=``) on 4 gloo
ranks at 2x2 against the JAX package's unmeshed steps: train steps, the
AdamW update on the reference's own inputs, prefill and decode for one arch
of every family (the dense and MoE decoders, MLA, the SSM, the hybrid with
its shared attention and unstacked tail, the encoder-decoder with seeded
``frames`` and the VLM prefix with seeded ``embeds``); the collective
probe's serve cells on the inputs the reference's specs declare; the
sharded checkpoint, ``sharding.pipeline.pipeline_apply`` against the
reference's sequential ``lax.scan``, and the train launcher's ``--mesh
2x2``.

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
  max |grad|; after two AdamW steps (lr 1e-3) every param within 0.25 lr,
  and each leaf within 1e-3 of the RMS distance it moved over its
  *determined* elements (``optimizer.adamw_determined``, one rule for every
  family): those where the reference's bias-corrected ``sqrt(v / (1 -
  b2^count))`` is at least 10 eps (1e-7) after step 1 and after step 2.
  Below that AdamW's denominator is eps, its update is linear in the grad
  with a gain of lr / eps, and a grad that is zero in exact arithmetic (or
  below eps) moves its param by rounding: zamba2-7b's one norm-scale
  element whose step-1 grad is -4.4e-9, xlstm-125m's sLSTM input-gate
  biases. Only the reference's state chooses the elements set aside; the
  test prints how many and their largest move from the reference, in lr;
- the AdamW update alone, on the mesh, fed the reference's params and state
  after its step 1 and its step-2 grads (taken at those params, scaled by
  its clip scale): params, m and v equal to the reference's step 2 on
  every element, the eps-level ones too, within 2 float32 ulps of each
  rounded op's operands (a result that cancels its operands is held to
  their ulps), and within 2 ulps of the same update in one process (the
  unmeshed optimizer's tolerance, ``tests/test_torch_lm_optimizer.py``);
  with the grad hold this covers each part of the meshed step on the
  elements the RMS hold sets aside;
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
sums in another order); smoke zamba2-7b trains 1 step under ``--mesh 2x2``,
its checkpoint the state it holds. The collectives that ranks sharing a card use
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
from repro_torch.train import optimizer as T_OPT
from test_torch_lm_optimizer import ulps
from torch_lm_params import FAST_COMPILE, reference_state
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
        for i, b in enumerate(batches):   # the reference's step: value_and_grad, opt_update
            (loss, aux), grads = vg(state["params"], {k: jnp.asarray(v) for k, v in b.items()})
            first = first or (float(loss), _flat(grads))
            if i == 1:    # the optimizer's inputs at step 2, for the ranks' update alone
                step2 = {what: _flat(tree) for what, tree in (
                    ("p1", state["params"]), ("m1", state["opt"]["m"]),
                    ("v1", state["opt"]["v"]), ("g2", grads))}
                for what, flat in step2.items():
                    arrays.update({f"{arch}.{what}.{k}": v for k, v in flat.items()})
            params, opt, gnorm = update(grads, state["opt"], state["params"])
            state = {"params": params, "opt": opt, "step": state["step"] + 1}
            metrics.append({"loss": float(aux["loss"]), "loss_total": float(loss),
                            "grad_norm": float(gnorm)})
        # the reference's clip scale at step 2, as its clip_by_global_norm
        norm = np.float32(metrics[1]["grad_norm"])
        step2["scale"] = np.minimum(np.float32(1.0), np.float32(jo.clip_norm)
                                    / np.maximum(norm, np.float32(1e-9)))
        arrays[f"{arch}.scale2"] = step2["scale"]
        out[arch] = {"loss": first[0], "grads": first[1], "metrics": metrics,
                     "p0": p0, "step2": step2, "state": jax.tree.map(np.asarray, state)}
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
    for arch in tm.LM_ARCHS:
        out[f"{arch}.serve"] = _serve_reference(arch, out.pop(f"{arch}.params0"), arrays)
    np.savez(d / "ref.npz", **arrays)
    out["dir"] = d
    return out


@pytest.fixture(scope="module")
def ranks(ref):
    return tm.spawn(ref["dir"] / "ranks", tm.lm_suite, str(ref["dir"] / "ref.npz"),
                    str(ref["dir"]))[0]


def _close_params(got, want, p0, vs, lr):
    """Every param within 0.25 lr of the reference's; each leaf's RMS
    difference within 1e-3 of its RMS move over the elements the
    reference's second moments ``vs`` (after steps 1 and 2) determine.
    Returns (elements set aside, their largest |difference| in lr)."""
    cfg = T_OPT.OptConfig(**tm.LM_OPT)
    aside, aside_max = 0, 0.0
    for k, w in want.items():
        g, moved = got[k], w - p0[k]
        assert np.abs(g - w).max() <= 0.25 * lr, k
        det = T_OPT.adamw_determined([torch.from_numpy(v[k]) for v in vs], (1, 2), cfg).numpy()
        if not det.all():
            aside += int((~det).sum())
            aside_max = max(aside_max, float(np.abs(g - w)[~det].max()) / lr)
        if not det.any():
            continue
        rms = np.sqrt(np.mean(moved[det].astype(np.float64) ** 2))
        diff = (g - w)[det].astype(np.float64)
        assert np.sqrt(np.mean(diff ** 2)) <= 1e-3 * rms + 1e-12, k
    return aside, aside_max


def _flat_port(tree):
    return {"/".join(str(k) for k in p): v for p, v in tree_flatten(tree)}


@pytest.mark.parametrize("arch", tm.LM_ARCHS)
def test_meshed_train_steps_match_the_reference(ref, ranks, arch, record_property):
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
    aside, aside_max = _close_params(
        _flat_port(state["params"]), _flat(want["state"]["params"]), want["p0"],
        (want["step2"]["v1"], _flat(want["state"]["opt"]["v"])), tm.LM_OPT["lr"])
    print(f"{arch}: {aside} element(s) set aside by adamw_determined, their largest "
          f"|difference| {aside_max:.3g} lr")
    record_property("set_aside", aside)
    record_property("set_aside_max_lr", aside_max)
    if arch == "llama3.2-3b":
        assert got["adafactor"] <= 1e-5


def _ulp(x):
    """The float32 spacing at |x| (float64)."""
    return np.spacing(np.abs(x).astype(np.float32)).astype(np.float64)


# XLA's CPU flushes float32 denormals to zero, in and out: each of an AdamW
# moment's two terms may lose up to the smallest normal float32
FLUSHED = 2 * float(np.finfo(np.float32).tiny)


def _operand_ulps(got, want, operands, chain=None):
    """The largest ``|got - want|`` over its tolerance, per element: 2
    float32 ulps of the largest |value| among the last rounded op's
    ``operands`` and ``want`` (so a result that cancels its operands is
    held to their ulps, not its own), 2 more ulps of ``chain`` (an operand
    that is itself the end of a chain of rounded ops), and FLUSHED."""
    big = np.maximum.reduce([np.abs(want.astype(np.float64))]
                            + [np.abs(o) for o in operands])
    tol = 2 * _ulp(big) + FLUSHED + (2 * _ulp(chain) if chain is not None else 0.0)
    return float((np.abs(got.astype(np.float64) - want) / tol).max())


@pytest.mark.parametrize("arch", tm.LM_ARCHS)
def test_meshed_adamw_matches_the_reference_on_its_inputs(ref, ranks, arch, record_property):
    """``opt_update`` on the 2x2 mesh (DTensors placed by
    ``state_shardings``), fed the reference's params and AdamW state after
    its step 1 and its step-2 grads scaled by its step-2 clip scale (the
    update's own clip off): params, m and v equal the reference's step 2 on
    every element, the ones whose second moment is eps-level included,
    within 2 float32 ulps of each rounded op's operands (:func:`_operand_ulps`;
    where the step cancels a value, ``|m2| << |m1|``, one ulp of an operand
    is thousands of the result's): m of ``b1 m1`` and ``(1 - b1) g``, v of
    ``b2 v1`` and ``(1 - b2) g^2``, params of ``p1`` and the update ``u = p1
    - p2``, which is the end of AdamW's chain of float32 ops (``m / c1``,
    ``v / c2``, the root, ``+ eps``, the quotient, ``+ wd p``, ``* lr``), so
    2 ulps of ``u`` more. The same update in one process on the same inputs
    within 2 ulps of the meshed one (the unmeshed optimizer's tolerance,
    ``test_torch_lm_optimizer.py``); the meshed norm of the raw grads equal
    to one process's and within 1e-6 relative of the reference's (that
    test's norm tolerance)."""
    want, got = ref[arch], ranks["opt_forced"][arch]
    mesh, one = got["mesh"], got["one"]
    assert int(mesh["count"]) == int(one["count"]) == 2
    assert mesh["grad_norm"] == one["grad_norm"]
    ref_norm = want["metrics"][1]["grad_norm"]
    assert abs(mesh["grad_norm"] - ref_norm) <= 1e-6 * ref_norm
    inp, jo = want["step2"], JO.OptConfig(**tm.LM_OPT)
    b1, b2 = jo.b1, jo.b2
    worst = {}
    for what, tree in (("params", want["state"]["params"]), ("m", want["state"]["opt"]["m"]),
                       ("v", want["state"]["opt"]["v"])):
        a, b, w = _flat_port(mesh[what]), _flat_port(one[what]), _flat(tree)
        assert sorted(a) == sorted(b) == sorted(w)
        worst[what] = 0.0
        for k in w:
            assert a[k].shape == b[k].shape == w[k].shape
            assert ulps(a[k], b[k]) <= 2, (what, k, ulps(a[k], b[k]))
            g = (inp["g2"][k] * inp["scale"]).astype(np.float64)
            if what == "m":
                r = _operand_ulps(a[k], w[k], (b1 * inp["m1"][k].astype(np.float64),
                                               (1 - b1) * g))
            elif what == "v":
                r = _operand_ulps(a[k], w[k], (b2 * inp["v1"][k].astype(np.float64),
                                               (1 - b2) * g * g))
            else:
                p1 = inp["p1"][k].astype(np.float64)
                r = _operand_ulps(a[k], w[k], (p1, p1 - w[k]), chain=p1 - w[k])
            assert r <= 1.0, (what, k, r)
            worst[what] = max(worst[what], r)
    print(f"{arch}: the meshed update on the reference's inputs, largest difference from the "
          f"reference's step 2 over its tolerance: {worst}")
    record_property("of_tolerance", worst)


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


def test_mamba_conv_on_dtensors_pads_each_ranks_block(ranks):
    """The Mamba2 causal conv on DTensors (``ssm._causal_conv``: rows over
    the data axis, channels over the model axis) equals the conv on the
    whole tensors, forward and every input's grad, within 1e-6 of each
    one's largest value, and hands no pad op a DTensor: DTensor's
    redistribution fails on ``F.pad`` in torch 2.11 (the card's; ROADMAP
    Queue 3 item 14), so ``ssm.pad_seq`` pads each rank's block."""
    got = dict(ranks["mamba_conv"])
    assert got.pop("pad_saw_dtensor") is False
    assert sorted(got) == ["grad0", "grad1", "grad2", "y"]
    for k, err in got.items():
        assert err <= 1e-6, k


def test_mla_value_pad_on_dtensors_pads_each_ranks_block(ranks):
    """``partition.pad_blocks``, which pads MLA's V head dim up to the q/k
    head dim in ``layers.mla_prefill``, equals ``F.pad`` of the whole tensor
    exactly, forward and grad, with the heads or the padded dim itself over
    the model axis, and hands no pad op a DTensor: torch 2.11 (the card's)
    fails ``F.pad`` of a DTensor, which minicpm3-4b's full-width meshed
    steps met over NCCL (ROADMAP Queue 3 item 14)."""
    got = dict(ranks["pad_blocks"])
    assert got.pop("pad_saw_dtensor") is False
    assert got == {"heads": [0.0, 0.0], "padded_dim": [0.0, 0.0]}


def test_slstm_serve_scan_on_dtensors_runs_each_ranks_rows(ranks):
    """``ssm._slstm_rows`` (the serve steps' sLSTM prefill and decode tick)
    on DTensors equals the scan on the whole tensors within 1e-6 of each
    output's largest value, and the cell sees no DTensor: torch 2.11 fails
    a step's sum of the input term and the recurrent term's partial sum,
    which xlstm-125m's full-width 2x2 prefill met over NCCL (ROADMAP Queue
    3 item 14)."""
    got = dict(ranks["slstm_rows"])
    assert got.pop("cell_saw_dtensor") is False
    assert sorted(got) == [1, 5]
    for S, errs in got.items():
        assert len(errs) == 5 and max(errs) <= 1e-6, (S, errs)


@pytest.mark.parametrize("arch", tm.LM_ARCHS)
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


def test_launcher_mesh_trains_the_hybrid(ref, ranks):
    """``launch.train --arch zamba2-7b --smoke --mesh 2x2`` trains: it ends
    at step 1 with a checkpoint equal to the state it holds."""
    d = ref["dir"] / "lm_launch_hybrid"
    got = ranks["launch_hybrid"]
    assert got["step"] == 1 and Checkpointer(str(d)).all_steps() == [1]
    assert [json.loads(l)["step"] for l in open(d / "metrics.jsonl")] == [1]
    restored, _ = Checkpointer(str(d)).restore(1, got["state"])
    for (p, a), (_, b) in zip(tree_flatten(restored), tree_flatten(got["state"])):
        np.testing.assert_array_equal(a, b, err_msg=str(p))


def test_gloo_cuda_collectives_equal_gloos(ranks):
    """The collectives ``sharding.gloo_cuda`` registers for ranks sharing a
    card (gloo on CUDA tensors), here for the CPU key: DTensor's
    all-gather, shard-to-shard, reduce-scatter and all-reduce equal gloo's
    own, bit for bit."""
    assert ranks["gloo_cuda_equal"]
