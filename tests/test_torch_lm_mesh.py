"""LM sharding on a (data, model) process mesh: the port's DTensor train and
serve steps (``repro_torch.train.train_step`` with ``mesh=``) on 4 gloo
ranks at 2x2 against the JAX package's unmeshed steps, the sharded
checkpoint, ``sharding.pipeline.pipeline_apply`` against the reference's
sequential ``lax.scan``, and the train launcher's ``--mesh 2x2``.

The reference runs here, in the main process, under one ``jax.jit`` per
function; its params (``init_params(PRNGKey(0))``), batches and greedy
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
- prefill and 3 decode ticks of llama (f32 cache): logits within 1e-4 of
  the largest |logit|;
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

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import smoke_config as j_smoke
from repro.data.tokens import TokenStream
from repro.models import model as JM
from repro.train import optimizer as JO
from repro.train import train_step as JTS

import torch_mesh as tm
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.launch import train as t_train
from repro_torch.models.params import tree_flatten
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

def _jcfg(arch):
    """The reference's smoke config as the ranks run it: float32, routing
    groups tiled to the data shards (its dry run's ``_tuned``)."""
    c = dataclasses.replace(j_smoke(arch), dtype="float32")
    return dataclasses.replace(c, moe_groups=2, moe_group_shape=(2, 1))


def _flat(tree):
    return {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm_mesh")
    arrays, out = {}, {}
    jo = JO.OptConfig(**tm.LM_OPT)
    for arch in tm.LM_ARCHS:
        jc = _jcfg(arch)
        state = JTS.init_state(jc, jo, jax.random.PRNGKey(0))
        out[f"{arch}.params0"] = state["params"]
        for k, v in _flat(state["params"]).items():
            arrays[f"{arch}.params.{k}"] = v
        stream = TokenStream(jc.vocab_size, tm.LM_B, tm.LM_S, seed=0)
        batches = [stream.batch_at(i) for i in range(2)]
        for i, b in enumerate(batches):
            arrays[f"{arch}.tokens{i}"], arrays[f"{arch}.labels{i}"] = b["tokens"], b["labels"]
        loss_fn = JTS.make_loss_fn(jc, JTS.TrainConfig(kv_chunk=tm.LM_KV_CHUNK))
        vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        update = jax.jit(lambda g, o, p: JO.opt_update(g, o, p, jo))
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
    # llama: prefill of 12 seeded tokens into a 24-position f32 cache, then
    # 3 greedy decode ticks
    jc = _jcfg("llama3.2-3b")
    params = out.pop("llama3.2-3b.params0")
    out.pop("mixtral-8x22b.params0")
    tokens = np.random.default_rng(3).integers(0, jc.vocab_size, (tm.LM_B, 12)).astype(np.int32)
    arrays["serve.tokens"] = tokens
    prefill, decode = JTS.make_serve_steps(jc, kv_chunk=tm.LM_KV_CHUNK)
    cache = JM.init_cache(jc, tm.LM_B, tm.LM_CACHE, jnp.float32)
    lg, cache = jax.jit(prefill)(params, jnp.asarray(tokens), cache)
    logits, dec = [np.asarray(lg)], jax.jit(decode)
    for t in range(3):
        nxt = np.asarray(jnp.argmax(logits[-1], axis=-1)).astype(np.int32)
        arrays[f"serve.next{t}"] = nxt
        lg, cache = dec(params, jnp.asarray(nxt), jnp.int32(12 + t), cache)
        logits.append(np.asarray(lg))
    out["serve"] = np.stack(logits)
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


def test_meshed_prefill_and_decode_match_the_reference(ref, ranks):
    got, want = ranks["serve"]["logits"], ref["serve"]
    assert got.shape == want.shape == (4, tm.LM_B, 256)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()


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
