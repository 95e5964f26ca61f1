"""The port's training path against the JAX reference at 16 sites, bit for
bit: ``init_train_state``, ``make_train_step`` (three waves, every port
backend), ``make_superbatch_step`` (scan(K) equals K single steps),
``TNNTrainer`` (weights, key, wave, vote table, accuracy and the checkpoint
files), resume (train N, save, restore, train M equals N + M straight, also
from the reference's own checkpoint), and the serve launcher's warm-up chain.

The reference runs with ``impl="direct"`` (bit-exact with its ``"pallas"``
and ``"fused"`` backends, without Pallas interpret mode), once per module:
one trainer whose jitted step also gives the per-wave states and the
launcher's warm-up (the launcher's ``key, k = split(key)`` then
``network_train_wave(x16, params, cfg, k)`` is the train step's chain from
``{"rng": PRNGKey(1)}``, which the reference's own tests hold equal)."""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tnn_mnist as j_tnn_mnist
from repro.core import network as j_network
from repro.data.mnist_like import digits as j_digits
from repro.train.tnn_trainer import TNNTrainer as JTrainer

from repro_torch import convert
from repro_torch import random as t_random
from repro_torch.configs import tnn_mnist as t_tnn_mnist
from repro_torch.core import network as t_network
from repro_torch.launch import serve as t_serve
from repro_torch.train.tnn_trainer import TNNTrainer, WaveStream
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

SITES, B = 16, 16
LEAVES = ("['params']['layer_00']", "['params']['layer_01']", "['rng']",
          "['vote_table']", "['wave']")


def _train_config(mod, ckpt_dir, **kw):
    """Three 16-image waves an epoch, two epochs, a checkpoint every three
    waves, an eval at each epoch end."""
    args = dict(wave_batch=B, train_size=3 * B, eval_size=16, epochs=2,
                ckpt_every=3, ckpt_dir=str(ckpt_dir), log_every=0)
    return mod.train_config(sites=SITES, smoke=True, **dict(args, **kw))


def _np_state(state):
    return {"params": {k: np.array(v) for k, v in state["params"].items()},
            "rng": np.array(state["rng"]), "wave": np.array(state["wave"])}


def _same_state(want, got):
    """A reference state (numpy) against a port state, every leaf exact."""
    g = convert.state_to_numpy(got)
    assert sorted(g["params"]) == sorted(want["params"])
    for k in want["params"]:
        np.testing.assert_array_equal(want["params"][k], g["params"][k])
    np.testing.assert_array_equal(want["rng"], g["rng"])
    assert int(want["wave"]) == int(g["wave"])


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_ckpt")
    jcfg = j_tnn_mnist.launcher_network_config(SITES, impl="direct")
    jt = JTrainer(jcfg, _train_config(j_tnn_mnist, d))
    state = j_network.init_train_state(jax.random.PRNGKey(0), jcfg)
    waves, zs = [_np_state(state)], []
    for w in range(3):
        state, z = jt.step_fn(state, jnp.asarray(jt.stream.batch_at(w)))
        waves.append(_np_state(state))
        zs.append(np.array(z))
    sb = j_network.make_superbatch_step(jcfg)
    st, zk = sb(j_network.init_train_state(jax.random.PRNGKey(0), jcfg),
                jnp.asarray(jt.stream.superbatch_at(0, 3)))
    superbatch = (_np_state(st), np.array(zk))
    # the serve launcher's warm-up: 4 waves on its first 16 labelled images
    lab = j_tnn_mnist.crop_field(j_digits(128, seed=1)[0], SITES)
    x16 = j_network.encode_images(jnp.asarray(lab), jcfg)[:16]
    warm = {"params": j_network.params_to_tree(
                j_network.init_network(jax.random.PRNGKey(0), jcfg)),
            "rng": jax.random.PRNGKey(1), "wave": jnp.asarray(0, jnp.int32)}
    for _ in range(4):
        warm, _ = jt.step_fn(warm, x16)
    summary = jt.run()
    return {"waves": waves, "zs": zs, "superbatch": superbatch,
            "warm": _np_state(warm), "summary": summary,
            "final": _np_state(jt.state), "vote": np.array(jt.vote_table),
            "dir": str(d)}


def _cfg(impl):
    return t_tnn_mnist.launcher_network_config(SITES, impl=impl)


def test_init_train_state_matches_reference(ref):
    st = t_network.init_train_state(t_random.PRNGKey(0), _cfg("direct"), device="cpu")
    assert st["rng"].dtype == torch.uint32 and st["wave"].dtype == torch.int32
    _same_state(ref["waves"][0], st)


@pytest.mark.parametrize("impl", ["direct", "matmul", "pallas", "fused"])
def test_train_step_matches_reference(ref, impl):
    """Three waves of the port's step, each state and z the reference's;
    the weights are updated in place, as the reference donates them."""
    cfg = _cfg(impl)
    st = t_network.init_train_state(t_random.PRNGKey(0), cfg, device="cpu")
    step = t_network.make_train_step(cfg)
    stream = WaveStream(cfg, 3 * B, B, seed=1, device="cpu")
    w0 = st["params"]["layer_00"]
    for w in range(3):
        st, z = step(st, stream.batch_at(w))
        _same_state(ref["waves"][w + 1], st)
        np.testing.assert_array_equal(ref["zs"][w], z.numpy())
    assert st["params"]["layer_00"] is w0


@pytest.mark.parametrize("impl", ["pallas", "fused"])
def test_superbatch_step_matches_reference(ref, impl):
    """scan(3) equals the reference's superbatch and three single steps;
    chunks of 2 + 1 give the same state."""
    cfg = _cfg(impl)
    stream = WaveStream(cfg, 3 * B, B, seed=1, device="cpu")
    sb = t_network.make_superbatch_step(cfg)
    st, zk = sb(t_network.init_train_state(t_random.PRNGKey(0), cfg, device="cpu"),
                stream.superbatch_at(0, 3))
    want, want_zk = ref["superbatch"]
    _same_state(want, st)
    _same_state(ref["waves"][3], st)
    np.testing.assert_array_equal(want_zk, zk.numpy())
    st2 = t_network.init_train_state(t_random.PRNGKey(0), cfg, device="cpu")
    st2, _ = sb(st2, stream.superbatch_at(0, 2))
    st2, _ = sb(st2, stream.superbatch_at(2, 1))
    _same_state(ref["waves"][3], st2)


def _same_run(ref, trainer, ckpt_dir):
    """Final state, vote table, accuracy and every checkpoint file equal the
    reference trainer's."""
    _same_state(ref["final"], trainer.state)
    np.testing.assert_array_equal(ref["vote"], trainer.vote_table.numpy())
    assert trainer.accuracy == ref["summary"]["accuracy"]
    steps = sorted(n for n in os.listdir(ref["dir"]) if n.startswith("step_"))
    assert steps == sorted(n for n in os.listdir(ckpt_dir) if n.startswith("step_"))
    assert steps == ["step_00000003", "step_00000006"]
    for s in steps:
        a, b = os.path.join(ref["dir"], s), os.path.join(ckpt_dir, s)
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))
        ma, mb = (json.load(open(os.path.join(x, "meta.json"))) for x in (a, b))
        assert ma == mb
        assert [l["path"] for l in ma["leaves"]] == list(LEAVES)
        for leaf in ma["leaves"]:
            np.testing.assert_array_equal(np.load(os.path.join(a, leaf["file"])),
                                          np.load(os.path.join(b, leaf["file"])))


@pytest.mark.parametrize("impl,k", [("pallas", 1), ("fused", 2), ("direct", 4)])
def test_trainer_matches_reference(ref, tmp_path, impl, k):
    t = TNNTrainer(_cfg(impl), _train_config(t_tnn_mnist, tmp_path, superbatch_k=k),
                   device="cpu")
    out = t.run()
    assert out["final_wave"] == 6 and not out["resumed"]
    assert out["accuracy"] == ref["summary"]["accuracy"]
    _same_run(ref, t, str(tmp_path))


def test_resume_equals_straight_run(ref, tmp_path):
    """Train 3 waves, save; a new trainer restores and trains 3 more: the
    reference's 6-wave run. A port trainer given only the reference's own
    wave-3 checkpoint resumes to the same state."""
    cfg = _cfg("fused")
    first = TNNTrainer(cfg, _train_config(t_tnn_mnist, tmp_path / "a", epochs=1),
                       device="cpu")
    assert first.run()["final_wave"] == 3
    second = TNNTrainer(cfg, _train_config(t_tnn_mnist, tmp_path / "a"), device="cpu")
    out = second.run()
    assert out["resumed"] and out["final_wave"] == 6
    _same_run(ref, second, str(tmp_path / "a"))
    os.makedirs(tmp_path / "b")
    shutil.copytree(os.path.join(ref["dir"], "step_00000003"),
                    tmp_path / "b" / "step_00000003")
    third = TNNTrainer(_cfg("pallas"), _train_config(t_tnn_mnist, tmp_path / "b"),
                       device="cpu")
    out = third.run()
    assert out["resumed"] and out["final_wave"] == 6
    _same_state(ref["final"], third.state)
    np.testing.assert_array_equal(ref["vote"], third.vote_table.numpy())


def test_serve_launcher_warms_to_the_reference_weights(ref):
    """The port's serve launcher (PRNGKey(0) weights, the split chain from
    PRNGKey(1), 4 waves on 16 images) warms to the reference's weights."""
    rep = t_serve.main(["--sites", str(SITES), "--slots", "4", "--requests", "4",
                        "--train-waves", "4", "--device", "cpu"])
    assert len(rep.warmup_spikes) == 4
    for k, w in zip(sorted(ref["warm"]["params"]), rep.params):
        np.testing.assert_array_equal(ref["warm"]["params"][k], w.numpy())
