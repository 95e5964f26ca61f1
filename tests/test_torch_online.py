"""Learning while serving on the port against the JAX reference, bit for bit,
at 4 sites and 4 slots: the online shadow state equals the reference
trainer's on the same volley stream (every port backend); the K-wave online
drain equals lock-step and the reference engine (K = 3, 11 requests, the last
wave partial); under automatic hot swaps (``swap_every=2``) every uid's class
id and version, every published vote table and every swap checkpoint file
equal the reference engine's, and the checkpoints restore in both packages;
``from_checkpoint(online_stdp=True)`` continues a JAX-written checkpoint's
stream; the guardrails; the per-version accounting.

The reference runs with ``impl="direct"`` (bit-exact with its other
backends, without Pallas interpret mode), in one module fixture: one jitted
train step and two reference engines."""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as j_ckpt
from repro.configs import tnn_mnist as j_tnn_mnist
from repro.core import network as j_network
from repro.serve.tnn_engine import ClassifyRequest as JRequest
from repro.serve.tnn_engine import TNNEngine as JEngine

from repro_torch import convert
from repro_torch import random as t_random
from repro_torch.configs import tnn_mnist as t_tnn_mnist
from repro_torch.core import network as t_network
from repro_torch.data.mnist_like import digits
from repro_torch.launch import serve as t_serve
from repro_torch.serve.tnn_engine import ClassifyRequest, TNNEngine
from repro_torch.train.tnn_trainer import WaveStream
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

SITES, SLOTS, SEED = 4, 4, 0
N_WAVES, SWAP_EVERY = 6, 2
N_SB = 11  # the superbatch case: 3 waves, the last partial
MORE = 3   # waves served online after the reference's last swap checkpoint


def _np_state(state):
    return {"params": {k: np.array(v) for k, v in state["params"].items()},
            "rng": np.array(state["rng"]), "wave": int(np.asarray(state["wave"]))}


def _same_state(want, got):
    g = convert.state_to_numpy(got)
    assert sorted(g["params"]) == sorted(want["params"])
    for k in want["params"]:
        np.testing.assert_array_equal(want["params"][k], g["params"][k], err_msg=k)
    np.testing.assert_array_equal(want["rng"], g["rng"])
    assert int(g["wave"]) == want["wave"]


def _label_set():
    imgs, labs = digits(16, seed=1)
    return np.ascontiguousarray(t_tnn_mnist.crop_field(imgs, SITES)), labs


def _serve(eng, request_cls, images, pipelined=True):
    """Submit ``images`` as uids 0.. and serve them poll by poll (or step by
    step), recording every published snapshot; returns ({uid: (class id,
    version)}, {version: vote table as numpy})."""
    for uid in range(len(images)):
        eng.submit(request_cls(uid=uid, image=images[uid]))
    tables = {eng.version: np.array(eng.vote_table)}
    while eng.pending:
        eng.poll() if pipelined else eng.step()
        tables[eng.version] = np.array(eng.vote_table)
    done = eng.done
    assert sorted(done) == list(range(len(images)))
    return {u: (done[u].result, done[u].version) for u in done}, tables


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    jcfg = j_tnn_mnist.launcher_network_config(SITES, impl="direct")
    tcfg = t_tnn_mnist.launcher_network_config(SITES, impl="direct")
    stream = WaveStream(tcfg, N_WAVES * SLOTS, SLOTS, seed=1, device="cpu")
    step_fn = j_network.make_train_step(jcfg)
    state = j_network.init_train_state(jax.random.PRNGKey(SEED), jcfg)
    v0 = [np.array(w) for w in j_network.params_from_tree(state["params"], jcfg)]
    states = [_np_state(state)]
    for w in range(N_WAVES):
        state, _ = step_fn(state, jnp.asarray(stream.batch_at(w).numpy()))
        states.append(_np_state(state))
    labels = _label_set()

    def engine(**kw):
        eng = JEngine(jcfg, [jnp.asarray(w) for w in v0], n_slots=SLOTS,
                      impl="direct", online_stdp=True, seed=SEED, **kw)
        eng.fit(*labels)
        return eng

    ckpt = tmp_path_factory.mktemp("jax_swaps")
    swap = engine(swap_every=SWAP_EVERY, ckpt_dir=str(ckpt))
    swap_map, swap_tables = _serve(swap, JRequest, stream.images)
    swap.ckpt.wait()
    sb = engine(superbatch_k=3)
    sb_map, _ = _serve(sb, JRequest, stream.images[:N_SB])
    # the trainer continuing from the last swap checkpoint for MORE waves
    cont, _ = j_ckpt.restore_tnn(j_ckpt.Checkpointer(str(ckpt)), jcfg)
    cont = {"params": cont["params"], "rng": jnp.asarray(cont["rng"]),
            "wave": jnp.asarray(cont["wave"])}
    for w in range(N_WAVES, N_WAVES + MORE):
        cont, _ = step_fn(cont, jnp.asarray(stream.batch_at(w).numpy()))
    return {"v0": v0, "states": states, "stream": stream, "labels": labels,
            "swap_map": swap_map, "swap_tables": swap_tables,
            "swap_state": _np_state(swap.learn_state), "swaps": swap.swaps,
            "ckpt": str(ckpt), "sb_map": sb_map,
            "sb_state": _np_state(sb.learn_state), "cont": _np_state(cont)}


def _engine(ref, impl="direct", **kw):
    cfg = t_tnn_mnist.launcher_network_config(SITES, impl=impl)
    eng = TNNEngine(cfg, convert.params_from_numpy(ref["v0"], cfg, device="cpu"),
                    n_slots=SLOTS, impl=impl, device="cpu", online_stdp=True,
                    seed=SEED, **kw)
    eng.fit(*ref["labels"])
    return eng


@pytest.mark.parametrize("impl", ["direct", "pallas", "fused"])
def test_online_shadow_matches_reference_trainer(ref, impl):
    """N online waves (no swap) leave the shadow at the reference trainer's
    state after N steps on the same volleys, while every request is
    classified under the published v0 weights, which never move."""
    eng = _engine(ref, impl)
    v0 = [w.clone() for w in eng.params]
    got, _ = _serve(eng, ClassifyRequest, ref["stream"].images)
    _same_state(ref["states"][N_WAVES], eng.learn_state)
    assert eng.swaps == 0 and eng.version == 0
    for w, w0 in zip(eng.params, v0):
        assert torch.equal(w, w0)
    assert all(not torch.equal(s, w) for s, w in zip(
        t_network.params_from_tree(eng.learn_state["params"], eng.cfg), v0))
    want = t_network.classify(eng._forward(v0, ref["stream"].x), eng.vote_table, 8)
    assert got == {u: (int(want[u]), 0) for u in range(N_WAVES * SLOTS)}


@pytest.mark.parametrize("impl", ["direct", "fused"])
def test_online_superbatch_matches_lockstep_and_reference(ref, impl):
    """K = 3 over 11 requests (one dispatch of 3 waves, the last partial)
    equals the same engine lock-step at K = 1 and the reference engine's
    K = 3 run: class ids, versions, shadow state and wave counts."""
    images = ref["stream"].images[:N_SB]
    sb = _engine(ref, impl, superbatch_k=3)
    got, _ = _serve(sb, ClassifyRequest, images)
    assert sb.waves_served == 3 and sb.stats().waves == 3
    lock = _engine(ref, impl)
    want, _ = _serve(lock, ClassifyRequest, images, pipelined=False)
    assert got == want == ref["sb_map"]
    _same_state(ref["sb_state"], sb.learn_state)
    _same_state(ref["sb_state"], lock.learn_state)
    assert sb.stats().occupancy == lock.stats().occupancy == N_SB / (3 * SLOTS)


@pytest.mark.parametrize("impl", ["direct", "pallas"])
def test_hot_swap_matches_reference_engine(ref, tmp_path, impl):
    """Automatic hot swaps every 2 learning waves: every uid's (class id,
    version), every published vote table, the final shadow state and every
    swap checkpoint file equal the reference engine's. A published version
    aliasing the shadow would let the next online wave rewrite the weights
    of requests still to be classified under it, and change their ids."""
    eng = _engine(ref, impl, swap_every=SWAP_EVERY, ckpt_dir=str(tmp_path))
    got, tables = _serve(eng, ClassifyRequest, ref["stream"].images)
    eng.ckpt.wait()
    assert got == ref["swap_map"]
    assert len({v for _, v in got.values()}) >= 3
    assert eng.swaps == ref["swaps"] == 3 and eng.version == 3
    assert sorted(tables) == sorted(ref["swap_tables"])
    for ver, vt in ref["swap_tables"].items():
        np.testing.assert_array_equal(vt, tables[ver], err_msg=f"v{ver}")
    assert float(tables[eng.version].sum()) > 0
    _same_state(ref["swap_state"], eng.learn_state)
    steps = sorted(n for n in os.listdir(ref["ckpt"]) if n.startswith("step_"))
    assert steps == ["step_00000002", "step_00000004", "step_00000006"]
    assert steps == sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    for s in steps:
        a, b = os.path.join(ref["ckpt"], s), os.path.join(tmp_path, s)
        ma, mb = (json.load(open(os.path.join(x, "meta.json"))) for x in (a, b))
        assert ma == mb
        for leaf in ma["leaves"]:
            np.testing.assert_array_equal(np.load(os.path.join(a, leaf["file"])),
                                          np.load(os.path.join(b, leaf["file"])))


def test_swap_checkpoint_restores_in_both_packages(ref, tmp_path):
    """A port swap checkpoint is the last published snapshot for the
    reference's ``restore_tnn`` and for the port's ``from_checkpoint``."""
    eng = _engine(ref, "fused", swap_every=SWAP_EVERY, ckpt_dir=str(tmp_path))
    _serve(eng, ClassifyRequest, ref["stream"].images)
    eng.ckpt.wait()
    jcfg = j_tnn_mnist.launcher_network_config(SITES, impl="direct")
    state, extra = j_ckpt.restore_tnn(j_ckpt.Checkpointer(str(tmp_path)), jcfg)
    assert extra["wave"] == N_WAVES and extra["has_vote"]
    ps, vt, ver = eng._published
    for i, w in enumerate(ps):
        np.testing.assert_array_equal(np.asarray(state["params"][f"layer_{i:02d}"]),
                                      w.numpy())
    np.testing.assert_array_equal(np.asarray(state["vote_table"]), vt.numpy())
    back = TNNEngine.from_checkpoint(str(tmp_path), eng.cfg, n_slots=SLOTS,
                                     impl="fused", device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back.params, ps))
    assert torch.equal(back.vote_table, vt) and back.learn_state is None


@pytest.mark.parametrize("k", [1, 3])
def test_from_checkpoint_online_continues_a_jax_checkpoint(ref, tmp_path, k):
    """The reference engine's last swap checkpoint, served online by the
    port for 3 more waves, leaves the shadow where the reference trainer
    resuming from it for 3 waves lands; the checkpoint's directory gets no
    write without a swap."""
    src = tmp_path / "jax"
    shutil.copytree(ref["ckpt"], src)
    before = sorted(os.listdir(src))
    cfg = t_tnn_mnist.launcher_network_config(SITES, impl="pallas")
    eng = TNNEngine.from_checkpoint(str(src), cfg, n_slots=SLOTS, impl="pallas",
                                    device="cpu", online_stdp=True, superbatch_k=k)
    assert int(eng.learn_state["wave"]) == N_WAVES
    stream = ref["stream"]
    rows = [(np.arange(SLOTS) + w * SLOTS) % stream.n
            for w in range(N_WAVES, N_WAVES + MORE)]
    for uid, row in enumerate(np.concatenate(rows)):
        eng.submit(ClassifyRequest(uid=uid, image=stream.images[row]))
    eng.run_until_done()
    _same_state(ref["cont"], eng.learn_state)
    assert sorted(os.listdir(src)) == before and eng.ckpt.dir == str(src)


def test_online_guardrails(ref):
    cfg = t_tnn_mnist.launcher_network_config(SITES, impl="direct")
    ps = convert.params_from_numpy(ref["v0"], cfg, device="cpu")
    for kw, msg in (({"superbatch_k": 0}, "superbatch_k"),
                    ({"swap_every": -1}, "swap_every"),
                    ({"swap_every": 2}, "online_stdp")):
        with pytest.raises(ValueError, match=msg):
            TNNEngine(cfg, ps, n_slots=SLOTS, device="cpu", **kw)
    with pytest.raises(RuntimeError, match="online_stdp"):
        TNNEngine(cfg, ps, n_slots=SLOTS, device="cpu").hot_swap()
    on = TNNEngine(cfg, ps, n_slots=SLOTS, device="cpu", online_stdp=True)
    with pytest.raises(RuntimeError, match="label"):
        on.hot_swap()
    assert on.learn_state["params"]["layer_00"] is not on.params[0]
    assert torch.equal(on.learn_state["params"]["layer_00"], on.params[0])
    seeded = t_network.init_train_state(t_random.PRNGKey(7), cfg, device="cpu")
    on7 = TNNEngine(cfg, ps, n_slots=SLOTS, device="cpu", online_stdp=True, seed=7)
    assert torch.equal(on7.learn_state["rng"], seeded["rng"])
    assert int(on7.learn_state["wave"]) == 0
    gauss = dataclasses.replace(cfg.layers[0].column.stdp, batch_reduce="gauss")
    bad = dataclasses.replace(cfg, layers=tuple(
        dataclasses.replace(l, column=dataclasses.replace(l.column, stdp=gauss))
        for l in cfg.layers))
    for make in (t_network.make_online_step, t_network.make_online_superbatch_step):
        with pytest.raises(ValueError, match="batch_reduce"):
            make(bad)


def test_stats_by_version_partition(ref):
    """Per-version stats partition the run: requests and waves sum to the
    totals, each version counts its own requests, and reset clears the
    split but keeps the version."""
    eng = _engine(ref, swap_every=SWAP_EVERY)
    got, _ = _serve(eng, ClassifyRequest, ref["stream"].images)
    agg, by_ver = eng.stats(), eng.stats_by_version()
    assert sorted(by_ver) == [0, 1, 2]
    assert sum(s.requests for s in by_ver.values()) == agg.requests == N_WAVES * SLOTS
    assert sum(s.waves for s in by_ver.values()) == agg.waves == N_WAVES
    for ver, s in by_ver.items():
        assert s.requests == sum(1 for _, v in got.values() if v == ver)
        assert 0.0 < s.occupancy <= 1.0 and s.wall_s >= 0.0
    eng.reset()
    assert eng.stats_by_version() == {} and eng.version == 3


def test_serve_launcher_online_flags(capsys):
    """``--online-stdp`` learns while serving and reports per-version stats;
    without it the default ``--swap-every`` is not forwarded (the engine
    would refuse it), and ``--superbatch-k`` drains the backlog K waves at a
    time to the same class ids."""
    base = ["--sites", "4", "--slots", "4", "--requests", "22", "--train-waves", "2",
            "--device", "cpu"]
    plain = t_serve.main(base)
    assert set(plain.versions.values()) == {0} and list(plain.version_stats) == [0]
    sb = t_serve.main(base + ["--superbatch-k", "3", "--impl", "fused"])
    assert sb.results == plain.results and sb.stats.waves == plain.stats.waves == 6
    on = t_serve.main(base + ["--online-stdp", "--swap-every", "2", "--superbatch-k", "2"])
    assert sorted(on.version_stats) == sorted(set(on.versions.values())) == [0, 1, 2]
    assert sum(s.requests for s in on.version_stats.values()) == 22
    out = capsys.readouterr().out
    assert "[online-stdp] learned to wave 6, 3 hot swap(s), now serving v3" in out
    assert t_serve.parse_args([]).swap_every == 8
