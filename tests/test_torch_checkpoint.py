"""The port's checkpointer on the reference's on-disk layout: each package
restores the other's TNN checkpoints (same leaf file names, same
``meta.json`` leaves), re-saves are crash-atomic, ``keep`` collects old
steps, async saves join on ``wait``, a foreign fingerprint is refused before
any array is read; ``TNNEngine.from_checkpoint`` and the launchers'
``--from-ckpt`` / resume on the CPU."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as j_ckpt
from repro.configs import tnn_mnist as j_tnn_mnist

from repro_torch import convert
from repro_torch.checkpoint import checkpointer as t_ckpt
from repro_torch.configs import tnn_mnist as t_tnn_mnist
from repro_torch.data.mnist_like import digits
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.serve.tnn_engine import ClassifyRequest, TNNEngine
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

SITES = 16


def _numpy_state(seed, wave=5):
    """A TNN checkpoint state at 16 sites as the reference holds it."""
    cfg = t_tnn_mnist.launcher_network_config(SITES)
    rng = np.random.default_rng(seed)
    return {"params": {f"layer_{i:02d}": rng.integers(
                0, 8, (l.n_cols, l.column.p, l.column.q)).astype(np.int8)
                for i, l in enumerate(cfg.layers)},
            "rng": rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32),
            "wave": np.asarray(wave, np.int32),
            "vote_table": rng.integers(0, 5, (SITES, 10, 10)).astype(np.float32)}


def _extra(cfg, wave=5, has_vote=True):
    return {"arch": "tnn-mnist", "config": t_ckpt.tnn_config_fingerprint(cfg),
            "wave": wave, "has_vote": has_vote, "eval_wave": wave, "accuracy": 0.25}


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_fingerprint_and_abstract_state_match_the_reference():
    for depth in (2, 3):
        jcfg = j_tnn_mnist.launcher_network_config(SITES, depth=depth)
        tcfg = t_tnn_mnist.launcher_network_config(SITES, depth=depth)
        assert t_ckpt.tnn_config_fingerprint(tcfg) == j_ckpt.tnn_config_fingerprint(jcfg)
        ja = jax.tree_util.tree_flatten_with_path(j_ckpt.tnn_abstract_state(jcfg))[0]
        ta = t_ckpt._leaf_paths(t_ckpt.tnn_abstract_state(tcfg))
        assert [jax.tree_util.keystr(p) for p, _ in ja] == [p for p, _ in ta]
        for (_, js), (_, ts) in zip(ja, ta):
            assert tuple(js.shape) == ts.shape and np.dtype(js.dtype) == ts.dtype


def test_cross_restore_both_ways(tmp_path):
    """The reference writes, the port reads; the port writes, the reference
    reads; both directories hold the same files and the same meta.json."""
    tcfg = t_tnn_mnist.launcher_network_config(SITES)
    jcfg = j_tnn_mnist.launcher_network_config(SITES)
    state = _numpy_state(1)
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    j_ckpt.Checkpointer(j_dir).save(
        5, jax.tree_util.tree_map(jnp.asarray, state), extra=_extra(tcfg), block=True)
    got, extra = t_ckpt.restore_tnn(t_ckpt.Checkpointer(j_dir), tcfg, device="cpu")
    assert extra == _extra(tcfg)
    assert got["rng"].dtype == torch.uint32 and got["wave"].dtype == torch.int32
    _assert_tree_equal(state, convert.state_to_numpy(got))

    t_ckpt.Checkpointer(t_dir).save(5, got, extra=extra, block=True)
    back, extra_j = j_ckpt.restore_tnn(j_ckpt.Checkpointer(j_dir), jcfg)
    _assert_tree_equal(state, jax.tree_util.tree_map(np.asarray, back))
    back_t, _ = j_ckpt.restore_tnn(j_ckpt.Checkpointer(t_dir), jcfg)
    _assert_tree_equal(state, jax.tree_util.tree_map(np.asarray, back_t))
    a, b = (os.path.join(d, "step_00000005") for d in (j_dir, t_dir))
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    ma, mb = (json.load(open(os.path.join(d, "meta.json"))) for d in (a, b))
    assert ma == mb and len(ma["leaves"]) == 5


def test_resave_keep_async_and_stale_dirs(tmp_path):
    ck = t_ckpt.Checkpointer(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        ck.save(step, {"a": torch.full((3,), step, dtype=torch.int32)})
    ck.wait()
    assert ck.all_steps() == [2, 3]
    spec = {"a": t_ckpt.LeafSpec((3,), np.dtype(np.int32))}
    # re-saving a live step replaces it whole (the live one moved aside first)
    ck.save(3, {"a": torch.full((3,), 7, dtype=torch.int32)}, block=True)
    tree, _ = ck.restore(3, spec)
    np.testing.assert_array_equal(tree["a"], [7, 7, 7])
    # leftovers of a crash: neither a .tmp nor an .old directory is a step
    os.makedirs(tmp_path / "step_00000009.tmp")
    os.makedirs(tmp_path / "step_00000008.old")
    assert ck.latest_step() == 3
    with pytest.raises(ValueError, match="shape"):
        ck.restore(3, {"a": t_ckpt.LeafSpec((4,), np.dtype(np.int32))})
    with pytest.raises(KeyError):
        ck.restore(3, {"b": t_ckpt.LeafSpec((3,), np.dtype(np.int32))})


def test_foreign_checkpoint_is_refused_before_any_array_is_read(tmp_path):
    tcfg = t_tnn_mnist.launcher_network_config(SITES)
    other = t_tnn_mnist.launcher_network_config(4)
    ck = t_ckpt.Checkpointer(str(tmp_path))
    ck.save(5, _numpy_state(2), extra=_extra(other), block=True)
    d = tmp_path / "step_00000005"
    for name in os.listdir(d):
        if name.endswith(".npy"):
            os.remove(d / name)  # a load would fail with another error
    with pytest.raises(ValueError, match="written for"):
        t_ckpt.restore_tnn(ck, tcfg, device="cpu")
    with pytest.raises(FileNotFoundError):
        t_ckpt.restore_tnn(t_ckpt.Checkpointer(str(tmp_path / "empty")), tcfg,
                           device="cpu")


def test_engine_from_checkpoint(tmp_path):
    """Weights and vote table from a checkpoint classify as an engine built
    from them; a checkpoint without a vote table needs label data."""
    cfg = t_tnn_mnist.launcher_network_config(SITES)
    state = _numpy_state(3)
    ck = t_ckpt.Checkpointer(str(tmp_path / "voted"))
    ck.save(5, state, extra=_extra(cfg), block=True)
    eng = TNNEngine.from_checkpoint(str(tmp_path / "voted"), cfg, n_slots=4,
                                    device="cpu")
    np.testing.assert_array_equal(eng.vote_table.numpy(), state["vote_table"])
    ref = TNNEngine(cfg, convert.params_from_numpy(state["params"], cfg, "cpu"),
                    n_slots=4, device="cpu")
    ref.vote_table = torch.from_numpy(state["vote_table"])
    imgs = t_tnn_mnist.crop_field(digits(6, seed=2)[0], SITES)
    for e in (eng, ref):
        for uid in range(6):
            e.submit(ClassifyRequest(uid=uid, image=imgs[uid]))
    assert ({u: r.result for u, r in eng.run_until_done().items()}
            == {u: r.result for u, r in ref.run_until_done().items()})

    t_ckpt.Checkpointer(str(tmp_path / "bare")).save(
        5, state, extra=_extra(cfg, has_vote=False), block=True)
    with pytest.raises(ValueError, match="no vote table"):
        TNNEngine.from_checkpoint(str(tmp_path / "bare"), cfg, device="cpu")
    lab = t_tnn_mnist.crop_field(digits(8, seed=1)[0], SITES), digits(8, seed=1)[1]
    eng = TNNEngine.from_checkpoint(str(tmp_path / "bare"), cfg, n_slots=4,
                                    label_data=lab, device="cpu")
    ref.fit(*lab)
    np.testing.assert_array_equal(eng.vote_table.numpy(), ref.vote_table.numpy())


def test_launchers_resume_and_serve_from_a_checkpoint(tmp_path, capsys):
    """``launch.train --smoke`` on the CPU, re-run with --epochs 2 to resume;
    then ``launch.serve --from-ckpt`` serves the trained state."""
    d = str(tmp_path / "ck")
    one = t_train.main(["--arch", "tnn-mnist", "--smoke", "--device", "cpu",
                        "--ckpt-dir", d])
    assert one["final_wave"] == 8 and not one["resumed"]
    two = t_train.main(["--arch", "tnn-mnist", "--smoke", "--device", "cpu",
                        "--ckpt-dir", d, "--epochs", "2"])
    assert two["resumed"] and two["final_wave"] == 16
    lines = open(os.path.join(d, "metrics.jsonl")).read().splitlines()
    assert [json.loads(l)["wave"] for l in lines] == list(range(1, 17))
    rep = t_serve.main(["--sites", str(SITES), "--slots", "4", "--requests", "6",
                        "--from-ckpt", d, "--device", "cpu"])
    assert sorted(rep.results) == list(range(6)) and rep.warmup_spikes == []
    np.testing.assert_array_equal(rep.vote_table.numpy(),
                                  two["trainer"].vote_table.numpy())
    assert "warm-started from" in capsys.readouterr().out
