"""The port's fault-tolerant LM trainer (``repro_torch.train.trainer``), its
LM checkpoints and ``launch.train --arch <LM>``, against the JAX package.

The trainer cases follow the reference's ``tests/test_checkpoint_trainer.py``
(runs and checkpoints, resume, an injected failure, a NaN loss, the SIGTERM
flush) on the port's ``Trainer``; on the port's real train step (smoke
llama3.2-3b, bf16, AdamW) a resumed run equals an uninterrupted one bit for
bit, and the NaN step leaves the state as it was. Checkpoints cross both
ways: the port restores what ``repro.train.trainer.Trainer`` wrote (through
``lm_abstract_state``) and the reference restores the port's, leaves
bit-equal. The launcher, ``--arch llama3.2-3b --smoke --steps 6 --batch 2
--seq 16 --device cpu``, writes ``metrics.jsonl`` with the reference
launcher's keys and losses within 1e-3 of its (bf16 compute; measured
4.3e-5), ``grad_norm`` within 1e-3 relative, and resumes when run again.
"""
import json
import os
import signal
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import smoke_config as j_smoke
from repro.data.tokens import TokenStream as JStream
from repro.launch import train as j_launch
from repro.train import optimizer as JO
from repro.train import train_step as JTS
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig

from repro_torch import convert
from repro_torch import random as t_random
from repro_torch.checkpoint.checkpointer import Checkpointer, lm_abstract_state
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import train as t_launch
from repro_torch.models.params import tree_flatten
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TTS
from repro_torch.train import trainer as trainer_mod
from repro_torch.train.trainer import Trainer, TrainerConfig
from torch_lm_params import FAST_COMPILE
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

ARCH = "llama3.2-3b"
OPT_KW = dict(lr=1e-3, warmup_steps=2, total_steps=8)
LAUNCH = ["--arch", ARCH, "--smoke", "--steps", "6", "--batch", "2", "--seq", "16"]


@pytest.fixture
def sigterm_restored():
    """The launchers install a SIGTERM handler: put the previous one back."""
    prev = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, prev)


# -- the reference's trainer cases, on a toy state ---------------------------


def _state(v=0.0):
    return {"params": {"w": torch.full((4, 4), v)}, "step": torch.zeros((), dtype=torch.int32)}


def _mk_step(fail_at=None):
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        if fail_at is not None and calls["n"] == fail_at:
            raise RuntimeError("injected device failure")
        w = state["params"]["w"] - 0.1
        return ({"params": {"w": w}, "step": state["step"] + 1},
                {"loss_total": w.abs().mean()})

    return step_fn, calls


def _stream():
    return TokenStream(vocab_size=64, batch=2, seq=8)


def test_trainer_runs_and_checkpoints(tmp_path):
    step_fn, _ = _mk_step()
    cfg = TrainerConfig(total_steps=12, ckpt_every=5, ckpt_dir=str(tmp_path), log_every=100,
                        metrics_path=str(tmp_path / "metrics.jsonl"))
    out = Trainer(step_fn, _state(1.0), _stream(), cfg).run()
    assert out["final_step"] == 12 and out["restarts"] == 0
    assert Checkpointer(str(tmp_path)).all_steps() == [5, 10, 12]
    lines = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    assert [l["step"] for l in lines] == list(range(1, 13))
    assert sorted(lines[0]) == ["dt_s", "loss_total", "step"]


def test_trainer_resumes_from_checkpoint(tmp_path):
    step_fn, _ = _mk_step()
    Trainer(step_fn, _state(1.0), _stream(),
            TrainerConfig(total_steps=6, ckpt_every=3, ckpt_dir=str(tmp_path),
                          log_every=100)).run()
    step_fn2, calls2 = _mk_step()
    tr = Trainer(step_fn2, _state(99.0), _stream(),
                 TrainerConfig(total_steps=10, ckpt_every=3, ckpt_dir=str(tmp_path),
                               log_every=100))
    assert tr.run()["final_step"] == 10
    assert calls2["n"] == 4                      # only the remaining steps re-ran
    np.testing.assert_allclose(tr.state["params"]["w"].numpy(), 0.0, atol=1e-6)


def test_trainer_recovers_from_injected_failure(tmp_path):
    step_fn, _ = _mk_step(fail_at=5)
    cfg = TrainerConfig(total_steps=8, ckpt_every=2, ckpt_dir=str(tmp_path),
                        max_restarts=2, log_every=100)
    out = Trainer(step_fn, _state(1.0), _stream(), cfg).run()
    assert out["final_step"] == 8 and out["restarts"] == 1
    step_fn, _ = _mk_step(fail_at=1)
    cfg = TrainerConfig(total_steps=3, ckpt_every=2, ckpt_dir=str(tmp_path / "b"),
                        max_restarts=0, log_every=100)
    with pytest.raises(RuntimeError, match="injected"):
        Trainer(step_fn, _state(1.0), _stream(), cfg).run()


def test_trainer_nan_loss_triggers_restart(tmp_path):
    hits = {"n": 0}

    def step_fn(state, batch):
        hits["n"] += 1
        loss = float("nan") if hits["n"] == 3 else 0.5
        return ({"params": state["params"], "step": state["step"] + 1},
                {"loss_total": torch.tensor(loss)})

    cfg = TrainerConfig(total_steps=5, ckpt_every=2, ckpt_dir=str(tmp_path),
                        max_restarts=2, log_every=100)
    out = Trainer(step_fn, _state(), _stream(), cfg).run()
    assert out["final_step"] == 5 and out["restarts"] == 1


def test_preemption_flushes_checkpoint(tmp_path, sigterm_restored):
    step_fn, _ = _mk_step()
    cfg = TrainerConfig(total_steps=1000, ckpt_every=500, ckpt_dir=str(tmp_path),
                        log_every=10_000)
    tr = Trainer(step_fn, _state(1.0), _stream(), cfg)
    tr.install_preemption_handler()

    def step_then_preempt(state, batch):
        if tr.step == 4:
            os.kill(os.getpid(), signal.SIGTERM)  # the handler sets the flag
        return step_fn(state, batch)

    tr.step_fn = step_then_preempt
    assert tr.run()["final_step"] == 5
    assert Checkpointer(str(tmp_path)).latest_step() == 5


def test_straggler_is_counted(tmp_path, monkeypatch):
    step_fn, _ = _mk_step()
    # (start, end) of each step: six of 1 s, then one of 10 s
    clock = iter([t for i, d in enumerate([1.0] * 6 + [10.0]) for t in (2.0 * i, 2.0 * i + d)])
    monkeypatch.setattr(trainer_mod, "time", types.SimpleNamespace(time=lambda: next(clock)))
    cfg = TrainerConfig(total_steps=7, ckpt_every=100, ckpt_dir=str(tmp_path),
                        log_every=100, metrics_path=str(tmp_path / "m.jsonl"))
    assert Trainer(step_fn, _state(1.0), _stream(), cfg).run()["stragglers"] == 1
    lines = [json.loads(l) for l in open(tmp_path / "m.jsonl")]
    assert [l.get("straggler") for l in lines] == [None] * 6 + [1.0]


# -- the port's LM train step under the trainer ------------------------------


def _lm(ckpt_dir, total, wrap=None, metrics=True):
    cfg = t_smoke(ARCH)
    to = TO.OptConfig(**OPT_KW)
    state = TTS.init_state(cfg, to, t_random.PRNGKey(0), "cpu")
    step_fn = TTS.make_train_step(cfg, to, TTS.TrainConfig(kv_chunk=8))
    tcfg = TrainerConfig(total_steps=total, ckpt_every=3, ckpt_dir=str(ckpt_dir),
                         log_every=100, max_restarts=1,
                         metrics_path=str(ckpt_dir / "metrics.jsonl") if metrics else None)
    tr = Trainer(wrap(step_fn) if wrap else step_fn, state,
                 TokenStream(cfg.vocab_size, 2, 16, seed=0), tcfg)
    return tr


def _np_state(tr):
    return convert.lm_state_to_numpy(tr.state)


def _assert_same(a, b):
    fa, fb = tree_flatten(a), tree_flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype, path
        np.testing.assert_array_equal(y, x, err_msg=str(path))


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm_b")
    tr = _lm(d, 6)
    out = tr.run()
    assert out["final_step"] == 6 and out["restarts"] == 0
    return _np_state(tr), [json.loads(l) for l in open(d / "metrics.jsonl")]


def test_lm_resume_is_bit_exact(tmp_path, uninterrupted):
    tr = _lm(tmp_path, 6)
    orig = tr.step_fn

    def stop_after_4(state, batch):
        if tr.step == 3:
            tr._preempted = True                      # what the SIGTERM handler sets
        return orig(state, batch)

    tr.step_fn = stop_after_4
    assert tr.run()["final_step"] == 4
    assert Checkpointer(str(tmp_path)).all_steps() == [3, 4]
    tr2 = _lm(tmp_path, 6)                            # a new process: fresh draw, resume
    assert tr2.run()["final_step"] == 6
    want, lines = uninterrupted
    _assert_same(want, _np_state(tr2))
    got = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    assert [l["step"] for l in got] == [1, 2, 3, 4, 5, 6]
    for a, b in zip(got, lines):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]


def _fail_inside_adamw(monkeypatch, tr, after: int = 3) -> dict:
    """Arm a fault inside ``adamw_update``: once ``armed["on"]`` is set, the
    step's AdamW pass raises after it has updated ``after`` leaves in place
    (the count already advanced), as an OOM in a later leaf's temporaries
    would. The fault fires once."""
    armed = {"on": False}
    orig = TO.tree_flatten

    def flatten(tree, *a, **kw):
        items = orig(tree, *a, **kw)
        if not (armed["on"] and tree is tr.state["opt"]["m"]):
            return items
        armed["on"] = False

        def leaves():
            yield from items[:after]
            raise RuntimeError("injected failure inside adamw_update")
        return leaves()

    monkeypatch.setattr(TO, "tree_flatten", flatten)
    return armed


def test_lm_failure_and_nan_step_replay(tmp_path, uninterrupted, monkeypatch):
    """Call 5 (the fifth step, after the checkpoint at step 3) raises inside
    ``adamw_update`` with some leaves already updated in place; call 6 (the
    fourth step's replay) sees a NaN weight, so its loss is not finite: that
    step must leave the state as it was (checked inside). Each time the
    trainer restores the step-3 checkpoint into the state and replays, and
    the run ends in the uninterrupted run's state. Each fault is one
    restart."""
    calls = {"n": 0}
    seen, fault = {}, {}

    def wrap(step_fn):
        def faulty(state, batch):
            calls["n"] += 1
            if calls["n"] == 5:
                fault["armed"]["on"] = True
            if calls["n"] == 6:
                leaf = state["params"]["final_norm"]["scale"]
                keep = leaf[0].clone()
                before = convert.lm_state_to_numpy(state)
                leaf[0] = float("nan")
                out, m = step_fn(state, batch)
                leaf[0] = keep
                seen["loss"] = float(m["loss_total"])
                _assert_same(before, convert.lm_state_to_numpy(out))
                return out, m
            return step_fn(state, batch)
        return faulty

    tr = _lm(tmp_path, 6, wrap, metrics=False)
    fault["armed"] = _fail_inside_adamw(monkeypatch, tr)
    tr.cfg.max_restarts = 2
    out = tr.run()
    assert out["final_step"] == 6 and out["restarts"] == 2
    assert calls["n"] == 9 and np.isnan(seen["loss"])
    _assert_same(uninterrupted[0], _np_state(tr))


def test_lm_failure_before_first_checkpoint_stops(tmp_path, monkeypatch, uninterrupted):
    """The second step raises inside ``adamw_update`` before any checkpoint
    exists: the state is half updated (the count has advanced, some leaves
    have moved) and nothing older is kept. Without ``init_state`` the
    trainer stops there: it raises, restarts left or not, and writes no
    checkpoint. With ``init_state`` (the launcher's: the step-0 state drawn
    again) it replays from step 0 and ends in the uninterrupted run's state
    bit for bit, as the reference's trainer, whose states are immutable,
    ends in its own uninterrupted run's under the same failure: its losses
    step for step within 1e-3 of the port's (bf16 compute, as the
    launcher's test holds them), one restart each."""
    tr = _lm(tmp_path / "stop", 6)
    tr.cfg.max_restarts = 3
    armed = _fail_inside_adamw(monkeypatch, tr)
    orig = tr.step_fn
    calls = {"n": 0}

    def second_fails(state, batch):
        calls["n"] += 1
        armed["on"] = calls["n"] == 2
        return orig(state, batch)

    tr.step_fn = second_fails
    with pytest.raises(RuntimeError, match="inside adamw_update"):
        tr.run()
    assert tr.step == 1 and tr.restarts == 0
    assert int(tr.state["opt"]["count"]) == 2 and int(tr.state["step"]) == 1
    assert Checkpointer(str(tmp_path / "stop")).all_steps() == []
    lines = [json.loads(l) for l in open(tmp_path / "stop" / "metrics.jsonl")]
    assert [l["step"] for l in lines] == [1]

    # with init_state: the step-0 state drawn again and the run replayed
    d = tmp_path / "replay"
    cfg, to = t_smoke(ARCH), TO.OptConfig(**OPT_KW)
    tr = _lm(d, 6)
    tr.init_state = lambda: TTS.init_state(cfg, to, t_random.PRNGKey(0), "cpu")
    armed = _fail_inside_adamw(monkeypatch, tr)
    orig, calls["n"] = tr.step_fn, 0
    tr.step_fn = second_fails
    out = tr.run()
    assert out == {"final_step": 6, "restarts": 1, "stragglers": out["stragglers"]}
    assert calls["n"] == 8
    _assert_same(uninterrupted[0], _np_state(tr))
    got = [json.loads(l) for l in open(d / "metrics.jsonl")]
    assert [l["step"] for l in got] == [1, 1, 2, 3, 4, 5, 6]

    # the reference under the same failure: its trainer replays the step
    jtr = _reference_trainer(tmp_path / "jax", 6)
    jstep, jcalls = jtr.step_fn, {"n": 0}

    def jfails(state, batch):
        jcalls["n"] += 1
        if jcalls["n"] == 2:
            raise RuntimeError("injected failure")
        return jstep(state, batch)

    jtr.step_fn = jfails
    jtr.cfg.metrics_path = str(tmp_path / "jax.jsonl")
    jtr._metrics_f = open(jtr.cfg.metrics_path, "a")
    jout = jtr.run()
    assert jout["final_step"] == 6 and jout["restarts"] == 1
    want = [json.loads(l) for l in open(tmp_path / "jax.jsonl")]
    assert [l["step"] for l in want] == [1, 2, 3, 4, 5, 6]
    for a, b in zip(got[1:], want):
        assert abs(a["loss"] - b["loss"]) <= 1e-3


# -- checkpoints across the two packages -------------------------------------


def _reference_trainer(ckpt_dir, total):
    cfg = j_smoke(ARCH)
    jo = JO.OptConfig(**OPT_KW)
    state = JTS.init_state(cfg, jo, jax.random.PRNGKey(0))
    step = jax.jit(JTS.make_train_step(cfg, jo, JTS.TrainConfig(kv_chunk=8)),
                   compiler_options=FAST_COMPILE)
    tcfg = JTrainerConfig(total_steps=total, ckpt_every=2, ckpt_dir=str(ckpt_dir),
                          log_every=100)
    return JTrainer(step, state, JStream(cfg.vocab_size, 2, 16, seed=0), tcfg)


def test_checkpoints_cross_both_ways(tmp_path):
    jtr = _reference_trainer(tmp_path / "jax", 2)
    assert jtr.run()["final_step"] == 2
    want = jax.tree.map(np.asarray, jtr.state)
    cfg, to = t_smoke(ARCH), TO.OptConfig(**OPT_KW)
    ck = Checkpointer(str(tmp_path / "jax"))
    tree, extra = ck.restore(2, lm_abstract_state(cfg, to))
    assert extra == {"data_step": 2}
    state = convert.lm_state_from_numpy(tree, cfg, to, "cpu")
    _assert_same(want, convert.lm_state_to_numpy(state))
    # the port's trainer resumes the reference's run; the reference restores
    # the port's checkpoint
    tr = _lm(tmp_path / "jax", 4, metrics=False)
    assert tr.maybe_resume() and tr.step == 2
    _assert_same(want, _np_state(tr))
    assert tr.run()["final_step"] == 4
    jck = JCheckpointer(str(tmp_path / "jax"))
    assert jck.latest_step() == 4
    jc, jo = j_smoke(ARCH), JO.OptConfig(**OPT_KW)
    restored, jextra = jck.restore(4, JTS.abstract_state(jc, jo))
    assert jextra == {"data_step": 4}
    _assert_same(_np_state(tr), jax.tree.map(np.asarray, restored))


def test_abstract_state_is_the_references():
    for name, compress in (("adamw", False), ("adafactor", True)):
        for arch in (ARCH, "zamba2-7b"):
            jabs = JTS.abstract_state(j_smoke(arch), JO.OptConfig(name=name,
                                                                 compress_grads=compress))
            tabs = lm_abstract_state(t_smoke(arch), TO.OptConfig(name=name,
                                                                 compress_grads=compress))
            jl = jax.tree_util.tree_flatten_with_path(jabs)[0]
            tl = tree_flatten(tabs, lambda x: hasattr(x, "dtype"))
            assert [jax.tree_util.keystr(p) for p, _ in jl] == [
                "".join(f"[{k!r}]" for k in p) for p, _ in tl]
            for (_, a), (_, b) in zip(jl, tl):
                assert tuple(a.shape) == tuple(b.shape) and np.dtype(a.dtype) == b.dtype


# -- the launcher ------------------------------------------------------------


def test_launcher_matches_reference_and_resumes(tmp_path, monkeypatch, sigterm_restored):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(sys, "argv", ["train", *LAUNCH, "--ckpt-dir", str(jdir)])
    j_launch.main()
    out = t_launch.main([*LAUNCH, "--device", "cpu", "--ckpt-dir", str(tdir)])
    assert out["final_step"] == 6 and out["restarts"] == 0
    want = [json.loads(l) for l in open(jdir / "metrics.jsonl")]
    got = [json.loads(l) for l in open(tdir / "metrics.jsonl")]
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b) and a["step"] == b["step"] and a["tokens"] == b["tokens"]
        assert abs(a["loss"] - b["loss"]) <= 1e-3
        assert abs(a["grad_norm"] - b["grad_norm"]) <= 1e-3 * b["grad_norm"]
    assert Checkpointer(str(tdir)).all_steps() == Checkpointer(str(jdir)).all_steps() == [5, 6]
    # run again with more steps: resumes at 6 (the schedule is --steps')
    out = t_launch.main([*LAUNCH[:-6], "--steps", "8", "--batch", "2", "--seq", "16",
                         "--device", "cpu", "--ckpt-dir", str(tdir)])
    assert out["final_step"] == 8
    got = [json.loads(l) for l in open(tdir / "metrics.jsonl")]
    assert [l["step"] for l in got] == [1, 2, 3, 4, 5, 6, 7, 8]


@pytest.mark.parametrize("flags", [["--mesh", "2x2"], ["--production-mesh", "single"]])
def test_launcher_refuses_lm_meshes(flags, capsys):
    """``--mesh DxM`` with an LM is taken (it trains under torchrun:
    ``tests/test_torch_lm_mesh.py``); ``--production-mesh`` with an LM exits
    2 naming the cards its meshes need."""
    if flags[0] == "--mesh":
        args = t_launch.parse_args(["--arch", ARCH, "--smoke", *flags])
        assert args.mesh == "2x2" and args.arch == ARCH
    else:
        with pytest.raises(SystemExit) as e:
            t_launch.parse_args(["--arch", ARCH, "--smoke", *flags])
        assert e.value.code == 2
        err = capsys.readouterr().err
        assert "256 cards" in err and "--mesh DxM" in err
    assert t_launch.parse_args([]).arch == "tnn-mnist"
    assert t_launch.parse_args(["--mesh", "2x2"]).mesh == "2x2"   # tnn-mnist keeps it


@pytest.mark.parametrize("arch,flags,item", [
    ("whisper-tiny", [], 15), ("whisper-tiny", ["--mesh", "2x2"], 15),
    ("internvl2-76b", [], 15), ("internvl2-76b", ["--mesh", "2x2"], 15)])
def test_launcher_refuses_unheld_lm_runs(arch, flags, item, capsys):
    """The encoder-decoder and the VLM need frames or a prefix of embeds that
    the token stream does not carry (the reference launcher fails on them
    too). Each exits 2 naming the ROADMAP item that keeps it, meshed or
    not; every other arch is taken with ``--mesh`` (the hybrid's meshed run:
    ``tests/test_torch_lm_mesh.py::test_launcher_mesh_trains_the_hybrid``)."""
    with pytest.raises(SystemExit) as e:
        t_launch.main(["--arch", arch, "--smoke", "--device", "cpu", *flags])
    assert e.value.code == 2
    assert f"ROADMAP Queue 3 item {item}" in capsys.readouterr().err
    assert t_launch.parse_args(["--arch", "zamba2-7b", "--smoke", "--mesh", "2x2"]).mesh == "2x2"
