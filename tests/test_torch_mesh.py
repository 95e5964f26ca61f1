"""The port's (data, model) mesh on ``torch.distributed`` against the JAX
package's UNMESHED results, bit for bit, at 9 sites (9 % 2 and 9 % 4 are not
0, so the model axis pads), B = 4, K = 2:

* ``MeshSpec``'s geometry and pad/slice helpers against
  ``repro.kernels.padding.MeshSpec``; the windows and the gather (in process);
* the windowed threefry draw's plain version against the reference's
  ``pad_uniform_sites`` of its global draw, sliced (in process);
* under (4, 1), (2, 2) and (1, 4), four gloo ranks on the CPU
  (``tests/torch_mesh.py``, started once for every factorization): two
  train steps and a K-wave superbatch on ``direct``, ``pallas`` and ``fused``
  (plain versions here); the engine's vote table and per-uid results; under
  (2, 2) online serving with hot swaps (the shadow equals the reference
  engine's, whose shadow is its trainer's), the trainer and both launchers;
  a checkpoint saved under (2, 2) restores under (1, 4) and unmeshed, and a
  JAX checkpoint restores under (2, 2);
* the reference's refusals; the collective recorder's ring-model bytes and
  the probe's report against ``repro.roofline.analysis.parse_collectives``
  and the reference probe's report.

The reference runs with ``impl="direct"`` and ``mesh=None`` in one module
fixture and hands its numbers to the ranks as an ``.npz``."""
import io
import os
import re
import types
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as j_ckpt
from repro.configs import tnn_mnist as j_tnn_mnist
from repro.core import layer as j_layer
from repro.core import network as j_network
from repro.kernels import padding as j_padding
from repro.launch import collective_probe as j_probe
from repro.launch import mesh as j_mesh
from repro.roofline import analysis as j_analysis
from repro.serve.tnn_engine import ClassifyRequest as JRequest
from repro.serve.tnn_engine import TNNEngine as JEngine
from repro.train.tnn_trainer import WaveStream as JWaveStream

import torch_mesh as tm
from repro_torch import convert
from repro_torch import random as t_random
from repro_torch.checkpoint.checkpointer import Checkpointer, restore_tnn
from repro_torch.configs import tnn_mnist as t_tnn_mnist
from repro_torch.core import network as t_network
from repro_torch.data.mnist_like import digits
from repro_torch.kernels import padding as t_padding
from repro_torch.kernels import threefry as t_threefry
from repro_torch.launch import collective_probe as t_probe
from repro_torch.launch import dryrun as t_dryrun
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.roofline import analysis as t_analysis
from repro_torch.serve.tnn_engine import TNNEngine
from repro_torch.train.tnn_trainer import TNNTrainer
from repro_torch.utils import tracing
from repro_torch.utils.tracing import CollectiveEntry
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

SITES, B, K = tm.SITES, tm.B, tm.K
FACTORS = [f"{d}x{m}" for d, m in tm.FACTORS]


def _np_state(state):
    return {"params": {k: np.array(v) for k, v in state["params"].items()},
            "rng": np.array(state["rng"]), "wave": int(np.asarray(state["wave"]))}


def _same_state(want, got):
    """Two numpy states (the reference's form), every leaf exact."""
    assert sorted(got["params"]) == sorted(want["params"])
    for k in want["params"]:
        np.testing.assert_array_equal(want["params"][k], got["params"][k], err_msg=k)
    np.testing.assert_array_equal(np.asarray(want["rng"]), np.asarray(got["rng"]))
    assert int(got["wave"]) == int(want["wave"])


def _crop(imgs):
    return np.ascontiguousarray(t_tnn_mnist.crop_field(imgs, SITES))


def _serve(eng, images):
    for uid in range(len(images)):
        eng.submit(JRequest(uid=uid, image=images[uid]))
    tables = {eng.version: np.array(eng.vote_table)}
    while eng.pending:
        eng.poll()
        tables[eng.version] = np.array(eng.vote_table)
    return {u: (r.result, r.version) for u, r in eng.done.items()}, tables


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's unmeshed runs of everything the ranks do."""
    d = tmp_path_factory.mktemp("mesh_ref")
    jcfg = j_tnn_mnist.network_config(SITES, 12, 3, impl="direct")
    T = jcfg.layers[0].column.wave.T
    state0 = j_network.init_train_state(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(0).integers(0, T + 1, (K, B, SITES, 32), dtype=np.uint8)
    step = j_network.make_train_step(jcfg, None, donate=False)
    st, zs = state0, []
    for w in range(2):
        st, z = step(st, jnp.asarray(x[w]))
        zs.append(np.array(z))
    sb_state, sb_z = j_network.make_superbatch_step(jcfg, None, donate=False)(
        state0, jnp.asarray(x))
    params0 = j_network.params_from_tree(state0["params"], jcfg)
    lab_imgs, lab_labs = digits(16, seed=1)
    lab_imgs = _crop(lab_imgs)
    req_imgs = _crop(digits(10, seed=2)[0])
    online_imgs = _crop(digits(20, seed=3)[0])
    eng = JEngine(jcfg, list(params0), n_slots=B, impl="direct", superbatch_k=K)
    eng.fit(lab_imgs, lab_labs)
    results, _ = _serve(eng, req_imgs)
    # one wave a dispatch (the ranks drain K = 2): the reference's own tests
    # hold its K-wave drains to K = 1, and one jitted step compiles faster
    oeng = JEngine(jcfg, list(params0), n_slots=B, impl="direct",
                   online_stdp=True, swap_every=2, seed=0)
    oeng.fit(lab_imgs, lab_labs)
    o_results, o_tables = _serve(oeng, online_imgs)
    # the trainer: 4 waves of the seeded stream, then the vote-table pass
    stream = JWaveStream(jcfg, 4 * B, B, seed=1)
    ev = JWaveStream(jcfg, 8, B, seed=2)
    tst = state0
    for w in range(4):
        tst, _ = step(tst, jnp.asarray(stream.batch_at(w)))
    fwd = jax.jit(lambda ps, xx: j_network.network_forward(xx, ps, jcfg)[-1])
    tps = j_network.params_from_tree(tst["params"], jcfg)
    vt = j_network.refresh_vote_table(fwd, tps, stream.x, stream.labels, jcfg, B)
    z_ev = j_network.forward_all_padded(fwd, tps, ev.x, B, T)
    acc = float((np.asarray(j_network.classify(z_ev, vt, T)) == ev.labels).mean())
    jdir = str(d / "jax_ckpt")
    j_ckpt.Checkpointer(jdir).save(
        4, dict(tst, vote_table=vt),
        extra={"arch": "tnn-mnist", "config": j_ckpt.tnn_config_fingerprint(jcfg),
               "wave": 4, "has_vote": True}, block=True)
    arrays = {"x": x, "state0_rng": np.array(state0["rng"]),
              "state0_wave": np.array(state0["wave"]), "lab_imgs": lab_imgs,
              "lab_labs": np.asarray(lab_labs), "req_imgs": req_imgs,
              "online_imgs": online_imgs, "jax_ckpt": np.array(jdir)}
    arrays.update({f"state0.{k}": np.array(v) for k, v in state0["params"].items()})
    np.savez(d / "ref.npz", **arrays)
    return {"dir": d, "npz": str(d / "ref.npz"), "steps": _np_state(st),
            "z": np.stack(zs), "sb": _np_state(sb_state), "sb_z": np.array(sb_z),
            "results": results, "vote_table": np.array(eng.vote_table),
            "online": o_results, "online_tables": o_tables,
            "online_shadow": _np_state(oeng.learn_state), "swaps": oeng.swaps,
            "trainer": _np_state(tst), "trainer_vt": np.array(vt),
            "trainer_acc": acc, "cfg": jcfg}


@pytest.fixture(scope="module")
def ranks(ref):
    """Every rank's results, one start of 4 gloo ranks for all three
    factorizations."""
    out = tm.spawn(ref["dir"] / "ranks", tm.suite, ref["npz"],
                   str(ref["dir"] / "ranks"))
    return out


# ---------------------------------------------------------------------------
# In process: the spec, the windows, the gather, the windowed draw
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_cols,data,model", [(9, 1, 1), (9, 4, 1), (9, 2, 2),
                                               (9, 1, 4), (625, 2, 2), (625, 1, 4),
                                               (640, 1, 4)])
def test_mesh_spec_matches_the_reference(n_cols, data, model):
    jmesh = types.SimpleNamespace(shape={"data": data, "model": model})
    js = j_padding.MeshSpec.from_mesh(jmesh, n_cols)
    windows = []
    for r in range(data * model):
        tmesh = types.SimpleNamespace(n_data=data, n_model=model,
                                      data_index=r // model, model_index=r % model)
        ts = t_padding.MeshSpec.from_mesh(tmesh, n_cols)
        assert (ts.n_data, ts.n_model, ts.n_cols) == (js.n_data, js.n_model, js.n_cols)
        assert (ts.padded_cols, ts.local_cols, ts.site_pad) == (
            js.padded_cols, js.local_cols, js.site_pad)
        windows.append(ts)
    g = np.random.default_rng(n_cols + data)
    x = g.integers(0, 9, (4, n_cols, 3), dtype=np.uint8)
    w = g.integers(0, 8, (n_cols, 3, 2), dtype=np.int8)
    ts = windows[0]
    np.testing.assert_array_equal(
        ts.pad_spike_sites(torch.from_numpy(x), 8, axis=1).numpy(),
        np.asarray(js.pad_spike_sites(jnp.asarray(x), 8, axis=1)))
    np.testing.assert_array_equal(
        ts.pad_weights([torch.from_numpy(w)])[0].numpy(),
        np.asarray(js.pad_weights([jnp.asarray(w)])[0]))
    padded = js.pad_spike_sites(jnp.asarray(x), 8, axis=1)
    np.testing.assert_array_equal(
        ts.slice_sites(torch.from_numpy(np.array(padded)), axis=1).numpy(), x)
    # each rank's window is its slice of the padded global; they gather back
    pieces = [s.local_spikes(torch.from_numpy(x), 8) for s in windows]
    for s, piece in zip(windows, pieces):
        b = 4 // data
        want = np.asarray(padded)[s.data_index * b:(s.data_index + 1) * b,
                                  s.site0:s.site0 + s.local_cols]
        np.testing.assert_array_equal(piece.numpy(), want)
    np.testing.assert_array_equal(ts.assemble(pieces, row_axis=0, site_axis=1).numpy(), x)
    locw = windows[-1].local_weights([torch.from_numpy(w)])[0]
    assert locw.is_contiguous() and locw._base is None


@pytest.fixture(scope="module")
def global_draws():
    """The global (C, 2, B, p, q) draws at 9 sites and B = 4: layer 2's by
    the reference (one jit; layer 1's would take twice its 6 s to compile
    here), layer 1's by the port's plain global draw, which
    ``test_torch_random.py`` holds to ``jax.random`` bit for bit."""
    jcfg = j_tnn_mnist.network_config(SITES, 12, 3)
    key = jax.random.PRNGKey(7)
    l1, l2 = jcfg.layers
    u2 = jax.jit(lambda k: j_layer.layer_uniforms(k, l2, B))(key)
    u1 = t_threefry.layer_uniforms_plain(t_random.as_key(np.asarray(key)), SITES,
                                         (2, B, l1.column.p, l1.column.q))
    return key, jcfg, [u1.numpy(), np.array(u2)]


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("window", [(0, 9, 0, 4), (0, 5, 0, 2), (5, 5, 2, 2),
                                    (6, 3, 1, 2), (9, 3, 0, 4), (8, 4, 3, 1)])
def test_window_draw_is_the_padded_global_draw_sliced(global_draws, layer, window):
    key, jcfg, us = global_draws
    col0, n_local, row0, b_local = window
    padded = np.asarray(j_padding.pad_uniform_sites(
        jnp.asarray(us[layer]), max(SITES, col0 + n_local)))
    want = padded[col0:col0 + n_local, :, row0:row0 + b_local]
    lcfg = jcfg.layers[layer]
    got = t_threefry.window_uniforms(
        t_random.as_key(np.asarray(key)), SITES, B, (lcfg.column.p, lcfg.column.q),
        window, device="cpu")
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_window_launch_signature_matches_the_source():
    text = open(os.path.join(os.path.dirname(t_threefry.__file__), "csrc",
                             "threefry.cu")).read()
    params = re.search(r"int\s+tnn_threefry_window_launch\s*\(([^)]*)\)", text).group(1)
    names = {"float*": "c_void_p", "void*": "c_void_p", "unsigned": "c_uint",
             "int": "c_int", "long long": "c_longlong"}
    want = []
    for p in params.split(","):
        p = " ".join(p.split())
        typ = re.match(r"(.+?)\s*(\*?)\s*\w+$", p)
        want.append(getattr(__import__("ctypes"), names[typ.group(1) + typ.group(2)]))
    assert t_threefry.WINDOW_ARGTYPES == want


# ---------------------------------------------------------------------------
# Ranks: the meshed paths against the unmeshed reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", tm.IMPLS)
@pytest.mark.parametrize("factor", FACTORS)
def test_train_steps_equal_the_unmeshed_reference(ref, ranks, factor, impl):
    for r in ranks:
        got = r[factor][impl]
        _same_state(ref["steps"], got["steps"])
        np.testing.assert_array_equal(got["z"], ref["z"])
        assert got["own"]   # the rank's state tensors are its own, not views


@pytest.mark.parametrize("impl", tm.IMPLS)
@pytest.mark.parametrize("factor", FACTORS)
def test_superbatch_equals_the_unmeshed_reference(ref, ranks, factor, impl):
    got = ranks[0][factor][impl]
    _same_state(ref["sb"], got["sb"])
    np.testing.assert_array_equal(got["sb_z"], ref["sb_z"])


@pytest.mark.parametrize("impl", tm.IMPLS)
def test_counter_form_step_without_a_mesh_equals_the_reference(ref, impl):
    """``network_train_step`` in one process: the reference's train step
    runs it; here the port's runs it twice from state 0."""
    cfg = tm.cfg(impl)
    tree = {"params": {k[7:]: np.load(ref["npz"])[k] for k in
                       ("state0.layer_00", "state0.layer_01")},
            "rng": np.load(ref["npz"])["state0_rng"], "wave": 0}
    state = convert.state_from_numpy(tree, cfg, "cpu")
    params = t_network.params_from_tree(state["params"], cfg)
    key, zs = state["rng"], []
    x = np.load(ref["npz"])["x"]
    for w in range(2):
        key, sub = t_random.split(key)
        outs, params = t_network.network_train_step(torch.from_numpy(x[w]), params,
                                                    cfg, sub)
        zs.append(outs[-1].numpy())
    got = {"params": {f"layer_{i:02d}": p.numpy() for i, p in enumerate(params)},
           "rng": key.numpy(), "wave": 2}
    _same_state(ref["steps"], got)
    np.testing.assert_array_equal(np.stack(zs), ref["z"])


@pytest.mark.parametrize("impl", ["pallas", "fused"])
@pytest.mark.parametrize("factor", ["2x2", "1x4"])
def test_colpar_cell_equals_the_unmeshed_wave(ranks, factor, impl):
    """The dry run's column-parallel cell on a process mesh (9 sites, 4
    images) against the same cell's unmeshed wave, which
    ``test_torch_dryrun.py`` holds to the reference's."""
    o = {}
    res = t_dryrun.run_tnn_cell("tnn_train_8k", impl=impl, sites=SITES, batch=B,
                                device="cpu", outputs=o, verbose=False)
    assert res["status"] == "ok"
    got = ranks[0][factor]["colpar"][impl]
    assert got["mesh"] == factor
    for a, b in zip(got["zs"], o["zs"]):
        np.testing.assert_array_equal(a, b.numpy())
    for a, b in zip(got["new_params"], o["new_params"]):
        np.testing.assert_array_equal(a, b.numpy())
    d = int(factor[0])
    assert (got["collectives"]["all-reduce"] > 0) == (d > 1)


@pytest.mark.parametrize("factor", ["2x2", "1x4"])
def test_engine_equals_the_unmeshed_reference(ref, ranks, factor):
    for r in ranks:
        got = r[factor]["engine"]
        np.testing.assert_array_equal(got["vote_table"], ref["vote_table"])
        assert {u: c for u, (c, _) in got["results"].items()} == \
            {u: c for u, (c, _) in ref["results"].items()}
        assert got["stats"] == ranks[0][factor]["engine"]["stats"]   # rank 0's clock


def test_online_hot_swaps_equal_the_unmeshed_reference(ref, ranks):
    for r in ranks:
        got = r["2x2"]["online"]
        assert got["results"] == ref["online"]
        assert got["swaps"] == ref["swaps"] >= 2
        assert sorted(got["tables"]) == sorted(ref["online_tables"])
        for v, t in ref["online_tables"].items():
            np.testing.assert_array_equal(got["tables"][v], t)
        _same_state(ref["online_shadow"], got["shadow"])


def test_trainer_equals_the_unmeshed_reference(ref, ranks):
    got = ranks[0]["2x2"]["trainer"]
    _same_state(ref["trainer"], got["state"])
    np.testing.assert_array_equal(got["vote_table"], ref["trainer_vt"])
    assert got["accuracy"] == ref["trainer_acc"]


def test_checkpoint_from_2x2_restores_under_1x4_and_unmeshed(ref, ranks):
    for r in ranks:
        got = r["1x4"]["restored"]
        assert got["wave"] == 4
        _same_state(ref["trainer"], got["state"])
        np.testing.assert_array_equal(got["vote_table"], ref["trainer_vt"])
    cfg = tm.cfg()
    state, extra = restore_tnn(Checkpointer(str(ref["dir"] / "ranks" / "ckpt22")),
                               cfg, device="cpu")
    _same_state(ref["trainer"], convert.state_to_numpy(state))
    jstate, _ = j_ckpt.restore_tnn(
        j_ckpt.Checkpointer(str(ref["dir"] / "ranks" / "ckpt22")), ref["cfg"])
    _same_state(ref["trainer"], _np_state(jstate))


def test_jax_checkpoint_restores_under_2x2(ref, ranks):
    got = ranks[0]["2x2"]["jax_ckpt"]
    for i, w in enumerate(got["params"]):
        np.testing.assert_array_equal(w, ref["trainer"]["params"][f"layer_{i:02d}"])
    np.testing.assert_array_equal(got["vote_table"], ref["trainer_vt"])


def test_launchers_on_a_2x2_mesh_equal_one_process(ref, ranks, tmp_path):
    got = ranks[0]["2x2"]["launchers"]
    srv = t_serve.main(tm.SERVE_ARGS)
    assert got["serve"]["results"] == srv.results
    for a, b in zip(got["serve"]["params"], srv.params):
        np.testing.assert_array_equal(a, b.numpy())
    np.testing.assert_array_equal(got["serve"]["vote_table"], srv.vote_table.numpy())
    tr = t_train.main(tm.TRAIN_ARGS + ["--ckpt-dir", str(tmp_path / "one")])
    _same_state(convert.state_to_numpy(tr["trainer"].state), got["train"])


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["2", "2x", "x2", "2x2x2", "0x4", "axb"])
def test_parse_mesh_refuses_as_the_reference(spec):
    with pytest.raises(ValueError) as want:
        j_mesh.parse_mesh(spec)
    with pytest.raises(ValueError) as got:
        t_mesh.parse_mesh(spec)
    assert str(got.value) == str(want.value)


def test_refusals(capsys):
    assert t_mesh.parse_mesh(" 2X2 ") == j_mesh.parse_mesh(" 2X2 ") == (2, 2)
    fake = types.SimpleNamespace(n_data=2, n_model=2, data_index=0, model_index=0,
                                 device=torch.device("cpu"))
    hetero = t_tnn_mnist.network_config(9)
    hetero = hetero.__class__(layers=(hetero.layers[0], hetero.layers[1].__class__(
        4, hetero.layers[1].column)))
    with pytest.raises(ValueError, match="one site count across the cascade"):
        t_network.network_mesh_spec(hetero, fake)
    cfg = tm.cfg()
    params = t_network.init_network(t_random.PRNGKey(0), cfg, "cpu")
    with pytest.raises(ValueError, match="n_slots=3 not divisible by data axis size 2"):
        TNNEngine(cfg, params, n_slots=3, device="cpu", mesh=fake)
    tcfg = t_tnn_mnist.train_config(sites=SITES, wave_batch=3)
    with pytest.raises(ValueError, match="wave_batch=3 not divisible by data axis size 2"):
        TNNTrainer(cfg, tcfg, device="cpu", mesh=fake)
    with pytest.raises(ValueError, match="not divisible by data axis size 2"):
        t_network.network_mesh_spec(cfg, fake).local_spikes(torch.zeros(3, 9, 32), 8)
    with pytest.raises(ValueError, match="backend='gloo'"):   # NCCL: one card a rank
        t_mesh.make_mesh_2d(2, 2, device="cuda", backend="nccl")
    with pytest.raises(ValueError, match="nccl"):
        t_mesh.make_mesh_2d(1, 1, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="must be >= 1"):
        t_mesh.make_mesh_2d(0, 2, device="cpu")
    assert t_serve.resolve_slots(7, 4) == 8 and t_serve.resolve_slots(8, 4) == 8
    with pytest.raises(SystemExit) as e:   # the LM half exists; this arch does not
        t_probe.main(["--arch", "llama3-8b"])
    assert e.value.code == 2 and "unknown arch" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# Collectives: the recorder, the ring model, the probe's report
# ---------------------------------------------------------------------------

_HLO_TYPES = {v: k for k, v in t_analysis.HLO_DTYPES.items()}


def _hlo(entries):
    """The entries as HLO instruction lines the reference parses."""
    lines = []
    for i, e in enumerate(entries):
        dims = ",".join(str(d) for d in e.shape)
        group = ",".join(str(r) for r in range(e.group))
        lines.append(f"  %{e.kind}.{i} = {t_analysis.HLO_DTYPES[e.dtype]}[{dims}]"
                     f"{{0}} {e.kind}(%x), replica_groups={{{{{group}}}}}")
    return "\n".join(lines)


def _synthetic():
    return [CollectiveEntry("all-reduce", torch.int32, (9, 32, 12), 2),
            CollectiveEntry("all-gather", torch.uint8, (4, 1, 3, 10), 4),
            CollectiveEntry("all-gather", torch.int8, (4, 3, 12, 10), 4),
            CollectiveEntry("all-reduce", torch.int32, (5, 12, 10), 1)]


@pytest.mark.parametrize("n_data,issued", [(1, 0), (2, 1)])
def test_all_reduce_over_a_group_of_one_is_recorded_not_issued(monkeypatch, n_data,
                                                               issued):
    """A sum over one rank is the tensor itself: the recorder still notes
    it (as the reference's HLO holds it), but no collective is issued."""
    calls = []
    monkeypatch.setattr(t_mesh.dist, "all_reduce",
                        lambda t, op=None, group=None: calls.append(group))
    mesh = t_mesh.Mesh2D(n_data=n_data, n_model=2, rank=0, backend="gloo",
                         device=torch.device("cpu"), data_group="data",
                         model_group="model", world_group="world")
    t = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    with tracing.collectives_recorded() as entries:
        out = mesh.all_reduce_sum(t, "data")
    assert out is t and torch.equal(t, torch.arange(6, dtype=torch.int32).reshape(2, 3))
    assert entries == [CollectiveEntry("all-reduce", torch.int32, (2, 3), n_data)]
    assert calls == ["data"] * issued


@pytest.mark.parametrize("factor", FACTORS)
def test_recorded_collectives_and_wire_bytes_match_parse_collectives(ranks, factor):
    entries = ranks[0][factor]["fused"]["entries"]
    d, m = (int(v) for v in factor.split("x"))
    # two waves: one int32 all-reduce per layer over the data axis, and the
    # two z gathers over the world
    reduces = [e for e in entries if e.kind == "all-reduce"]
    assert [(e.dtype, e.group) for e in reduces] == [(torch.int32, d)] * 4
    local = -(-SITES // m)
    assert [e.shape for e in reduces[:2]] == [(local, 32, 12), (local, 12, 10)]
    for ents in (entries, _synthetic()):
        want = j_analysis.parse_collectives(_hlo(ents), default_group=4)
        got = t_analysis.collective_stats(ents)
        for kind in j_analysis._COLLECTIVES:
            assert got.bytes_by_kind[kind] == want.bytes_by_kind[kind], kind
            assert got.count_by_kind[kind] == want.count_by_kind[kind], kind
        assert got.total_bytes == want.total_bytes


def test_probe_on_a_2x2_mesh_reports_the_counter_all_reduces(ranks):
    """The probe's dispatch (fused, K = 4 waves of 8) on the ranks: the
    model axis issues nothing, the data axis one int32 all-reduce a layer
    a wave, of the rank's 5 local sites."""
    lines = ranks[0]["2x2"]["probe"]
    assert lines[0] == "tnn-mnist 9+9 sites, impl=fused, K=4 x batch 8 on mesh 2x2"
    assert lines[2:4] == ["     0.000 GB  x4   all-reduce s32[5,32,12] g=2",
                          "     0.000 GB  x4   all-reduce s32[5,12,10] g=2"]
    assert lines[-1] == "by kind: {'all-reduce': 40320}"


def test_probe_report_is_the_reference_format():
    ents = _synthetic()
    buf = io.StringIO()
    with redirect_stdout(buf):
        j_probe._print_top(_hlo(ents), 4, 15, "mesh 2x2, K=4")
    got = t_probe.top_lines(ents, 15, "mesh 2x2, K=4")
    want = buf.getvalue().splitlines()
    # the reference keys lines by kind, type and shape; the last line lists
    # the kinds with bytes (the port's adds none the reference lacks here)
    assert got[:-1] == [re.sub(r"\s+$", "", w) for w in want[:-1]]
    assert got[-1] == want[-1]
