"""The port's flagship-run pieces against the JAX package: the winner-bit
centroid readout (``winner_bits``, ``build_centroids``,
``classify_centroid``), the 7 nm PPA model (``core.hwmodel`` and
``core.macros``: every table report equal, exactly) and the loadgen
helpers (``poisson_arrivals`` and ``ab_accuracy`` equal to
``tools/loadgen.py``'s); then the port's loadgen and flagship entry points
on the CPU at a few sites."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hwmodel as j_hw
from repro.core import macros as j_macros
from repro.core import network as j_network

from repro_torch.core import hwmodel as t_hw
from repro_torch.core import macros as t_macros
from repro_torch.core import network as t_network
from repro_torch.launch import loadgen as t_loadgen
from repro_torch.launch import tnn_mnist as t_flagship
from repro_torch.serve.tnn_engine import ClassifyRequest
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 8


def _ref_loadgen():
    tools = os.path.join(ROOT, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import loadgen
    return loadgen


@pytest.fixture(scope="module")
def readout():
    """Post-WTA spike times of two batches at 16 sites (a labelled one with
    every class and a test one), the labels, and the reference's centroid
    readout of them under one jit."""
    rng = np.random.default_rng(5)
    z_lab = rng.integers(0, T + 1, (48, 16, 10)).astype(np.uint8)
    z_lab[rng.random(z_lab.shape) < 0.6] = T  # mostly silent, as after a WTA
    z_test = rng.integers(0, T + 1, (40, 16, 10)).astype(np.uint8)
    z_test[rng.random(z_test.shape) < 0.6] = T
    labels = np.concatenate([np.arange(10), rng.integers(0, 10, 38)]).astype(np.int32)

    @jax.jit
    def reference(zl, zt, lab):
        cents = j_network.build_centroids(zl, lab, 10, T)
        bits = j_network.winner_bits(zt, T).astype(jnp.float32)
        d = jnp.square(bits[:, None, :] - cents[None]).sum(-1)
        return (j_network.winner_bits(zt, T), cents, d,
                j_network.classify_centroid(zt, cents, T))

    out = [np.asarray(a) for a in reference(z_lab, z_test, labels)]
    return z_lab, z_test, labels, out


def test_centroid_readout_matches_reference(readout):
    """Winner bits and centroids exactly; the distances to 1e-6 (their f32
    sums run in each library's own order) and the class ids on every row
    whose two nearest centroids lie farther apart than that (all 40 with
    this seed)."""
    z_lab, z_test, labels, (bits_j, cents_j, d_j, cls_j) = readout
    zl, zt = torch.from_numpy(z_lab), torch.from_numpy(z_test)
    bits = t_network.winner_bits(zt, T)
    assert bits.dtype == torch.bool and tuple(bits.shape) == (40, 160)
    np.testing.assert_array_equal(bits_j, bits.numpy())
    cents = t_network.build_centroids(zl, torch.from_numpy(labels), 10, T)
    assert cents.dtype == torch.float32
    np.testing.assert_array_equal(cents_j, cents.numpy())
    got = t_network.classify_centroid(zt, cents, T).numpy()
    d = np.sort(d_j, axis=-1)
    clear = (d[:, 1] - d[:, 0]) > 1e-6 * d[:, 1]
    assert clear.sum() == 40
    np.testing.assert_array_equal(cls_j[clear], got[clear])
    assert len(set(got.tolist())) > 3
    # an empty class keeps a zero centroid (count clamped to 1)
    few = t_network.build_centroids(zl[:3], torch.tensor([0, 0, 2]), 4, T)
    assert not few[1].any() and not few[3].any()
    np.testing.assert_array_equal(
        np.asarray(j_network.build_centroids(z_lab[:3], np.array([0, 0, 2]), 4, T)),
        few.numpy())


def test_ppa_tables_equal_the_reference():
    assert t_hw.table1_report() == j_hw.table1_report()
    assert t_hw.table2_report() == j_hw.table2_report()
    assert t_hw.improvement_report() == j_hw.improvement_report()
    for lib in t_hw.LIBRARIES:
        assert dataclasses.astuple(t_hw.prototype_ppa(lib)) == \
            dataclasses.astuple(j_hw.prototype_ppa(lib))
        for p, q in ((32, 12), (12, 10), (1024, 16)):
            assert dataclasses.astuple(t_hw.column_ppa(p, q, lib)) == \
                dataclasses.astuple(j_hw.column_ppa(p, q, lib))
        assert t_hw.network_transistors(t_hw.PROTOTYPE_LAYERS, lib) == \
            j_hw.network_transistors(j_hw.PROTOTYPE_LAYERS, lib)
    assert [(m.name, m.t_std, m.t_custom, m.count(32, 12)) for m in t_macros.MACROS] == \
        [(m.name, m.t_std, m.t_custom, m.count(32, 12)) for m in j_macros.MACROS]
    table2 = {r["library"]: r for r in t_hw.table2_report()}
    assert table2["custom"]["area_mm2_model"] == pytest.approx(1.56, rel=1e-9)
    assert table2["custom"]["power_mw_model"] == pytest.approx(1.69, rel=1e-9)
    with pytest.raises(ValueError):
        t_hw.column_ppa(64, 8, "bogus")
    lines = t_flagship.ppa_lines()
    assert lines[0].startswith("7nm standard: 2.54 mW") and "1.56 mm2" in lines[1]


@pytest.mark.parametrize("rate,duration,seed", [(200.0, 2.0, 0), (3.5, 10.0, 7),
                                                (1000.0, 0.05, 3)])
def test_poisson_arrivals_equal_the_reference(rate, duration, seed):
    want = _ref_loadgen().poisson_arrivals(rate, duration, seed=seed)
    got = t_loadgen.poisson_arrivals(rate, duration, seed=seed)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(want, got)
    with pytest.raises(ValueError):
        t_loadgen.poisson_arrivals(0.0, 1.0)


def test_ab_accuracy_equals_the_reference():
    from repro.serve.tnn_engine import ClassifyRequest as JRequest

    rng = np.random.default_rng(1)
    labels = rng.integers(0, 10, 13)
    rows = [(uid, int(rng.integers(0, 10)), int(rng.integers(0, 3)),
             float(rng.integers(0, 6))) for uid in range(40)]

    def done(cls):
        out = {}
        for uid, result, ver, t in rows:
            out[uid] = cls(uid=uid, image=None, result=result, version=ver)
            out[uid].t_done = t
        return out

    ref = _ref_loadgen()
    for window in (0, 1, 7, 40, 100):
        assert t_loadgen.ab_accuracy(done(ClassifyRequest), labels, window) == \
            ref.ab_accuracy(done(JRequest), labels, window)


def test_loadgen_runs_on_cpu(capsys):
    """Closed and open loop, online with swaps, at 4 sites: every request
    served once, versions never decrease along the retire order."""
    out = t_loadgen.main(["--mode", "closed", "--requests", "40", "--sites", "4",
                          "--slots", "4", "--online-stdp", "--swap-every", "2",
                          "--device", "cpu"])
    eng = out["engine"]
    assert out["stats"].requests == 40 and sorted(eng.done) == list(range(40))
    assert eng.swaps >= 4 and set(out["ab"]) <= set(range(eng.version + 1))
    order = sorted(eng.done.values(), key=lambda r: (r.t_done, r.uid))
    assert all(a.version <= b.version for a, b in zip(order, order[1:]))
    eng.reset()
    st = t_loadgen.run_open_loop(eng, t_loadgen.labelled_images(4, 8)[0],
                                 t_loadgen.poisson_arrivals(400.0, 0.05, seed=1))
    assert st.requests == len(eng.done) > 0
    text = capsys.readouterr().out
    assert "[loadgen closed/pipelined]" in text and "[loadgen ab]" in text
    assert t_loadgen.parse_args([]).device == "cuda"


def test_flagship_cli():
    args = t_flagship.parse_args([])
    assert (args.train, args.test, args.waves, args.wave_batch) == (512, 256, 60, 16)
    assert (args.theta1, args.theta2, args.impl, args.device) == (12, 3, "direct", "cuda")
