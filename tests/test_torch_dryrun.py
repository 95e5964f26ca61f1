"""The port's roofline model and the TNN half of the dry run against the
JAX package: ``Roofline.report()`` equals the reference's on the same
counts and profile numbers; ``run_tnn_cell`` on the CPU, cut to 4 sites and
a few images, returns the reference's result fields and its wave equals the
reference's ``network_train_wave`` / ``network_forward`` on the same
inputs; the launcher writes the reference's file names; and the variants
of the reference's production meshes, or an LM architecture, are refused."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import network as j_network
from repro.launch.dryrun import _tnn_variant_cfg as j_variant_cfg
from repro.roofline import analysis as j_rl

from repro_torch.launch import dryrun as t_dryrun
from repro_torch.roofline import analysis as t_rl
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

SITES, BATCH = 4, 8
REFERENCE_FIELDS = ("arch", "cell", "mesh", "column_parallel", "impl", "gauss",
                    "status", "compile_s", "roofline", "collectives", "memory")


@pytest.mark.parametrize("flops,nbytes,coll,model", [
    (2.6e13, 4.2e10, 0.0, 6.2e10),      # compute-bound (a sum learning wave)
    (2.3e11, 2.2e9, 0.0, 3.3e11),       # memory-bound (the forward cell)
    (1e9, 1e6, 5e9, 1e9),               # collective-bound
    (0.0, 0.0, 0.0, 0.0),               # nothing: the fractions' zero guards
])
def test_roofline_report_matches_reference(flops, nbytes, coll, model):
    prof = t_rl.H100_SXM
    j_prof = j_rl.MachineProfile(prof.name, prof.peak_flops, prof.hbm_bw, prof.ici_bw)
    want = j_rl.Roofline(flops=flops, bytes_accessed=nbytes, collective_bytes=coll,
                         model_flops=model, collectives={}, profile=j_prof).report()
    got = t_rl.from_counts(flops, nbytes, model, collective_bytes=coll).report()
    assert got == want
    assert got["profile"] == "h100-sxm"
    assert t_rl.PROFILES["h100-sxm"] is t_rl.Roofline(0, 0, 0, 0, {}).profile


def test_work_bounds_price_each_unit():
    """A Work's bound is the larger of its bytes over 3.35 TB/s and its
    operations each at its unit's rate, and its peak-rate operations give
    a Roofline the same compute time."""
    w = t_rl.threefry_work(10_000_000) + t_rl.stdp_work(625, 16, 32, 12)
    ms, by, bytes_ms = w.bound()
    assert by == "operations" and ms == pytest.approx(w.ops_ms)
    assert bytes_ms == pytest.approx(1e3 * w.bytes / 3.35e12)
    assert t_rl.from_counts(w.peak_ops(), w.bytes, 0).t_compute == pytest.approx(
        w.ops_ms / 1e3)


@pytest.mark.parametrize("cell,impl", [("tnn_infer_64k", "pallas"),
                                       ("tnn_train_8k", "fused")])
def test_run_tnn_cell_matches_reference(cell, impl):
    out = {}
    res = t_dryrun.run_tnn_cell(cell, impl=impl, sites=SITES, batch=BATCH,
                                device="cpu", verbose=False, outputs=out)
    assert res["status"] == "ok", res.get("traceback")
    for k in REFERENCE_FIELDS:
        assert k in res
    assert res["mesh"] == "1" and res["roofline"]["profile"] == "h100-sxm"
    assert res["wave_ms"] > 0 and res["batch"] == BATCH
    assert set(res["memory"]) >= {"temp_size_in_bytes", "max_memory_allocated"}
    kind = t_dryrun.TNN_CELLS[cell][0]
    jcfg = j_variant_cfg(j_network.prototype_config(sites=SITES, theta1=20, theta2=6),
                         "direct", False)
    x = jnp.asarray(out["x"].numpy())
    ps = [jnp.asarray(w.numpy()) for w in out["params"]]
    if kind == "train":
        key = jnp.asarray(out["key"].numpy())
        zs, ws = jax.jit(lambda x_, p, k: j_network.network_train_wave(x_, p, jcfg, k))(
            x, ps, key)
        for a, b in zip(ws, out["new_params"]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    else:
        zs = jax.jit(lambda x_, p: j_network.network_forward(x_, p, jcfg))(x, ps)
    for a, b in zip(zs, out["zs"]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    flops = t_dryrun.model_flops(t_dryrun._tnn_variant_cfg(
        t_dryrun.prototype_config(sites=SITES, theta1=20, theta2=6), impl, False),
        kind, BATCH)
    per_img = SITES * (32 * 12 + 12 * 10) * 16 * (1.5 if kind == "train" else 1)
    assert res["roofline"]["model_flops_per_chip"] == flops == per_img * BATCH


def test_dryrun_writes_the_reference_file_names(tmp_path):
    rc = t_dryrun.main(["--arch", "tnn-mnist", "--device", "cpu", "--sites",
                        str(SITES), "--batch", str(BATCH), "--out", str(tmp_path)])
    assert rc == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted(
        f"tnn-mnist__{c}{s}__1.json" for c, s in (
            ("tnn_train_8k", "_pallas"), ("tnn_train_8k", "_fused"),
            ("tnn_train_8k", "_pallas_gauss"), ("tnn_train_8k", "_fused_gauss"),
            ("tnn_infer_64k", "_pallas"), ("tnn_infer_64k", "_fused")))
    res = json.loads((tmp_path / "tnn-mnist__tnn_train_8k_fused_gauss__1.json").read_text())
    assert res["status"] == "ok" and res["gauss"] and res["impl"] == "fused"
    assert res["launches"]["tnn_wave[learn]"] == 0


def test_dryrun_refusals(capsys):
    """The production meshes need 256 and 512 cards for the TNN cells; the
    column-parallel variant runs on a process mesh (``run_tnn_colpar_cell``,
    under torchrun); an arch the registry lacks is refused as unknown (the
    LM rows are ``tests/test_torch_lm_dryrun.py``'s)."""
    with pytest.raises(ValueError, match="256 cards.*512"):
        t_dryrun.run_tnn_cell("tnn_train_8k", device="cpu", multi_pod=True)
    with pytest.raises(ValueError, match="process mesh"):
        t_dryrun.run_tnn_cell("tnn_train_8k", device="cpu", column_parallel=True)
    with pytest.raises(ValueError, match="learning wave"):
        t_dryrun.run_tnn_cell("tnn_infer_64k", gauss=True, device="cpu")
    for argv, words in ((["--arch", "llama3-8b"], "unknown arch"),
                        (["--mesh", "multi"], "256 cards"),
                        (["--mesh", "both"], "512"),
                        (["--colpar"], "torchrun")):
        with pytest.raises(SystemExit) as e:
            t_dryrun.main(argv + ["--device", "cpu"])
        assert e.value.code == 2
        assert words in capsys.readouterr().err


def test_plain_backends_estimate_their_intermediates():
    """The estimate behind a documented skip grows with the batch and puts
    the full forward cell's plain backends and the learning cell's
    "matmul" over a card's 80 GB (its "direct" wave, at about 63 GB of STDP
    planes, fits)."""
    cfg = t_dryrun.prototype_config(sites=625, theta1=20, theta2=6)
    small = t_dryrun.plain_peak_bytes(cfg, "train", 16, "direct", False)
    full = t_dryrun.plain_peak_bytes(cfg, "train", 8192, "direct", False)
    assert full == 512 * small == 32 * 625 * 8192 * 32 * 12
    assert t_dryrun.plain_peak_bytes(cfg, "train", 8192, "direct", True) < full
    for impl in ("direct", "matmul"):
        assert t_dryrun.plain_peak_bytes(cfg, "infer", 65536, impl, False) > 80e9
    for gauss in (False, True):
        assert t_dryrun.plain_peak_bytes(cfg, "train", 8192, "matmul", gauss) > 80e9
