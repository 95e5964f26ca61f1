"""The wave kernel's launch autotuner (``repro_torch.kernels.autotune``) and
the geometry key it is looked up by: the key equals the reference's
``repro.kernels.padding.plan_geometry_key`` letter for letter; the lookup
takes an exact match or nothing, ignores entries outside the candidate sets,
follows its own environment variable and reloads a changed file;
``network_plan`` carries a tuned entry, keeps the static rule without one
and is bypassed by an explicit argument; the checked-in cache covers every
default geometry and names the card it was tuned on. The tuning itself runs
only on the card (``chip_smoke.py`` holds every candidate bit-equal there)."""
import dataclasses
import json
import os

import pytest

from repro.configs import tnn_mnist as j_tnn
from repro.core import network as j_network
from repro.kernels import padding as j_padding

from repro_torch.configs import tnn_mnist as t_tnn
from repro_torch.core import network as t_network
from repro_torch.kernels import autotune
from repro_torch.kernels import padding as t_padding
from repro_torch.kernels.tnn_column import tile_units
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def _pairs():
    """The default geometries, each as (reference cfg, port cfg, batch): the
    reference's four and the port's three."""
    out = []
    for sites, batch in ((16, 8), (625, 16)):
        t1, t2 = j_tnn.default_thetas(sites)
        out.append((j_tnn.network_config(sites, t1, t2, impl="fused"),
                    t_tnn.network_config(sites, t1, t2, impl="fused"), batch))
        out.append((j_tnn.deep_config(sites, impl="fused"),
                    t_tnn.deep_config(sites, impl="fused"), batch))
    for batch in (8, 64):
        out.append((j_tnn.launcher_network_config(625, impl="fused"),
                    t_tnn.launcher_network_config(625, impl="fused"), batch))
    out.append((j_network.with_impl(j_network.prototype_config(sites=625, theta1=20,
                                                               theta2=6), "fused"),
                t_network.with_impl(t_network.prototype_config(sites=625, theta1=20,
                                                               theta2=6), "fused"), 65536))
    return out


PAIRS = _pairs()


def test_default_geometries_are_the_six():
    got = [t_padding.plan_geometry_key(c, b) for c, b in autotune.default_geometries()]
    assert got == [t_padding.plan_geometry_key(t, b) for _, t, b in PAIRS]
    assert len(set(got)) == 7


@pytest.mark.parametrize("n_cols", [None, 313])
@pytest.mark.parametrize("i", range(len(PAIRS)))
def test_geometry_key_is_the_references(i, n_cols):
    """Letter for letter, and with a meshed local site count."""
    jc, tc, batch = PAIRS[i]
    want = j_padding.plan_geometry_key(jc, batch, n_cols)
    assert t_padding.plan_geometry_key(tc, batch, n_cols) == want
    assert t_padding.plan_geometry_key(
        t_network.with_impl(tc, "direct"), batch, n_cols) == want   # impl is not in it


def test_candidates():
    assert autotune.row_candidates(8) == (2, 4, 8, 16, 32, 64)
    assert autotune.row_candidates(2) == (8, 16, 32, 64, 128, 256)
    assert autotune.row_candidates(128) == (1, 2, 4)
    # rows stop at the first chunk that holds the batch; warps at the tile units
    assert autotune.candidates(8, 8) == [(2, 1), (4, 1), (4, 2), (8, 1), (8, 2), (8, 4)]
    assert len(autotune.candidates(8, 65536)) == 18
    assert all(w <= max(1, tile_units(r, 8)) for r, w in autotune.candidates(8, 100))


KEY = "C16_p32x12_q12x10_T8_B8_packed1"


def _write(path, geoms, device=None):
    with open(path, "w") as f:
        json.dump({"device": device or {}, "geometries": geoms}, f)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "tuned.json"
    monkeypatch.setenv("REPRO_TORCH_TUNED_BLOCKS", str(path))
    t_padding.network_plan.cache_clear()
    yield path
    t_padding.network_plan.cache_clear()


def test_lookup_rules(cache):
    assert autotune.cache_path() == cache
    assert autotune.lookup(KEY) is None                      # no file: static
    _write(cache, {KEY: {"rows": 4, "warps": 2},
                   "C16_p32x12_q12x10_T8_B16_packed1": {"rows": 6, "warps": 2},
                   "C16_p32x12_q12x10_T8_B32_packed1": {"rows": 4, "warps": 3},
                   "C16_p32x12_q12x10_T8_B64_packed1": {"rows": 128, "warps": 1}})
    assert autotune.lookup(KEY) == (4, 2)                    # exact hit
    assert autotune.lookup(KEY.replace("B8", "B9")) is None  # a miss: no nearest guess
    for b in (16, 32, 64):                                   # outside the candidates
        assert autotune.lookup(KEY.replace("B8", f"B{b}")) is None
    assert autotune.load_cache()[KEY]["rows"] == 4
    # a changed file is read again (the mtime keys the loader's cache)
    _write(cache, {KEY: {"rows": 8, "warps": 4}})
    os.utime(cache, (1e9, 1e9 + 7))
    assert autotune.lookup(KEY) == (8, 4)


def test_check_cache_counts_missing(cache, capsys):
    keys = [t_padding.plan_geometry_key(c, b) for c, b in autotune.default_geometries()]
    _write(cache, {k: {"rows": 2, "warps": 1} for k in keys[:4]})
    assert autotune.check_cache(verbose=True) == len(keys) - 4
    assert capsys.readouterr().out.count("MISSING") == len(keys) - 4
    assert autotune.main(["--check"]) == 1


def test_network_plan_carries_the_tuned_launch(cache):
    cfg = t_tnn.network_config(16, 12, 3, impl="fused")
    assert t_padding.plan_geometry_key(cfg, 8) == KEY
    assert t_padding.network_plan(cfg, 8).launch is None      # no entry: static rule
    t_padding.network_plan.cache_clear()
    _write(cache, {KEY: {"rows": 4, "warps": 2}})
    plan = t_padding.network_plan(cfg, 8)
    assert plan.launch == (4, 2)
    assert t_padding.network_plan(cfg, 8, n_cols=9).launch is None   # another key
    # an explicit argument bypasses the cache
    assert t_padding.network_plan(cfg, 8, launch=t_padding.STATIC).launch is None
    assert t_padding.network_plan(cfg, 8, launch=(16, 8)).launch == (16, 8)
    # the rest of the plan is the static one's
    static = t_padding.network_plan(cfg, 8, launch=t_padding.STATIC)
    assert plan == dataclasses.replace(static, launch=(4, 2))


def test_checked_in_cache_is_fresh(monkeypatch, capsys):
    """The cache in the package has every default geometry, each inside the
    candidate sets, and names the NVIDIA card and power limit it was tuned on."""
    monkeypatch.delenv("REPRO_TORCH_TUNED_BLOCKS", raising=False)
    path = autotune.cache_path()
    assert path.name == "tuned_blocks.json" and path.parent.name == "kernels"
    assert autotune.main(["--check"]) == 0
    assert "OK" in capsys.readouterr().out
    dev = autotune.cache_device()
    assert dev["name"].startswith("NVIDIA") and dev["power_limit"].endswith("W")
    assert dev["nvidia_smi"] == f"{dev['name']}, {dev['power_limit']}"
    for key, e in autotune.load_cache().items():
        assert e["ms_per_wave"] > 0 and e["static_ms_per_wave"] > 0, key
