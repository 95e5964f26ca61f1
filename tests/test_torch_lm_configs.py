"""The port's architecture registry against the JAX package's: all ten
configs field for field with the same analytic parameter counts, the smoke
configs, the shape grid and its applicability."""
import dataclasses

import pytest

import repro.configs as j_configs
from repro.configs import base as j_base

import repro_torch.configs as t_configs
from repro_torch.configs import base as t_base
from repro_torch.roofline import analysis as t_rl
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_registry_names_and_order():
    assert t_configs.ARCHS == j_configs.ARCHS
    assert len(t_configs.ARCHS) == 10
    with pytest.raises(KeyError, match="tnn-mnist"):
        t_configs.get_config("gpt-2")


@pytest.mark.parametrize("arch", j_configs.ARCHS)
def test_config_field_for_field(arch):
    got, want = t_configs.get_config(arch), j_configs.get_config(arch)
    assert _fields(got) == _fields(want)
    assert got.layer_kinds == want.layer_kinds
    assert got.is_subquadratic == want.is_subquadratic
    assert got.n_params() == want.n_params()
    assert got.n_active_params() == want.n_active_params()


@pytest.mark.parametrize("arch", j_configs.ARCHS)
def test_smoke_config_field_for_field(arch):
    got, want = t_configs.smoke_config(arch), j_configs.smoke_config(arch)
    assert _fields(got) == _fields(want)
    assert got.n_params() == want.n_params()


def test_llama_full_size():
    cfg = t_configs.get_config("llama3.2-3b")
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size) == (28, 3072, 128256)
    assert cfg.n_params() == 3_606_749_184


def test_shape_grid_and_applicability():
    assert [dataclasses.astuple(c) for c in t_base.SHAPE_GRID] == \
        [dataclasses.astuple(c) for c in j_base.SHAPE_GRID]
    for cell in t_base.SHAPE_GRID:
        assert dataclasses.astuple(t_base.cell_by_name(cell.name)) == \
            dataclasses.astuple(j_base.cell_by_name(cell.name))
        for arch in t_configs.ARCHS:
            got = t_base.cell_applicable(t_configs.get_config(arch), cell)
            want = j_base.cell_applicable(j_configs.get_config(arch),
                                          j_base.cell_by_name(cell.name))
            assert got == want, (arch, cell.name)
    with pytest.raises(KeyError):
        t_base.cell_by_name("train_1m")


def test_decode_bound_counts_weights_gathered_rows_and_cache():
    """llama3.2-3b's decode step at 4 rows of 100 cached positions: every
    weight but the embedding once in bf16, 4 embedding rows, the valid
    cache (28 layers x K and V x 8 heads x 128 x 2 bytes a position, the
    new one written too) and the logits; about 6.44 GB, 1.92 ms at
    3.35 TB/s."""
    cfg = t_configs.get_config("llama3.2-3b")
    nbytes, ops = t_rl.lm_decode_work(cfg, [100] * 4)
    per_pos = 28 * 2 * 8 * 128 * 2
    assert t_rl.lm_cache_bytes_per_position(cfg) == per_pos
    want = 2 * (3_606_749_184 - 128256 * 3072) + 2 * 4 * 3072 + per_pos * 404 + 2 * 4 * 128256
    assert nbytes == want
    ms, by, _ = t_rl.lm_decode_bound(cfg, [100] * 4)
    assert by == "bytes" and ms == pytest.approx(1e3 * want / 3.35e12)
    assert 1.9 < ms < 1.95 and ops < nbytes * 989e12 / 3.35e12
    mla = t_configs.get_config("minicpm3-4b")
    assert t_rl.lm_cache_bytes_per_position(mla) == 62 * (256 + 32) * 2
