"""The port's architecture registry against the JAX package's: all ten
configs field for field with the same analytic parameter counts, the smoke
configs, the shape grid and its applicability; and the decode step's byte
bound, whose weights are the reference's spec tree (``init_params``'s
leaves), not the analytic count."""
import dataclasses
import math

import jax
import pytest

import repro.configs as j_configs
from repro.configs import base as j_base
from repro.models import model as j_model
from repro.models.params import is_spec as j_is_spec

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


def _spec_floats(arch, skip=()):
    specs = j_model.build_specs(j_configs.get_config(arch))
    return sum(math.prod(s.shape) for k, sub in specs.items() if k not in skip
               for s in jax.tree.leaves(sub, is_leaf=j_is_spec))


@pytest.mark.parametrize("arch", j_configs.ARCHS)
def test_decode_weights_are_the_spec_trees(arch):
    """The bound's weights: the reference's spec leaves, less the encoder and
    the frontend projector (decode runs neither) and the embedding unless
    tied; the launcher's count is the whole tree."""
    from repro_torch.models import model as t_model
    cfg = t_configs.get_config(arch)
    assert t_model.param_count(cfg) == _spec_floats(arch)
    skip = ("encoder", "frontend_proj") + (() if cfg.tie_embeddings else ("embed",))
    assert t_rl.lm_decode_weights(cfg) == _spec_floats(arch, skip)


def test_decode_bound_zamba2_by_hand():
    """zamba2-7b at 4 rows of 256 positions, worked by hand: 5,737,416,000
    spec floats less the 32,000 x 3,584 embedding, once in bf16; 4 gathered
    rows; the 13 shared-attention invocations' K/V (32 heads x 112, bf16) at
    1,028 positions; the 68 Mamba layers' state per row, read and written:
    float32 (112 heads x 64 x 64) and a bf16 conv window of 3 x (7,168 +
    128); the logits. About 12.46 GB, 3.72 ms at 3.35 TB/s."""
    cfg = t_configs.get_config("zamba2-7b")
    assert _spec_floats("zamba2-7b") == 5_737_416_000
    weights = 5_737_416_000 - 32_000 * 3_584
    kv = 13 * 2 * 32 * 112 * 2
    state = 68 * (4 * 112 * 64 * 64 + 2 * 3 * (7_168 + 128))
    assert t_rl.lm_cache_bytes_per_position(cfg) == kv
    assert t_rl.lm_state_bytes_per_row(cfg) == state
    want = 2 * weights + 2 * 4 * 3_584 + kv * (4 * 256 + 4) + 4 * 2 * state + 2 * 4 * 32_000
    nbytes, ops = t_rl.lm_decode_work(cfg, [256] * 4)
    assert nbytes == want == 12_459_385_472
    ms, by, _ = t_rl.lm_decode_bound(cfg, [256] * 4)
    assert by == "bytes" and ms == pytest.approx(1e3 * want / 3.35e12)
    # operations: 2 a weight a row, 4 H hd a cached position in the 13
    # attending invocations only, 5 a Mamba state element a row
    attn = 4 * 32 * 112 * 13 * 4 * 256
    assert ops == 2 * 4 * weights + attn + 4 * 5 * 68 * 7_168 * 64


def test_decode_bound_counts_weights_gathered_rows_and_cache():
    """llama3.2-3b's decode step at 4 rows of 100 cached positions: every
    weight but the embedding once in bf16 (the spec tree's 3,606,752,256,
    the final norm's 3,072 included), 4 embedding rows, the valid cache (28
    layers x K and V x 8 heads x 128 x 2 bytes a position, the new one
    written too) and the logits; about 6.44 GB, 1.92 ms at 3.35 TB/s."""
    cfg = t_configs.get_config("llama3.2-3b")
    nbytes, ops = t_rl.lm_decode_work(cfg, [100] * 4)
    per_pos = 28 * 2 * 8 * 128 * 2
    assert t_rl.lm_cache_bytes_per_position(cfg) == per_pos
    want = 2 * (3_606_752_256 - 128256 * 3072) + 2 * 4 * 3072 + per_pos * 404 + 2 * 4 * 128256
    assert nbytes == want
    ms, by, _ = t_rl.lm_decode_bound(cfg, [100] * 4)
    assert by == "bytes" and ms == pytest.approx(1e3 * want / 3.35e12)
    assert 1.9 < ms < 1.95 and ops < nbytes * 989e12 / 3.35e12
    mla = t_configs.get_config("minicpm3-4b")
    assert t_rl.lm_cache_bytes_per_position(mla) == 62 * (256 + 32) * 2


def _dense_layer(d, H, KV, hd, ff, bias=False):
    """One GQA decoder layer's floats: two norm scales, Q/K/V/O (and QKV
    biases), the SwiGLU MLP's three matrices."""
    return 2 * d + d * (H + 2 * KV) * hd + H * hd * d + (bias * (H + 2 * KV) * hd) + 3 * d * ff


@pytest.mark.parametrize("arch,layers,per_layer,params,decode", [
    # qwen1.5-4b: d 2,560, 20 heads (MHA) x 128 with QKV biases, d_ff 6,912,
    # untied 151,936-row embedding and head
    ("qwen1.5-4b", 40, _dense_layer(2560, 20, 20, 128, 6912, bias=True),
     3_950_369_280, 3_561_413_120),
    # mistral-nemo-12b: d 5,120, 32 query heads x 128 = 4,096 (not d), 8 KV
    # heads, d_ff 14,336, 131,072-row embedding and head
    ("mistral-nemo-12b", 40, _dense_layer(5120, 32, 8, 128, 14336),
     12_247_782_400, 11_576_693_760),
    # grok-1-314b cut to 2 of 64 layers: d 6,144, 48 x 128 queries, 8 KV
    # heads, a router and 8 SwiGLU experts of d_ff 32,768
    ("grok-1-314b", 2, _dense_layer(6144, 48, 8, 128, 0) + 6144 * 8 + 8 * 3 * 6144 * 32768,
     11_450_578_944, 10_645_272_576),
])
def test_last_three_archs_by_hand(arch, layers, per_layer, params, decode):
    """The three archs chip_smoke serves at full width: ``param_count`` (the
    floats ``init_params`` draws, 4 bytes each: 15.8, 49.0 and 45.8 GB) and
    the decode step's weights, from the layer shapes by hand."""
    from repro_torch.models import model as t_model
    cfg = t_configs.get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=layers, layout_repeat=layers)
    embed = cfg.vocab_size * cfg.d_model
    assert per_layer * layers + 2 * embed + cfg.d_model == params
    assert t_model.param_count(cfg) == params
    assert t_rl.lm_decode_weights(cfg) == params - embed == decode
    if arch == "qwen1.5-4b":
        assert per_layer == 79_311_360
