"""The LM train step's bound (``roofline.analysis.lm_train_work``): llama3.2-3b
at 4 x 512 worked by hand, the MoE idle experts and the sliding window on
smoke mixtral, the remat mode read from the config, and the optimizer
pass's bytes against the reference train state's own leaves (AdamW and
Adafactor, with and without compression)."""
import dataclasses
import math

import jax
import pytest

from repro.configs import smoke_config as j_smoke
from repro.train import optimizer as JO
from repro.train import train_step as JTS

import repro_torch.configs as t_configs
from repro_torch.models import model as t_model
from repro_torch.models.params import is_spec, tree_flatten
from repro_torch.roofline import analysis as t_rl
from repro_torch.train import optimizer as TO
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def test_llama_bound_by_hand():
    """llama3.2-3b, B x S = 4 x 512, bf16, AdamW, remat "full": 8 ops a
    trunk weight a token (2,818,744,320 spec weights), the untied head's
    6 d V a token, the causal attention's 2 B H hd S^2 a layer forward
    times 4; 51.7 TFLOP, 52.3 ms at 989 TFLOP/s. The optimizer pass: 30
    bytes a parameter (f32 params read and written, grads read, m and v
    read and written, the bf16 copy written), 108.2 GB, 32.3 ms at 3.35
    TB/s. Bound 84.6 ms. With remat "none" or "dots" the recomputed
    forward (2 a weight a token, one attention forward) drops out."""
    cfg = t_configs.get_config("llama3.2-3b")
    n, trunk, embed, tokens = 3_606_752_256, 2_818_744_320, 128_256 * 3_072, 4 * 512
    assert t_model.param_count(cfg) == n and t_model.param_count(cfg, "trunk") == trunk
    attn = 2 * 4 * 24 * 128 * 512 * 512
    ops = 8 * trunk * tokens + 6 * 3_072 * 128_256 * tokens + 4 * attn * 28
    w = t_rl.lm_train_work(cfg, TO.OptConfig(), 4, 512)
    assert w["ops"] == ops == 51_745_363_329_024
    assert w["bytes"] == 30 * n == 108_202_567_680
    assert w["products_ms"] == pytest.approx(1e3 * ops / 989e12)
    assert w["optimizer_ms"] == pytest.approx(1e3 * 30 * n / 3.35e12)
    assert 52.3 < w["products_ms"] < 52.4 and 32.2 < w["optimizer_ms"] < 32.4
    assert 84.6 < w["bound_ms"] < 84.7
    assert w["model_flops"] == 6 * (n - embed) * tokens
    for mode in ("none", "dots"):
        lean = t_rl.lm_train_work(dataclasses.replace(cfg, remat=mode), TO.OptConfig(), 4, 512)
        assert lean["ops"] == ops - 2 * trunk * tokens - attn * 28
        assert lean["bytes"] == w["bytes"] and lean["model_flops"] == w["model_flops"]


def test_moe_bound_counts_visited_experts_and_the_window():
    """Smoke mixtral (2 MoE layers of 4 experts, 2 a token, d 64, d_ff
    128, window 16) at B x S = 2 x 32: half of the expert weights (wg, wi,
    wo) are idle for every token; each query attends 16 keys, not the
    causal half of 32."""
    cfg = t_configs.smoke_config("mixtral-8x22b")
    experts = sum(math.prod(s.shape) for p, s in tree_flatten(t_model.build_specs(cfg), is_spec)
                  if p[-2:-1] == ("moe",) and p[-1] in ("wg", "wi", "wo"))
    assert experts == 3 * 2 * 4 * 64 * 128
    idle = experts // 2
    attn = 4 * 2 * 4 * 16 * 32 * 16                  # 4 B H hd S W
    ops = 8 * (230_144 - idle) * 64 + 6 * 64 * 256 * 64 + 4 * attn * 2
    assert t_model.param_count(cfg, "trunk") == 230_144
    assert t_rl.lm_train_work(cfg, TO.OptConfig(), 2, 32)["ops"] == ops


@pytest.mark.parametrize("name,compress", [("adamw", False), ("adamw", True),
                                           ("adafactor", False), ("adafactor", True)])
def test_optimizer_bytes_are_the_reference_states(name, compress):
    """The optimizer pass's bytes on smoke llama3.2-3b (bf16): the f32
    params read and written and the grads read, every moment leaf of the
    reference's train state (m and v, or Adafactor's vr and vc, 1-D
    leaves' vc of one float) read and written, the residual read and
    written under compression, and the bf16 copy written."""
    jcfg = j_smoke("llama3.2-3b")
    jo = JO.OptConfig(name=name, compress_grads=compress)
    state = jax.eval_shape(lambda: JTS.init_state(jcfg, jo, jax.random.PRNGKey(0)))
    n = sum(math.prod(a.shape) for a in jax.tree.leaves(state["params"]))
    moments = sum(math.prod(a.shape) for k, v in state["opt"].items()
                  if k not in ("count", "residual") for a in jax.tree.leaves(v))
    residual = sum(math.prod(a.shape) for a in jax.tree.leaves(state["opt"].get("residual", {})))
    assert residual == (n if compress else 0)
    cfg = t_configs.smoke_config("llama3.2-3b")
    assert t_model.param_count(cfg) == n
    w = t_rl.lm_train_work(cfg, TO.OptConfig(name=name, compress_grads=compress), 2, 16)
    assert w["bytes"] == 4 * (3 * n + 2 * moments + 2 * residual) + 2 * n


@pytest.mark.parametrize("arch", ["minicpm3-4b", "zamba2-7b", "xlstm-125m", "whisper-tiny",
                                  "internvl2-76b"])
def test_bound_refuses_the_families_it_does_not_count(arch):
    with pytest.raises(ValueError, match="dense and MoE"):
        t_rl.lm_train_work(t_configs.smoke_config(arch), TO.OptConfig(), 2, 16)
