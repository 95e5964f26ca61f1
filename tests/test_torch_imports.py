"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports JAX or the JAX package; its entry points run on
the CUDA card by default and raise where there is none."""
import os
import pkgutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.configs.tnn_mnist import launcher_network_config
from repro_torch.core.column import init_weights
from repro_torch.core.layer import init_layer, layer_uniforms
from repro_torch.core.network import init_network
from repro_torch.kernels import autotune, threefry
from repro_torch.launch import dryrun as launch_dryrun
from repro_torch.launch import loadgen as launch_loadgen
from repro_torch.launch.mesh import make_mesh_2d
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import tnn_mnist as launch_flagship
from repro_torch.launch import tnn_frontend_lm as launch_frontend
from repro_torch.launch import train as launch_train
from repro_torch.models import model as lm_model
from repro_torch.random import PRNGKey
from repro_torch.serve.engine import Engine as LMEngine
from repro_torch.train import optimizer as lm_optimizer
from repro_torch.train import train_step as lm_train_step
from repro_torch.serve.tnn_engine import TNNEngine
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_port_imports_no_jax():
    mods = _modules()
    assert "repro_torch.kernels.tnn_wave" in mods and len(mods) >= 20
    for new in ("launch.loadgen", "launch.tnn_mnist", "core.hwmodel", "core.macros",
                "launch.dryrun", "roofline.analysis", "utils.tracing",
                "launch.mesh", "launch.collective_probe", "configs.base",
                "configs.llama3_2_3b", "configs.mixtral_8x22b", "configs.minicpm3_4b",
                "models.params", "models.layers", "models.moe", "models.model",
                "serve.engine", "models.ssm", "launch.tnn_frontend_lm",
                "configs.xlstm_125m", "configs.zamba2_7b", "configs.whisper_tiny",
                "data.tokens", "train.optimizer", "train.train_step", "train.trainer",
                "kernels.autotune"):
        assert f"repro_torch.{new}" in mods
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.path.insert(0, {ROOT!r})
        for name in {mods!r}:
            importlib.import_module(name)
        import chip_smoke
        import mesh_cards
        bad = sorted(m for m in sys.modules
                     if m in ("jax", "jaxlib", "repro") or m.startswith(
                         ("jax.", "jaxlib.", "repro.")))
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_defaults_are_cuda_and_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    cfg = launcher_network_config(4)
    key = PRNGKey(0)
    with pytest.raises(RuntimeError, match="cuda"):
        init_network(key, cfg)
    layer = cfg.layers[0]
    with pytest.raises(RuntimeError, match="cuda"):
        init_weights(key, layer.column.p, layer.column.q, layer.column.wave)
    with pytest.raises(RuntimeError, match="cuda"):
        init_layer(key, layer)
    with pytest.raises(RuntimeError, match="cuda"):
        layer_uniforms(key, layer, 2)
    assert init_layer(key, layer, device="cpu").device.type == "cpu"
    assert layer_uniforms(key, layer, 2, device="cpu").device.type == "cpu"
    params = init_network(key, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        TNNEngine(cfg, params)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.params_from_numpy([np.asarray(w) for w in params], cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        launch_serve.main(["--sites", "4", "--requests", "2"])
    assert launch_serve.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(["--smoke", "--ckpt-dir", str(tmp_path)])
    assert launch_train.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        threefry.layer_uniforms(key, 4, (2, 1, 3, 2))
    with pytest.raises(RuntimeError, match="cuda"):
        launch_loadgen.main(["--sites", "4", "--requests", "2"])
    with pytest.raises(RuntimeError, match="cuda"):
        launch_flagship.main(["--train", "16", "--test", "8", "--waves", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        threefry.nested_uniforms(key, 4, 2, (2, 3, 2))
    with pytest.raises(RuntimeError, match="cuda"):
        launch_dryrun.run_tnn_cell("tnn_train_8k", sites=4, batch=2)
    with pytest.raises(RuntimeError, match="cuda"):
        threefry.window_uniforms(key, 4, 2, (3, 2), (0, 2, 0, 1))
    with pytest.raises(ValueError, match="backend='gloo'"):   # the mesh default: NCCL
        make_mesh_2d(1, 1)
    assert launch_serve.parse_args([]).mesh is None
    assert launch_train.parse_args([]).mesh is None
    # the LM path (its launcher's --arch default stays tnn-mnist)
    assert launch_serve.parse_args([]).arch == "tnn-mnist"
    lm = smoke_config("llama3.2-3b")
    with pytest.raises(RuntimeError, match="cuda"):
        launch_serve.main(["--arch", "llama3.2-3b", "--smoke", "--requests", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        lm_model.init_params(lm, key)
    with pytest.raises(RuntimeError, match="cuda"):
        lm_model.init_cache(lm, 1, 8)
    lm_params = lm_model.init_params(lm, key, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        LMEngine(lm, lm_params)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.lm_params_from_numpy(convert.lm_params_to_numpy(lm_params), lm)
    # the SSM, hybrid and encoder-decoder families, and the TNN-frontend entry
    for arch in ("xlstm-125m", "zamba2-7b", "whisper-tiny"):
        with pytest.raises(RuntimeError, match="cuda"):
            lm_model.init_cache(smoke_config(arch), 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        launch_serve.main(["--arch", "zamba2-7b", "--smoke", "--requests", "1"])
    # LM training (its launcher's --arch default stays tnn-mnist)
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(["--arch", "llama3.2-3b", "--smoke", "--steps", "1",
                           "--ckpt-dir", str(tmp_path / "lm")])
    with pytest.raises(RuntimeError, match="cuda"):
        lm_train_step.init_state(lm, lm_optimizer.OptConfig(), key)
    assert launch_frontend.parse_args([]).device == "cuda"
    assert launch_frontend.parse_args([]).impl == "direct"
    with pytest.raises(RuntimeError, match="cuda"):
        launch_frontend.main([])
    # the wave kernel's launch autotuner times on the card only
    with pytest.raises(RuntimeError, match="cuda"):
        autotune.tune_geometry(cfg, 2)


def test_launcher_runs_on_cpu_when_asked(capsys):
    rep = launch_serve.main(["--sites", "4", "--slots", "4", "--requests", "6",
                             "--train-waves", "2", "--device", "cpu"])
    assert sorted(rep.results) == list(range(6))
    assert rep.stats.waves == 2 and len(rep.warmup_spikes) == 2
    assert all(w.dtype == torch.int8 for w in rep.params)
    assert "[serve-stats]" in capsys.readouterr().out


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
