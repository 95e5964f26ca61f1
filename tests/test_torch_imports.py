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
from repro_torch.configs.tnn_mnist import launcher_network_config
from repro_torch.core.network import init_network
from repro_torch.launch import serve as launch_serve
from repro_torch.serve.tnn_engine import TNNEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_port_imports_no_jax():
    mods = _modules()
    assert "repro_torch.kernels.tnn_wave" in mods and len(mods) >= 20
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.path.insert(0, {ROOT!r})
        for name in {mods!r}:
            importlib.import_module(name)
        import chip_smoke
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


def test_defaults_are_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    cfg = launcher_network_config(4)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="cuda"):
        init_network(gen, cfg)
    params = init_network(gen, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        TNNEngine(cfg, params)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.params_from_numpy([np.asarray(w) for w in params], cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        launch_serve.main(["--sites", "4", "--requests", "2"])
    assert launch_serve.parse_args([]).device == "cuda"


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
