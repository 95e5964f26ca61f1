"""The port's fused gamma wave (plain PyTorch version, which the Hopper
kernel is held against on the card) against the JAX reference's
``wave_forward`` / ``wave_train`` (Pallas, in interpret mode on the CPU).

Depth 1-3, 4-16 sites, ragged batches, packed on and off, and thresholds
(12, 3, 1) at which every layer fires. Volleys, weights and STDP uniforms
are made with numpy from a seed and handed to both; every comparison is
exact. (The reference's own uniform draws are handed across in
tests/test_torch_network.py.)"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.tnn_mnist import deep_config as j_deep_config
from repro.kernels import padding as j_padding
from repro.kernels import tnn_wave as j_tnn_wave

from repro_torch.configs.tnn_mnist import deep_config as t_deep_config
from repro_torch.kernels import padding as t_padding
from repro_torch.kernels import tnn_wave as t_tnn_wave
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

WIDTHS = {1: (12,), 2: (12, 10), 3: (12, 12, 10)}


def _configs(depth, sites, packed):
    thetas = (12, 3, 1)[:depth]  # late deep volleys need a low threshold
    j = j_deep_config(sites, widths=WIDTHS[depth], thetas=thetas, impl="fused")
    t = t_deep_config(sites, widths=WIDTHS[depth], thetas=thetas, impl="fused")
    return (dataclasses.replace(j, packed=packed),
            dataclasses.replace(t, packed=packed))


def _inputs(cfg, B, seed):
    rng = np.random.default_rng(seed)
    T = cfg.layers[0].column.wave.T
    C, p1 = cfg.layers[0].n_cols, cfg.layers[0].column.p
    x = rng.integers(0, T + 1, (B, C, p1)).astype(np.uint8)
    params = [rng.integers(0, 8, (l.n_cols, l.column.p, l.column.q)).astype(np.int8)
              for l in cfg.layers]
    # (C, 2, B, p, q), the layout the reference's layer_uniforms draws
    us = [rng.random((l.n_cols, 2, B, l.column.p, l.column.q), dtype=np.float32)
          for l in cfg.layers]
    return x, params, us


CASES = [  # depth, sites, B, packed
    (1, 4, 5, True),
    (2, 16, 8, False),
    (2, 9, 5, True),
    (2, 4, 8, True),
    (3, 4, 8, True),
    (3, 16, 5, False),
]


@pytest.mark.parametrize("depth,sites,B,packed", CASES)
def test_wave_matches_reference(depth, sites, B, packed):
    jcfg, tcfg = _configs(depth, sites, packed)
    x, params, us = _inputs(jcfg, B, seed=depth * 100 + sites + B)
    jplan = j_padding.network_plan(jcfg, B)
    tplan = t_padding.network_plan(tcfg, B)

    zs_j = j_tnn_wave.wave_forward(x, tuple(params), plan=jplan)
    (zl_j, nets_j) = j_tnn_wave.wave_train(
        x, tuple(params), tuple((u[:, 0], u[:, 1]) for u in us), plan=jplan)

    xt = torch.from_numpy(x)
    pt = [torch.from_numpy(w) for w in params]
    before = dataclasses.replace(t_tnn_wave.LAUNCHES)
    zs_t = t_tnn_wave.wave_forward(xt, pt, plan=tplan)
    ut = [torch.from_numpy(u) for u in us]
    zl_t, nets_t = t_tnn_wave.wave_train(
        xt, pt, [(u[:, 0], u[:, 1]) for u in ut], plan=tplan)
    assert t_tnn_wave.LAUNCHES == before  # the plain version never counts

    fired = []
    for zj, zt, zlj, zlt in zip(zs_j, zs_t, zl_j, zl_t):
        assert zt.dtype == torch.uint8 and tuple(zt.shape) == tuple(zj.shape)
        np.testing.assert_array_equal(np.asarray(zj), zt.numpy())
        np.testing.assert_array_equal(np.asarray(zlj), zlt.numpy())
        fired.append(int((zt < jplan.T).sum()))
    assert all(f > 0 for f in fired), fired  # every layer fires: a real check
    for nj, nt in zip(nets_j, nets_t):
        assert nt.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(nj), nt.numpy())
    assert any(int(n.abs().sum()) > 0 for n in nets_t)


def test_wave_plain_accepts_strided_inputs():
    """The public (B, C, p1) layout may arrive as a view: the plain version
    (and the kernel, through strides) reads it as is."""
    _, tcfg = _configs(2, 4, True)
    B = 6
    x, params, us = _inputs(tcfg, B, seed=7)
    plan = t_padding.network_plan(tcfg, B)
    xt = torch.from_numpy(x)
    wide = torch.full((B, 4, 40), 8, dtype=torch.uint8)
    wide[:, :, 3:35] = xt
    pt = [torch.from_numpy(w) for w in params]
    for a, b in zip(t_tnn_wave.wave_forward(wide[:, :, 3:35], pt, plan=plan),
                    t_tnn_wave.wave_forward(xt, pt, plan=plan)):
        assert torch.equal(a, b)


def test_wave_rejects_other_devices():
    _, tcfg = _configs(1, 4, True)
    plan = t_padding.network_plan(tcfg, 2)
    x = torch.empty((2, 4, 32), dtype=torch.uint8, device="meta")
    w = torch.empty((4, 32, 12), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        t_tnn_wave.wave_forward(x, [w], plan=plan)
    with pytest.raises(ValueError, match="cpu or cuda"):
        t_tnn_wave.wave_train(x, [w], [(None, None)], plan=plan)


def test_launch_args_match_the_kernel_struct():
    """The ctypes mirror of the kernel's argument struct: its layout is the
    C one on this ABI (pointers and 64-bit strides 8-aligned)."""
    A = t_tnn_wave._WaveArgs
    assert A.x.offset == 0 and A.x_sb.offset == 8
    assert A.n_layers.offset == 32 and A.threads.offset == 60
    assert A.w.offset % 8 == 0 and A.uu_sc.offset % 8 == 0
    assert A.consts.offset == A.net.offset + 8 * t_tnn_wave.MAX_LAYERS
