"""The port's per-layer backends (``"pallas"`` on the per-layer kernels'
plain versions, ``"matmul"`` on the 0/1 product form) against the JAX
reference's same backends: ``layer_step``, ``network_forward`` and
``network_train_wave``, both with the reference's own uniform draws handed
across and with the port drawing them from the same key, a network that mixes backends, and a ``"fused"`` network the wave kernel
cannot hold (layer-1 fan-in 600), which both packages run layer by layer
through the per-layer kernels. Every comparison is exact."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import tnn_mnist as j_tnn_mnist
from repro.core import column as j_column
from repro.core import layer as j_layer
from repro.core import network as j_network
from repro.kernels import padding as j_padding

from repro_torch import random as t_random
from repro_torch.configs import tnn_mnist as t_tnn_mnist
from repro_torch.core import column as t_column
from repro_torch.core import layer as t_layer
from repro_torch.core import network as t_network
from repro_torch.kernels import padding as t_padding
from repro_torch.kernels import stdp_update as t_stdp_update
from repro_torch.kernels import threefry as t_threefry
from repro_torch.kernels import tnn_column as t_tnn_column
from repro_torch.kernels import tnn_wave as t_tnn_wave
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

T = 8


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _uniforms(key, jcfg, B):
    """The reference's per-layer draws, as network_train_wave makes them."""
    keys = jax.random.split(key, len(jcfg.layers))
    return [torch.from_numpy(np.array(j_layer.layer_uniforms(k, l, B)))
            for k, l in zip(keys, jcfg.layers)]


def _case(jcfg, B, seed):
    rng = np.random.default_rng(seed)
    C, p1 = jcfg.layers[0].n_cols, jcfg.layers[0].column.p
    x = rng.integers(0, T + 1, (B, C, p1)).astype(np.uint8)
    params = [rng.integers(0, 8, (l.n_cols, l.column.p, l.column.q)).astype(np.int8)
              for l in jcfg.layers]
    return x, params


def _check_network(jcfg, tcfg, x, params, key, impls):
    """Forward and one learning wave: the reference under ``jcfg``'s own
    backends, the port under each of ``impls``."""
    B = x.shape[0]
    zs_j = j_network.network_forward(x, list(params), jcfg)
    zl_j, new_j = j_network.network_train_wave(x, list(params), jcfg, key)
    us = _uniforms(key, jcfg, B)
    xt = torch.from_numpy(x)
    pt = [torch.from_numpy(w) for w in params]
    for impl in impls:
        cfg = t_network.with_impl(tcfg, impl) if impl else tcfg
        for a, b in zip(zs_j, t_network.network_forward(xt, pt, cfg)):
            assert b.dtype == torch.uint8
            _eq(a, b)
        zl_t, new_t = t_network.network_train_wave(xt, pt, cfg, uniforms=us)
        # and the port's own draws from the same key
        zd_t, newd_t = t_network.network_train_wave(xt, pt, cfg, np.asarray(key))
        for a, b, c in zip(zl_j, zl_t, zd_t):
            _eq(a, b)
            _eq(a, c)
        for a, b, c in zip(new_j, new_t, newd_t):
            assert b.dtype == torch.int8 and c.dtype == torch.int8
            _eq(a, b)
            _eq(a, c)
    assert all(int((np.asarray(z) < T).sum()) > 0 for z in zl_j)
    assert any(not np.array_equal(np.asarray(a), b) for a, b in zip(new_j, params))


@pytest.mark.parametrize("impl", ["pallas", "matmul"])
def test_network_per_layer_backends(impl):
    jcfg = j_network.with_impl(j_tnn_mnist.network_config(4, 12, 3), impl)
    tcfg = t_tnn_mnist.network_config(4, 12, 3, impl=impl)
    x, params = _case(jcfg, 8, seed=11)
    _check_network(jcfg, tcfg, x, params, jax.random.PRNGKey(3), [None])


def test_mixed_backends_run_layer_by_layer():
    """Layer 1 on the kernels, layer 2 on the product form, against the
    reference's same mix; no wave-kernel launch."""
    import dataclasses

    def mixed(cfg):
        l1, l2 = cfg.layers
        return dataclasses.replace(cfg, layers=(
            dataclasses.replace(l1, column=dataclasses.replace(l1.column, impl="fused")),
            dataclasses.replace(l2, column=dataclasses.replace(l2.column, impl="matmul"))))

    jcfg = mixed(j_tnn_mnist.network_config(4, 12, 3))
    tcfg = mixed(t_tnn_mnist.network_config(4, 12, 3))
    assert not t_network._uses_fused_wave(tcfg)
    x, params = _case(jcfg, 5, seed=12)
    before = t_tnn_wave.LAUNCHES.total
    _check_network(jcfg, tcfg, x, params, jax.random.PRNGKey(4), [None])
    assert t_tnn_wave.LAUNCHES.total == before


def test_fused_network_the_wave_kernel_cannot_hold():
    """p1 = 600 is over the wave kernel's cap: both packages run the
    ``"fused"`` network layer by layer on the per-layer kernels, and the
    port's answer is every backend's answer."""
    def wide(mod_col, mod_layer, mod_net, mod_temporal):
        wave = mod_temporal.WaveSpec()
        return mod_net.NetworkConfig(layers=(
            mod_layer.LayerConfig(4, mod_col.ColumnConfig(
                p=600, q=12, theta=600, wave=wave, impl="fused")),
            mod_layer.LayerConfig(4, mod_col.ColumnConfig(
                p=12, q=10, theta=3, wave=wave, impl="fused"))))

    from repro.core import temporal as j_temporal
    from repro_torch.core import temporal as t_temporal
    jcfg = wide(j_column, j_layer, j_network, j_temporal)
    tcfg = wide(t_column, t_layer, t_network, t_temporal)
    assert not j_padding.fused_wave_capable(jcfg)
    assert not t_padding.fused_wave_capable(tcfg)
    x, params = _case(jcfg, 6, seed=13)
    _check_network(jcfg, tcfg, x, params, jax.random.PRNGKey(5),
                   [None, "pallas", "direct", "matmul"])


@pytest.mark.parametrize("impl", ["direct", "matmul", "pallas"])
def test_layer_step(impl):
    """The reference's layer_step draws its own uniforms from its key; the
    same draws handed to the port's, and the port's own draws from the same
    key, give the same outputs and weights, for the reference backend
    ``impl`` against every port backend."""
    jcfg = j_tnn_mnist.network_config(4, 12, 3)
    tcfg = t_tnn_mnist.network_config(4, 12, 3)
    jl = j_network.with_impl(jcfg, impl).layers[0]
    x, params = _case(jcfg, 7, seed=14)
    key = jax.random.PRNGKey(6)
    z_j, w_j = j_layer.layer_step(x, params[0], jl, key)
    u = torch.from_numpy(np.array(j_layer.layer_uniforms(key, jl, 7)))
    for t_impl in ("direct", "matmul", "pallas", "fused"):
        tl = t_network.with_impl(tcfg, t_impl).layers[0]
        z_t, w_t = t_layer.layer_step(torch.from_numpy(x),
                                      torch.from_numpy(params[0]), tl, uniforms=u)
        _eq(z_j, z_t)
        assert w_t.dtype == torch.int8
        _eq(w_j, w_t)
        z_d, w_d = t_layer.layer_step(torch.from_numpy(x),
                                      torch.from_numpy(params[0]), tl, np.asarray(key))
        _eq(z_j, z_d)
        _eq(w_j, w_d)
    assert not np.array_equal(np.asarray(w_j), params[0])


def test_layer_step_draws_from_a_generator():
    """Without uniforms, layer_step draws them with layer_uniforms from its
    key (the port's key now, as the reference's; the name is the test's
    from before the port drew threefry bits); learn=False leaves the
    weights alone; no kernel launches on the CPU."""
    tl = t_tnn_mnist.network_config(4, 12, 3, impl="pallas").layers[0]
    x, params = _case(t_tnn_mnist.network_config(4, 12, 3), 5, seed=15)
    xt, wt = torch.from_numpy(x), torch.from_numpy(params[0])
    before = (t_tnn_column.LAUNCHES.n, t_stdp_update.LAUNCHES.n,
              t_threefry.LAUNCHES.n)
    z, w = t_layer.layer_step(xt, wt, tl, t_random.PRNGKey(2))
    u = t_layer.layer_uniforms(t_random.PRNGKey(2), tl, 5, device="cpu")
    z2, w2 = t_layer.layer_step(xt, wt, tl, uniforms=u)
    assert torch.equal(z, z2) and torch.equal(w, w2)
    z3, w3 = t_layer.layer_step(xt, wt, tl, learn=False)
    assert torch.equal(z3, z) and w3 is wt
    with pytest.raises(ValueError, match="rng or uniforms"):
        t_layer.layer_step(xt, wt, tl)
    assert (t_tnn_column.LAUNCHES.n, t_stdp_update.LAUNCHES.n,
            t_threefry.LAUNCHES.n) == before
