"""The "seq" and "gauss" STDP batch-reduce modes against the JAX reference,
bit for bit: the one-column ``stdp_update``, ``layer_step`` and
``network_train_wave`` on every backend of the port (direct, matmul, pallas,
fused: the forward on the backend, the update in the mode's plain form),
from the same numpy volleys and weights and the same key, at theta (12, 3)
where both layers fire. The reference runs at 4 sites on "direct"; its
"gauss" runs op by op (its eager definition: under jit XLA fuses the
mean/variance and ``mean + sqrt(var) * g`` into FMAs), its "seq" under one
jit (compares of exact products only, the same bits, compiled once).

Also: a fused network in these modes takes the per-layer route (column and
threefry launches, never the wave or STDP kernel), shown through
``kernel_launch_count`` with the kernel entry points counted as the card
would count them; the counter form and the train, superbatch and online
steps refuse the modes with the reference's messages; and ``uniforms=`` is
refused for them."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tnn_mnist as j_tnn_mnist
from repro.core import layer as j_layer
from repro.core import network as j_network

from repro_torch import random as t_random
from repro_torch.configs import tnn_mnist as t_tnn_mnist
from repro_torch.core import layer as t_layer
from repro_torch.core import network as t_network
from repro_torch.core import stdp as t_stdp
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import stdp_update as t_stdp_update
from repro_torch.kernels import threefry as t_threefry
from repro_torch.kernels import tnn_column as t_tnn_column
from repro_torch.kernels import tnn_wave as t_tnn_wave
from repro_torch.utils.tracing import kernel_launch_count
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

T = 8
SITES, B = 4, 8
MODES = ("seq", "gauss")
IMPLS = ("direct", "matmul", "pallas", "fused")


def with_mode(cfg, mode: str, impl: str = None):
    layers = tuple(dataclasses.replace(l, column=dataclasses.replace(
        l.column, impl=impl or l.column.impl,
        stdp=dataclasses.replace(l.column.stdp, batch_reduce=mode)))
        for l in cfg.layers)
    return dataclasses.replace(cfg, layers=layers)


def _eq(a, b):
    a = np.asarray(a)
    assert a.dtype == b.numpy().dtype and a.shape == tuple(b.shape)
    np.testing.assert_array_equal(a, b.numpy())


@pytest.fixture(scope="module")
def ref():
    """Per mode: the reference's network_train_wave on the same numpy
    inputs and key (its layer 1 is the reference's ``stdp_update`` of each
    column, vmapped over ``split(split(key, 2)[0], SITES)``)."""
    rng = np.random.default_rng(17)
    x = rng.integers(0, T + 1, (B, SITES, 32)).astype(np.uint8)
    x[rng.random(x.shape) < 0.5] = T
    key = jax.random.split(jax.random.PRNGKey(5))[1]
    out = {"x": x, "key": np.array(key)}
    for mode in MODES:
        jcfg = with_mode(j_tnn_mnist.network_config(SITES, 12, 3), mode, "direct")
        params = [np.array(w) for w in
                  j_network.init_network(jax.random.PRNGKey(1), jcfg)]
        wave = lambda x_, ps, k, cfg=jcfg: j_network.network_train_wave(x_, ps, cfg, k)
        if mode == "seq":
            wave = jax.jit(wave)
        zs, ws = wave(jnp.asarray(x), [jnp.asarray(w) for w in params], key)
        out[mode] = {"params": params, "zs": [np.array(z) for z in zs],
                     "ws": [np.array(w) for w in ws]}
        assert int((out[mode]["zs"][1] < T).sum()) > 0, "layer 2 must fire"
    return out


def _tcfg(mode, impl):
    return with_mode(t_tnn_mnist.network_config(SITES, 12, 3), mode, impl)


@pytest.mark.parametrize("mode", MODES)
def test_stdp_update_matches_reference(ref, mode):
    """The one-column update on each column's key of layer 1, with the
    reference's layer-1 output as z, equals the reference's column."""
    r = ref[mode]
    lc = _tcfg(mode, "direct").layers[0].column
    k1 = t_random.split(t_random.as_key(ref["key"]), 2)[0]
    for c, kc in enumerate(t_random.split(k1, SITES)):
        w = t_stdp.stdp_update(torch.from_numpy(r["params"][0][c]),
                               torch.from_numpy(ref["x"][:, c]),
                               torch.from_numpy(r["zs"][0][:, c]), kc, lc.wave,
                               lc.stdp)
        _eq(r["ws"][0][c], w)
    assert (r["ws"][0] != r["params"][0]).any()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mode", MODES)
def test_layer_step_matches_reference(ref, mode, impl):
    """Layer 1 of the reference's wave is its layer_step on the first of
    ``split(key, 2)``."""
    r = ref[mode]
    l1 = _tcfg(mode, impl).layers[0]
    k1 = t_random.split(t_random.as_key(ref["key"]), 2)[0]
    z, w = t_layer.layer_step(torch.from_numpy(ref["x"]),
                              torch.from_numpy(r["params"][0]), l1, k1)
    _eq(r["zs"][0], z)
    _eq(r["ws"][0], w)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mode", MODES)
def test_network_train_wave_matches_reference(ref, mode, impl):
    r = ref[mode]
    zs, ws = t_network.network_train_wave(
        torch.from_numpy(ref["x"]), [torch.from_numpy(w) for w in r["params"]],
        _tcfg(mode, impl), t_random.as_key(ref["key"]))
    for a, b in zip(r["zs"], zs):
        _eq(a, b)
    for a, b in zip(r["ws"], ws):
        _eq(a, b)


@pytest.fixture
def counted_entries(monkeypatch):
    """Count the kernel entry points as the card counts their launches (on
    the CPU every wrapper runs its plain version and launches nothing)."""
    def spy(mod, name, bump):
        orig = getattr(mod, name)

        def call(*args, **kwargs):
            bump()
            return orig(*args, **kwargs)
        monkeypatch.setattr(mod, name, call)

    def bump_nested():
        t_threefry.LAUNCHES.n += 1
        t_threefry.LAUNCHES.nested += 1

    def bump(counter, field="n"):
        return lambda: setattr(counter, field, getattr(counter, field) + 1)

    spy(t_tnn_wave, "wave_train", bump(t_tnn_wave.LAUNCHES, "learn"))
    spy(t_tnn_wave, "wave_forward", bump(t_tnn_wave.LAUNCHES, "forward"))
    spy(t_ops, "column_forward_layer", bump(t_tnn_column.LAUNCHES))
    spy(t_ops, "stdp_update_layer", bump(t_stdp_update.LAUNCHES))
    spy(t_threefry, "layer_uniforms", bump(t_threefry.LAUNCHES))
    spy(t_threefry, "nested_uniforms", bump_nested)


@pytest.mark.parametrize("mode", MODES)
def test_fused_modes_launch_no_wave_kernel(ref, counted_entries, mode):
    """The reference's test_seq_reduce_keeps_per_layer_path: under "sum" a
    fused network is one wave-kernel launch (plus a draw per layer); under
    "seq"/"gauss" the same network runs layer by layer: a column launch and
    a draw per layer, no wave or STDP kernel."""
    x = torch.from_numpy(ref["x"])
    ps = [torch.from_numpy(w) for w in ref[mode]["params"]]
    key = t_random.as_key(ref["key"])
    counts, _ = kernel_launch_count(t_network.network_train_wave, x, ps,
                                    _tcfg("sum", "fused"), key)
    assert counts["tnn_wave[learn]"] == 1 and counts["threefry"] == 2
    assert counts["tnn_column"] == counts["stdp_update"] == 0
    counts, (zs, ws) = kernel_launch_count(t_network.network_train_wave, x, ps,
                                           _tcfg(mode, "fused"), key)
    assert counts == {"tnn_wave[forward]": 0, "tnn_wave[learn]": 0,
                      "tnn_column": 2, "stdp_update": 0, "wta": 0, "threefry": 2}
    assert t_threefry.LAUNCHES.nested == (2 if mode == "seq" else 0)
    for a, b in zip(ref[mode]["ws"], ws):
        _eq(a, b)


def _message(fn, *args):
    with pytest.raises(ValueError) as e:
        fn(*args)
    return str(e.value)


@pytest.mark.parametrize("mode", MODES)
def test_non_sum_modes_refused_with_reference_messages(ref, mode):
    """The counter form (``layer_stdp_net``, ``stdp_net_from_uniforms``,
    hence the superbatch) and the train and online step factories take
    only "sum", with the reference's words."""
    jcfg = with_mode(j_tnn_mnist.network_config(SITES, 12, 3), mode, "direct")
    tcfg = _tcfg(mode, "pallas")
    for name in ("make_train_step", "make_superbatch_step", "make_online_step",
                 "make_online_superbatch_step"):
        want = _message(getattr(j_network, name), jcfg)
        assert want == f"{name} requires batch_reduce='sum'"
        assert _message(getattr(t_network, name), tcfg) == want
    x = np.zeros((2, SITES, 32), np.uint8)
    z = np.full((2, SITES, 12), T, np.uint8)
    w = np.zeros((SITES, 32, 12), np.int8)
    u = np.zeros((SITES, 2, 32, 12), np.float32)
    want = _message(j_layer.layer_stdp_net, x, z, w, jcfg.layers[0], u, u)
    assert want.startswith("counter-form STDP requires batch_reduce='sum'")
    tx, tz, tw, tu = (torch.from_numpy(a) for a in (x, z, w, u))
    assert _message(t_layer.layer_stdp_net, tx, tz, tw, tcfg.layers[0], tu, tu) == want
    lc = tcfg.layers[0].column
    assert _message(t_stdp.stdp_net_from_uniforms, tw, tx.transpose(0, 1),
                    tz.transpose(0, 1), tu, tu, lc.wave, lc.stdp) == want
    keys = torch.stack([t_random.PRNGKey(1)])
    assert _message(t_network.network_train_superbatch, tx[None],
                    [tw, torch.zeros((SITES, 12, 10), dtype=torch.int8)],
                    tcfg, keys) == want


@pytest.mark.parametrize("mode", MODES)
def test_mode_waves_refuse_uniforms(mode):
    """The modes draw their own randomness from the key, so the "sum" form's
    uniforms cannot stand in for it."""
    tcfg = _tcfg(mode, "fused")
    x = torch.full((2, SITES, 32), T, dtype=torch.uint8)
    ps = t_network.init_network(t_random.PRNGKey(0), tcfg, "cpu")
    us = [torch.zeros((SITES, 2, 2, l.column.p, l.column.q)) for l in tcfg.layers]
    with pytest.raises(ValueError, match="draws its own"):
        t_network.network_train_wave(x, ps, tcfg, uniforms=us)
    with pytest.raises(ValueError, match="draws its own"):
        t_layer.layer_step(x, ps[0], tcfg.layers[0], uniforms=us[0])
    with pytest.raises(ValueError, match="unknown batch_reduce"):
        t_layer.layer_step(x, ps[0], with_mode(tcfg, "median").layers[0],
                           t_random.PRNGKey(0))
