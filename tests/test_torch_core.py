"""repro_torch's semantics core against the JAX reference: temporal coding,
STDP, the column, the kernel oracles, the shared kernel bodies and the
launch plans. Inputs are made with numpy from a seed and handed to both
packages; every comparison is exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import column as j_column
from repro.core import stdp as j_stdp
from repro.core import temporal as j_temporal
from repro.core.layer import LayerConfig as JLayerConfig
from repro.core.network import NetworkConfig as JNetworkConfig
from repro.kernels import padding as j_padding
from repro.kernels import ref as j_ref
from repro.kernels.stdp_update import stdp_net_tile as j_stdp_net_tile
from repro.kernels import tnn_column as j_tnn_column

from repro_torch import random as t_random
from repro_torch.core import column as t_column
from repro_torch.core import stdp as t_stdp
from repro_torch.core import temporal as t_temporal
from repro_torch.core.layer import LayerConfig as TLayerConfig
from repro_torch.core.network import NetworkConfig as TNetworkConfig
from repro_torch.kernels import padding as t_padding
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import stdp_update as t_stdp_update
from repro_torch.kernels import tnn_column as t_tnn_column
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _spikes(rng, shape, T):
    return rng.integers(0, T + 1, shape).astype(np.uint8)


def _weights(rng, shape, w_max):
    return rng.integers(0, w_max + 1, shape).astype(np.int8)


def _uniforms(rng, shape):
    return rng.random(shape, dtype=np.float32)


# -- configs: same fields, same defaults ------------------------------------


@pytest.mark.parametrize("j_cls,t_cls", [
    (j_temporal.WaveSpec, t_temporal.WaveSpec),
    (j_stdp.STDPConfig, t_stdp.STDPConfig),
    (j_column.ColumnConfig, t_column.ColumnConfig),
    (JLayerConfig, TLayerConfig),
    (JNetworkConfig, TNetworkConfig),
    (j_padding.NetworkPlan, t_padding.NetworkPlan),
])
def test_config_fields_match(j_cls, t_cls):
    def norm(v):
        return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v

    # the port's plan also carries the wave kernel's tuned launch (None: the
    # static rule); the reference's tuned extents live in its ``pad``
    own = {"launch": None} if t_cls is t_padding.NetworkPlan else {}
    jf = [(f.name, norm(f.default)) for f in dataclasses.fields(j_cls)]
    tf = [(f.name, norm(f.default)) for f in dataclasses.fields(t_cls) if f.name not in own]
    assert jf == tf
    assert {f.name: f.default for f in dataclasses.fields(t_cls) if f.name in own} == own
    assert t_cls.__dataclass_params__.frozen


def test_column_impls_and_defaults_match():
    assert t_column.ColumnConfig.IMPLS == j_column.ColumnConfig.IMPLS
    j = j_column.ColumnConfig(p=32, q=12, theta=24)
    t = t_column.ColumnConfig(p=32, q=12, theta=24)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for spec in (dict(time_bits=0), dict(weight_bits=9)):
        with pytest.raises(ValueError):
            t_temporal.WaveSpec(**spec).validate()
    with pytest.raises(ValueError):
        t_column.ColumnConfig(p=4, q=2, theta=29).validate()  # > p * w_max


@pytest.mark.parametrize("time_bits,weight_bits", [(3, 3), (4, 2), (7, 7), (1, 1)])
def test_wave_spec_and_stabilize_table(time_bits, weight_bits):
    js = j_temporal.WaveSpec(time_bits, weight_bits)
    ts = t_temporal.WaveSpec(time_bits, weight_bits)
    assert (js.T, js.w_max) == (ts.T, ts.w_max)
    assert (t_stdp.default_stabilize_table(ts.w_max)
            == j_stdp.default_stabilize_table(js.w_max))
    assert (t_stdp.STDPConfig().table_tuple(ts)
            == j_stdp.STDPConfig().table_tuple(js))
    np.testing.assert_array_equal(
        np.asarray(j_stdp.STDPConfig().table(js)),
        t_stdp.STDPConfig().table(ts).numpy())


def test_encode_intensity_half_ties():
    """Values that land exactly on .5 after scaling round half to even."""
    rng = np.random.default_rng(0)
    v = np.concatenate([np.arange(-2, 35) / 32.0,
                        rng.random(200)]).astype(np.float32)
    spec = t_temporal.WaveSpec()
    got = t_temporal.encode_intensity(torch.from_numpy(v), spec)
    assert got.dtype == t_temporal.SPIKE_DTYPE
    _eq(j_temporal.encode_intensity(jnp.asarray(v), j_temporal.WaveSpec()), got)


# -- STDP ---------------------------------------------------------------------


@pytest.mark.parametrize("seed,B,p,q", [(0, 5, 7, 3), (1, 8, 32, 12), (2, 1, 12, 10)])
def test_stdp_counter_form(seed, B, p, q):
    rng = np.random.default_rng(seed)
    spec_j, spec_t = j_temporal.WaveSpec(), t_temporal.WaveSpec()
    T, w_max = spec_t.T, spec_t.w_max
    w = _weights(rng, (p, q), w_max)
    x = _spikes(rng, (B, p), T)
    z = _spikes(rng, (B, q), T)
    uu, ud = _uniforms(rng, (B, p, q)), _uniforms(rng, (B, p, q))
    cfg_j, cfg_t = j_stdp.STDPConfig(), t_stdp.STDPConfig()

    @jax.jit
    def reference(w, x, z, uu, ud):
        net = j_stdp.stdp_net_from_uniforms(w, x, z, uu, ud, spec_j, cfg_j)
        i32 = jnp.int32
        return dict(
            cases=j_stdp.stdp_cases(x, z, T),
            net=net,
            applied=j_stdp.apply_net(w, net, spec_j),
            tile=j_stdp_net_tile(
                w.astype(i32), x.astype(i32), z.astype(i32), uu, ud, T=T,
                w_max=w_max, table=cfg_j.table_tuple(spec_j),
                mu_capture=cfg_j.mu_capture, mu_backoff=cfg_j.mu_backoff,
                mu_search=cfg_j.mu_search),
            ref=j_ref.stdp_ref(w, x, z, uu, ud, cfg_j.table(spec_j),
                               cfg_j.mu_capture, cfg_j.mu_backoff,
                               cfg_j.mu_search, w_max, T))

    want = reference(w, x, z, uu, ud)
    wt, xt, zt = torch.from_numpy(w), torch.from_numpy(x), torch.from_numpy(z)
    uut, udt = torch.from_numpy(uu), torch.from_numpy(ud)
    for jp, tp in zip(want["cases"], t_stdp.stdp_cases(xt, zt, T)):
        _eq(jp, tp)
    net_t = t_stdp.stdp_net_from_uniforms(wt, xt, zt, uut, udt, spec_t, cfg_t)
    assert net_t.dtype == torch.int32
    _eq(want["net"], net_t)
    _eq(want["applied"], t_stdp.apply_net(wt, net_t, spec_t))
    _eq(want["tile"], t_stdp_update.stdp_net_tile(
        wt, xt, zt, uut, udt, T=T, w_max=w_max,
        table=cfg_t.table_tuple(spec_t), mu_capture=cfg_t.mu_capture,
        mu_backoff=cfg_t.mu_backoff, mu_search=cfg_t.mu_search))
    _eq(want["ref"], t_ref.stdp_ref(
        wt, xt, zt, uut, udt, cfg_t.table(spec_t), cfg_t.mu_capture,
        cfg_t.mu_backoff, cfg_t.mu_search, w_max, T))


def test_stdp_rejects_unported_reduce_modes():
    """The counter form takes only "sum" ("seq" and "gauss" run through
    ``stdp_update``), and refuses the others with the reference's message."""
    spec = t_temporal.WaveSpec()
    z = torch.zeros((2, 3), dtype=torch.uint8)
    for mode in ("seq", "gauss"):
        cfg = t_stdp.STDPConfig(batch_reduce=mode)
        with pytest.raises(ValueError, match="counter-form STDP requires "
                                             "batch_reduce='sum'"):
            t_stdp.stdp_net_from_uniforms(
                torch.zeros((4, 3), dtype=torch.int8),
                torch.zeros((2, 4), dtype=torch.uint8), z,
                torch.zeros((2, 4, 3)), torch.zeros((2, 4, 3)), spec, cfg)


# -- the column ---------------------------------------------------------------


@pytest.mark.parametrize("seed,B,p,q,time_bits,theta", [
    (0, 6, 32, 12, 3, 24), (1, 9, 12, 10, 3, 3), (2, 4, 20, 7, 4, 30),
    (3, 3, 5, 2, 3, 1),
])
def test_column_forward_and_wta(seed, B, p, q, time_bits, theta):
    rng = np.random.default_rng(seed)
    spec_j = j_temporal.WaveSpec(time_bits=time_bits)
    spec_t = t_temporal.WaveSpec(time_bits=time_bits)
    T = spec_t.T
    x = _spikes(rng, (B, p), T)
    w = _weights(rng, (p, q), spec_t.w_max)
    ties = rng.integers(T - 2, T + 1, (B, q)).astype(np.uint8)

    @jax.jit
    def reference(x, w, ties):
        V = j_column.body_potential(x, w, spec_j)
        z = j_column.crossing_time(V, theta, spec_j)
        Vm = j_tnn_column.ramp_matmul(x.astype(jnp.int32), w.astype(jnp.int32), T=T)
        return dict(
            V=V, z=z, fwd=j_column.column_forward(x, w, theta, spec_j),
            matmul=j_column.column_forward_matmul(x, w, theta, spec_j),
            ref=j_ref.column_forward_ref(x, w, theta, T),
            wta=[j_column.wta_inhibit(zz, spec_j) for zz in (z, ties)],
            wta_ref=[j_ref.wta_ref(zz, T) for zz in (z, ties)],
            Vm=Vm,
            cw=[j_tnn_column.crossing_wta(Vm.reshape(B, T, q), T=T,
                                          theta=theta, wta=wta)
                for wta in (False, True)])

    want = reference(x, w, ties)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    V_t = t_column.body_potential(xt, wt, spec_t)
    _eq(want["V"], V_t)
    z_t = t_column.crossing_time(V_t, theta, spec_t)
    _eq(want["z"], z_t)
    _eq(want["fwd"], t_column.column_forward(xt, wt, theta, spec_t))
    _eq(want["matmul"], t_column.column_forward_matmul(xt, wt, theta, spec_t))
    _eq(want["ref"], t_ref.column_forward_ref(xt, wt, theta, T))
    # WTA on the crossing times and on times full of ties
    for k, zz in enumerate((z_t, torch.from_numpy(ties))):
        _eq(want["wta"][k], t_column.wta_inhibit(zz, spec_t))
        _eq(want["wta_ref"][k], t_ref.wta_ref(zz, T))
    # the shared kernel bodies: A@N product, crossing + WTA
    Vm_t = t_tnn_column.ramp_matmul(xt, wt, T=T)
    _eq(want["Vm"], Vm_t)
    for k, wta in enumerate((False, True)):
        _eq(want["cw"][k], t_tnn_column.crossing_wta(
            Vm_t.reshape(B, T, q), T=T, theta=theta, wta=wta))


def test_init_weights_range_and_generator():
    """Same key, same weights (a key now, as in the reference; the name is
    the test's from before the port drew threefry bits), in range, and the
    reference's ``init_weights`` from that key bit for bit."""
    spec = t_temporal.WaveSpec()
    w1 = t_column.init_weights(t_random.PRNGKey(3), 32, 12, spec, device="cpu")
    w2 = t_column.init_weights(t_random.PRNGKey(3), 32, 12, spec, device="cpu")
    assert w1.dtype == torch.int8 and tuple(w1.shape) == (32, 12)
    assert torch.equal(w1, w2)
    assert int(w1.min()) >= 0 and int(w1.max()) <= spec.w_max
    _eq(j_column.init_weights(jax.random.PRNGKey(3), 32, 12, j_temporal.WaveSpec()), w1)


@pytest.mark.parametrize("learn", [True, False])
def test_column_step_matches_the_reference(learn):
    """One gamma wave of a p = 24, q = 6 column on a batch of 16: the post-WTA
    times and the new weights equal ``repro.core.column_step``'s from the
    same x, w and key, bit for bit; learning without a key raises."""
    rng = np.random.default_rng(11)
    spec_j, spec_t = j_temporal.WaveSpec(), t_temporal.WaveSpec()
    x = _spikes(rng, (16, 24), spec_t.T)
    w = _weights(rng, (24, 6), spec_t.w_max)
    cfg_j = j_column.ColumnConfig(p=24, q=6, theta=20)
    cfg_t = t_column.ColumnConfig(p=24, q=6, theta=20)
    z_j, w_j = jax.jit(lambda x, w, k: j_column.column_step(x, w, cfg_j, k, learn))(
        x, w, jax.random.PRNGKey(7))
    z_t, w_t = t_column.column_step(torch.from_numpy(x), torch.from_numpy(w), cfg_t,
                                    t_random.PRNGKey(7), learn)
    assert z_t.dtype == torch.uint8 and w_t.dtype == torch.int8
    _eq(z_j, z_t)
    _eq(w_j, w_t)
    assert learn == (not np.array_equal(w_t.numpy(), w))
    if learn:
        with pytest.raises(ValueError, match="requires an rng key"):
            t_column.column_step(torch.from_numpy(x), torch.from_numpy(w), cfg_t)


# -- launch plans ---------------------------------------------------------------


@pytest.mark.parametrize("b,p,block_b,block_p,p_align", [
    (5, 20, 64, 256, 8), (64, 32, 64, 512, 8), (130, 600, 32, 256, 16),
    (1, None, 64, 256, 8),
])
def test_pad_plan(b, p, block_b, block_p, p_align):
    jp = j_padding.PadPlan.make(b, p, block_b=block_b, block_p=block_p,
                                p_align=p_align, interpret=True)
    tp = t_padding.PadPlan.make(b, p, block_b=block_b, block_p=block_p,
                                p_align=p_align)
    want = {k: v for k, v in dataclasses.asdict(jp).items() if k != "interpret"}
    assert dataclasses.asdict(tp) == want
    assert tp.n_b == jp.n_b
    assert t_padding.pad_to(b, 8) == j_padding.pad_to(b, 8)
    if p is None:
        return
    rng = np.random.default_rng(b)
    x = _spikes(rng, (b, 3, p), 8)
    w = _weights(rng, (3, p, 4), 7)
    u = _uniforms(rng, (3, b, p, 4))
    _eq(jp.pad_spikes(jnp.asarray(x), 8, b_axis=0, p_axis=2),
        tp.pad_spikes(torch.from_numpy(x), 8, b_axis=0, p_axis=2))
    _eq(jp.pad_weights(jnp.asarray(w), p_axis=1),
        tp.pad_weights(torch.from_numpy(w), p_axis=1))
    _eq(jp.pad_uniforms(jnp.asarray(u), b_axis=1, p_axis=2),
        tp.pad_uniforms(torch.from_numpy(u), b_axis=1, p_axis=2))
    rows = j_padding.pad_to(b, 8)
    _eq(j_padding.pad_batch_rows(jnp.asarray(x), rows, 8),
        t_padding.pad_batch_rows(torch.from_numpy(x), rows, 8))
    with pytest.raises(ValueError):
        t_padding.pad_batch_rows(torch.from_numpy(x), b - 1, 8)


def _pair_net(C, ps_qs, thetas, time_bits=3, n_cols2=None):
    """The same N-layer network in both packages."""
    out = []
    for mod_col, mod_temporal, L, N in (
            (j_column, j_temporal, JLayerConfig, JNetworkConfig),
            (t_column, t_temporal, TLayerConfig, TNetworkConfig)):
        wave = mod_temporal.WaveSpec(time_bits=time_bits)
        layers = tuple(
            L(C if (i == 0 or n_cols2 is None) else n_cols2,
              mod_col.ColumnConfig(p=p, q=q, theta=th, wave=wave))
            for i, ((p, q), th) in enumerate(zip(ps_qs, thetas)))
        out.append(N(layers=layers))
    return out


@pytest.mark.parametrize("C,ps_qs,thetas,n_cols2", [
    (4, ((32, 12), (12, 10)), (12, 3), None),            # the prototype's columns
    (3, ((20, 6), (6, 5), (5, 4)), (5, 2, 1), None),     # depth 3
    (2, ((512, 128), (128, 128)), (40, 3), None),        # the fused caps
    (2, ((513, 12),), (40,), None),                      # padded p1 over the cap
    (2, ((32, 129),), (20,), None),                      # q over 128 lanes
    (2, ((32, 12), (11, 10)), (12, 3), None),            # broken chain
    (4, ((32, 12), (12, 10)), (12, 3), 9),               # different site counts
])
def test_fused_wave_capable_and_plan(C, ps_qs, thetas, n_cols2):
    jcfg, tcfg = _pair_net(C, ps_qs, thetas, n_cols2=n_cols2)
    capable = j_padding.fused_wave_capable(jcfg)
    assert t_padding.fused_wave_capable(tcfg) == capable
    if not capable:
        with pytest.raises(ValueError, match="not fused-wave capable"):
            t_padding.network_plan(tcfg, 5)
        return
    for B in (5, 64):
        jp = j_padding.network_plan(jcfg, B, block_b=64, interpret=True)
        tp = t_padding.network_plan(tcfg, B)
        for f in ("n_cols", "ps", "qs", "thetas", "T", "w_max", "tables",
                  "mus", "packed", "n_layers", "pps"):
            assert getattr(tp, f) == getattr(jp, f), f
        assert (tp.pad.b, tp.pad.p, tp.pad.bp, tp.pad.pp) == (
            jp.pad.b, jp.pad.p, jp.pad.bp, jp.pad.pp)


def test_network_plan_t_guard():
    """T >= 255 cannot be held by the uint8 spike encoding."""
    _, tcfg = _pair_net(2, ((32, 12),), (12,), time_bits=8)
    with pytest.raises(ValueError, match="T=256"):
        t_padding.network_plan(tcfg, 4)
