"""repro_torch's network layer against the JAX reference: the digit
generator, the image encoder (at 16 sites and at the full 28x28 /
625-site field), network_forward and network_train_wave (with the
reference's own uniform draws handed across), the vote table and the
site-vote classifier. Every comparison is exact, except that a class id
may differ on a row whose two best reference vote sums lie within 1e-6
(relative) — such rows are counted and, with these seeds, there are
none."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tnn_mnist as j_tnn_mnist
from repro.core import layer as j_layer
from repro.core import network as j_network
from repro.data.mnist_like import digits as j_digits

from repro_torch import convert
from repro_torch.configs import tnn_mnist as t_tnn_mnist
from repro_torch.core import layer as t_layer
from repro_torch.core import network as t_network
from repro_torch.data.mnist_like import digits as t_digits
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

T = 8


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def vote_ties(vote_sums: np.ndarray, rel: float = 1e-6) -> np.ndarray:
    """Rows whose two largest vote sums lie within ``rel`` of each other."""
    top2 = np.sort(vote_sums, axis=-1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) <= rel * np.abs(top2[:, 1])


def test_digits_copy_matches():
    for n, seed in ((5, 0), (33, 2)):
        ji, jl = j_digits(n, seed=seed)
        ti, tl = t_digits(n, seed=seed)
        np.testing.assert_array_equal(ji, ti)
        np.testing.assert_array_equal(jl, tl)


@pytest.mark.parametrize("sites", [16, 625])
def test_encode_images(sites):
    """Spike times equal the reference's as it runs op by op (its
    definition: surround sum, then / 9.0). Under jit, as the reference's
    serving engine runs it, XLA on the CPU turns ``x - s / 9`` into
    ``fma(s, -1/9, x)``: the DoG values move by an ulp, which moves spike
    times only for pixel values on a rounding edge (image 0 here is built
    of such values); on the digits themselves the two agree."""
    jcfg = j_tnn_mnist.network_config(sites, 12, 3)
    tcfg = t_tnn_mnist.network_config(sites, 12, 3)
    imgs = np.ascontiguousarray(j_tnn_mnist.crop_field(j_digits(24, seed=3)[0], sites))
    imgs[0] = np.round(imgs[0] * 16) / 16  # values on the rounding edges
    ji = jnp.asarray(imgs)
    c_j = j_network.dog_filter(ji) * 3.0
    it = torch.from_numpy(imgs)
    _eq(j_network.dog_filter(ji), t_network.dog_filter(it))
    c_t = t_network.dog_filter(it) * 3.0
    _eq(j_layer.extract_patches(jnp.clip(c_j, 0.0, 1.0), 4),
        t_layer.extract_patches(c_t.clamp(0.0, 1.0), 4))
    x_t = t_network.encode_images(it, tcfg)
    assert x_t.dtype == torch.uint8 and tuple(x_t.shape) == (24, sites, 32)
    _eq(j_network.encode_images(ji, jcfg), x_t)
    _eq(jax.jit(lambda im: j_network.encode_images(im, jcfg))(ji)[1:], x_t[1:])
    assert int((x_t < T).sum()) > 0


def test_encode_patches_onoff():
    rng = np.random.default_rng(4)
    v = np.concatenate([np.arange(-1, 18) / 16.0,
                        rng.random(45)]).astype(np.float32).reshape(2, 4, 8)
    _eq(j_layer.encode_patches_onoff(jnp.asarray(v), j_network.WaveSpec()),
        t_layer.encode_patches_onoff(torch.from_numpy(v), t_network.WaveSpec()))


def _net_case(depth, sites):
    """A depth-N cascade whose every layer fires on digits: thresholds
    (12, 3, 1), as late deep volleys need a low threshold."""
    widths, thetas = (12,) * (depth - 1) + (10,), (12, 3, 1)[:depth]
    jcfg = j_tnn_mnist.deep_config(sites, widths, thetas, impl="fused")
    tcfg = t_tnn_mnist.deep_config(sites, widths, thetas, impl="fused")
    rng = np.random.default_rng(depth)
    params = [rng.integers(0, 8, (l.n_cols, l.column.p, l.column.q)).astype(np.int8)
              for l in jcfg.layers]
    imgs = t_tnn_mnist.crop_field(t_digits(8, seed=5)[0], sites)
    return jcfg, tcfg, params, np.ascontiguousarray(imgs)


def test_network_train_wave_with_reference_draws():
    """One learning wave: the reference draws its own uniforms (per layer,
    per column); the same draws are handed across, and the port draws its
    own from the same key, and each of the port's four backends reproduces
    the reference's outputs and weights either way."""
    jcfg, tcfg, params, imgs = _net_case(2, 4)
    B = imgs.shape[0]
    key = jax.random.PRNGKey(7)

    @jax.jit
    def reference(x, ps):
        zs, new = j_network.network_train_wave(x, list(ps), jcfg, key)
        keys = jax.random.split(key, len(jcfg.layers))
        us = [j_layer.layer_uniforms(k, l, B) for k, l in zip(keys, jcfg.layers)]
        return zs, new, us

    x_j = j_network.encode_images(jnp.asarray(imgs), jcfg)
    zs_j, new_j, us = reference(x_j, tuple(params))
    x_t = t_network.encode_images(torch.from_numpy(imgs), tcfg)
    ut = [torch.from_numpy(np.array(u)) for u in us]
    for impl in ("fused", "direct", "pallas", "matmul"):
        cfg = t_network.with_impl(tcfg, impl)
        pt = convert.params_from_numpy(params, cfg, device="cpu")
        zs_t, new_t = t_network.network_train_wave(x_t, pt, cfg, uniforms=ut)
        zs_d, new_d = t_network.network_train_wave(x_t, pt, cfg, np.asarray(key))
        for a, b, c in zip(zs_j, zs_t, zs_d):
            _eq(a, b)
            _eq(a, c)
        for a, b, c in zip(new_j, new_t, new_d):
            assert b.dtype == torch.int8 and c.dtype == torch.int8
            _eq(a, b)
            _eq(a, c)
        assert [int((z < T).sum()) for z in zs_t] == [
            int((np.asarray(z) < T).sum()) for z in zs_j]
    assert all(int((np.asarray(z) < T).sum()) > 0 for z in zs_j)
    assert any(not np.array_equal(np.asarray(a), b) for a, b in zip(new_j, params))


@pytest.mark.parametrize("depth,sites", [(2, 16)])
def test_forward_vote_table_and_classify(depth, sites):
    """network_forward on the labelled set, then the vote table it builds
    and the class ids it gives, soft and hard vote. The requests are the
    rows of a seeded pool that the reference's own vote sums leave neither
    silent nor tied, so every class id is compared exactly."""
    jcfg, tcfg, params, _ = _net_case(depth, sites)
    imgs, labels = t_digits(32, seed=1)
    imgs = np.ascontiguousarray(t_tnn_mnist.crop_field(imgs, sites))
    pool = np.ascontiguousarray(t_tnn_mnist.crop_field(t_digits(40, seed=2)[0], sites))

    @jax.jit
    def reference(lab_x, test_x, ps):
        zl = j_network.network_forward(lab_x, list(ps), jcfg)
        vt = j_network.build_vote_table(zl[-1], jnp.asarray(labels), 10, T)
        zt = j_network.network_forward(test_x, list(ps), jcfg)
        winner, fired = j_network.winner_map(zt[-1], T)
        post = vt / jnp.maximum(vt.sum(axis=-1, keepdims=True), 1.0)
        sums = (post[jnp.arange(vt.shape[0])[None, :], winner]
                * fired[..., None]).sum(axis=1)
        return (zl, vt, zt, sums, j_network.classify(zt[-1], vt, T),
                j_network.classify(zt[-1], vt, T, soft=False))

    zl_j, vt_j, zt_j, sums_j, cls_j, hard_j = reference(
        j_network.encode_images(jnp.asarray(imgs), jcfg),
        j_network.encode_images(jnp.asarray(pool), jcfg), tuple(params))
    rows = np.flatnonzero(~vote_ties(np.asarray(sums_j)))
    assert rows.size >= 24, rows.size
    for impl in ("fused", "direct", "pallas", "matmul"):
        cfg = t_network.with_impl(tcfg, impl)
        pt = convert.params_from_numpy(params, cfg, device="cpu")
        zl_t = t_network.network_forward(
            t_network.encode_images(torch.from_numpy(imgs), cfg), pt, cfg)
        for a, b in zip(zl_j, zl_t):
            _eq(a, b)
        vt_t = t_network.build_vote_table(zl_t[-1], torch.from_numpy(labels), 10, T)
        _eq(vt_j, vt_t)
        zt_t = t_network.network_forward(
            t_network.encode_images(torch.from_numpy(pool), cfg), pt, cfg)
        for a, b in zip(zt_j, zt_t):
            _eq(a, b)
        z_req = zt_t[-1][torch.from_numpy(rows)]
        np.testing.assert_allclose(
            np.asarray(sums_j)[rows], t_network.vote_sums(z_req, vt_t, T).numpy(),
            rtol=1e-6, atol=0)
        _eq(np.asarray(cls_j)[rows], t_network.classify(z_req, vt_t, T))
        _eq(np.asarray(hard_j)[rows], t_network.classify(z_req, vt_t, T, soft=False))
    assert float(np.asarray(vt_j).sum()) > 0


def test_refresh_vote_table_pads_ragged_chunks():
    """The chunked labelling pass equals one unchunked forward: the ragged
    tail's no-op pad rows never reach the table."""
    _, tcfg, params, _ = _net_case(2, 4)
    imgs, labels = t_digits(11, seed=6)
    x = t_network.encode_images(torch.from_numpy(
        np.ascontiguousarray(t_tnn_mnist.crop_field(imgs, 4))), tcfg)
    pt = convert.params_from_numpy(params, tcfg, device="cpu")

    def fwd(ps, xx):
        return t_network.network_forward(xx, list(ps), tcfg)[-1]

    vt = t_network.refresh_vote_table(fwd, pt, x, labels, tcfg, batch=4)
    whole = t_network.build_vote_table(fwd(pt, x), torch.from_numpy(labels), 10, T)
    assert torch.equal(vt, whole)
    assert float(vt.sum()) == float((fwd(pt, x) < T).any(-1).sum())


def test_with_impl_and_configs():
    for sites, depth in ((625, 2), (16, 2), (9, 3), (4, 1)):
        j = j_tnn_mnist.launcher_network_config(sites, depth=depth)
        t = t_tnn_mnist.launcher_network_config(sites, depth=depth)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (j.n_neurons, j.n_synapses) == (t.n_neurons, t.n_synapses)
    assert t_tnn_mnist.default_thetas(625) == j_tnn_mnist.default_thetas(625)
    assert t_tnn_mnist.image_side(625) == 28
    with pytest.raises(ValueError):
        t_tnn_mnist.image_side(10)
    base = t_tnn_mnist.network_config(16, 12, 3)
    assert t_network.PORTED_IMPLS == j_network.ColumnConfig.IMPLS
    for impl in ("direct", "matmul", "pallas", "fused"):
        cfg = t_network.with_impl(base, impl)
        assert {l.column.impl for l in cfg.layers} == {impl}
        assert t_network._uses_fused_wave(cfg) == (impl == "fused")
    with pytest.raises(ValueError, match="unknown impl"):
        t_network.with_impl(base, "triton")
    # a fused network the wave kernel cannot hold runs layer by layer on
    # the per-layer kernels, as the reference's does
    wide = t_network.NetworkConfig(layers=(t_layer.LayerConfig(
        4, t_network.ColumnConfig(p=600, q=12, theta=40)),))
    fused_wide = t_network.with_impl(wide, "fused")
    assert fused_wide.layers[0].column.impl == "fused"
    assert not t_network._uses_fused_wave(fused_wide)
    assert t_network.with_impl(wide, "direct").layers[0].column.impl == "direct"


def test_params_tree_and_convert():
    _, tcfg, params, _ = _net_case(2, 4)
    pt = convert.params_from_numpy(params, tcfg, device="cpu")
    tree = {f"layer_{i:02d}": w for i, w in enumerate(params)}
    for a, b in zip(pt, convert.params_from_numpy(tree, tcfg, device="cpu")):
        assert torch.equal(a, b)
    back = convert.params_to_numpy(pt)
    for a, b in zip(back, params):
        assert a.dtype == np.int8
        np.testing.assert_array_equal(a, b)
    round_trip = t_network.params_from_tree(t_network.params_to_tree(pt), tcfg)
    assert all(torch.equal(a, b) for a, b in zip(pt, round_trip))
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_numpy([params[0][:, :5], params[1]], tcfg, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        convert.params_from_numpy([params[0] + 8, params[1]], tcfg, device="cpu")
    with pytest.raises(TypeError):
        convert.params_from_numpy([params[0].astype(np.float32), params[1]],
                                  tcfg, device="cpu")
    with pytest.raises(KeyError):
        convert.params_from_numpy({"layer_00": params[0]}, tcfg, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        t_network.params_from_tree({"layer_00": pt[0], "layer_01": pt[0]}, tcfg)


def test_vote_sum_near_ties_against_the_jitted_reference():
    """The soft-vote sums at 16 sites (``default_thetas`` = (12, 3), both
    layers fire), the port's ``vote_sums`` against the reference's
    ``jnp.sum(votes, axis=1)`` of ``classify``'s own expression under
    ``jax.jit``, on 256 unfiltered requests: the two sum in their own
    orders, so a row whose two best sums lie closer than the largest
    difference may take another class id. Such rows are counted: 70 here,
    every one an exact tie (69 requests where layer 2 stays silent and all
    sums are 0, one tie of two non-zero sums; the largest difference is
    4.8e-7, the smallest non-zero margin 0.014). Every other row's class id
    is asserted equal."""
    jcfg = j_tnn_mnist.launcher_network_config(16, impl="direct")
    tcfg = t_tnn_mnist.launcher_network_config(16, impl="direct")
    assert tcfg.layers[0].column.theta == 12 and tcfg.layers[1].column.theta == 3
    params = [np.asarray(w) for w in j_network.init_network(jax.random.PRNGKey(0), jcfg)]
    lab, labels = t_digits(32, seed=1)
    test = t_digits(256, seed=2)[0]
    lab, test = (np.ascontiguousarray(t_tnn_mnist.crop_field(a, 16)) for a in (lab, test))

    @jax.jit
    def reference(lab_x, test_x, ps):
        vt = j_network.build_vote_table(
            j_network.network_forward(lab_x, list(ps), jcfg)[-1], jnp.asarray(labels), 10, T)
        winner, fired = j_network.winner_map(
            j_network.network_forward(test_x, list(ps), jcfg)[-1], T)
        post = vt / jnp.maximum(vt.sum(axis=-1, keepdims=True), 1.0)
        votes = post[jnp.arange(vt.shape[0])[None, :], winner] * fired[..., None]
        return vt, jnp.sum(votes, axis=1)

    vt_j, sums_j = (np.asarray(a) for a in reference(
        j_network.encode_images(jnp.asarray(lab), jcfg),
        j_network.encode_images(jnp.asarray(test), jcfg), tuple(params)))
    pt = convert.params_from_numpy(params, tcfg, device="cpu")
    fwd = lambda x: t_network.network_forward(  # noqa: E731
        t_network.encode_images(torch.from_numpy(x), tcfg), pt, tcfg)[-1]
    vt_t = t_network.build_vote_table(fwd(lab), torch.from_numpy(labels), 10, T)
    _eq(vt_j, vt_t)
    assert float(vt_t.sum()) > 0
    z = fwd(test)
    sums_t = t_network.vote_sums(z, vt_t, T).numpy()
    diff = float(np.abs(sums_t - sums_j).max())
    top2 = np.sort(sums_j, axis=-1)[:, -2:]
    near = (top2[:, 1] - top2[:, 0]) <= diff
    assert 0 < diff < 1e-5
    assert int(near.sum()) == 70 and int((top2[near, 1] == 0).sum()) == 69
    assert (top2[near, 1] == top2[near, 0]).all()  # all exact ties
    cls_j = sums_j.argmax(-1)
    np.testing.assert_array_equal(cls_j[~near], t_network.classify(z, vt_t, T).numpy()[~near])
