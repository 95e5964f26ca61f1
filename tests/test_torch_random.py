"""``repro_torch.random`` against ``jax.random``, bit for bit: the
Threefry-2x32 known-answer vector, ``PRNGKey``, ``split``, ``uniform``
(float32) and ``randint`` (int8 and others) on a few keys and shapes, and
the draws the TNN makes from them (``init_weights``, ``init_layer``,
``init_network``, ``layer_uniforms``), including one column and an odd
shape. The threefry kernel's wrapper runs its plain version on the CPU."""
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
from repro_torch.kernels import threefry as t_threefry
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

SEEDS = (0, 1, 7, 2**32 - 1, 123456789012)
SHAPES = ((5,), (2, 7, 11, 9))


def _eq(a, b):
    a, b = np.asarray(a), b.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _bits_eq(a, b):
    a, b = np.asarray(a), b.numpy()
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_reference_draws_with_partitionable_threefry():
    """The bits below are those of jax_threefry_partitionable=True; a change
    of the reference's default fails here by name."""
    assert jax.config.jax_threefry_partitionable is True


def test_known_answer_vector():
    """Random123's (and JAX's) Threefry-2x32 test vector."""
    a, b = t_random.threefry2x32(0x13198A2E, 0x03707344,
                                 torch.tensor(0x243F6A88), torch.tensor(0x85A308D3))
    assert (int(a), int(b)) == (0xC4923A9C, 0x483DF7A0)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_uniform(seed):
    jk, tk = jax.random.PRNGKey(seed), t_random.PRNGKey(seed)
    _eq(jk, tk)
    _eq(jax.random.split(jk), t_random.split(tk))
    _eq(jax.random.split(jk, 5), t_random.split(tk, 5))
    # past SMALL_SPLIT the split runs as tensors, not Python ints
    _eq(jax.random.split(jk, t_random.SMALL_SPLIT + 3),
        t_random.split(tk, t_random.SMALL_SPLIT + 3))
    for shape in SHAPES:
        _bits_eq(jax.random.uniform(jk, shape, dtype=jnp.float32),
                 t_random.uniform(tk, shape))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_randint(seed):
    jk, tk = jax.random.PRNGKey(seed), t_random.PRNGKey(seed)
    for shape, lo, hi, jdt, tdt in (((2, 7, 11, 9), 0, 8, jnp.int8, torch.int8),
                                    ((5,), 0, 5, jnp.int8, torch.int8),
                                    ((5,), -3, 100, jnp.int32, torch.int32),
                                    ((5,), 0, 300, jnp.uint8, torch.uint8)):
        _eq(jax.random.randint(jk, shape, lo, hi, dtype=jdt),
            t_random.randint(tk, shape, lo, hi, tdt))


def test_batched_keys_are_a_vmap():
    """A batch of keys draws as jax.vmap of the draw over them: each key
    over its own counter from 0."""
    jks = jax.random.split(jax.random.PRNGKey(3), 4)
    tks = t_random.split(t_random.PRNGKey(3), 4)
    _bits_eq(jax.vmap(lambda k: jax.random.uniform(k, (2, 3, 4)))(jks),
             t_random.uniform(tks, (2, 3, 4)))
    _eq(jax.vmap(lambda k: jax.random.split(k, 3))(jks), t_random.split(tks, 3))
    _eq(jax.vmap(lambda k: jax.random.randint(k, (3, 2), 0, 8, jnp.int8))(jks),
        t_random.randint(tks, (3, 2), 0, 8, torch.int8))


def test_keys_from_numpy_and_back():
    """JAX key data (numpy uint32) is a port key as it is; bad words raise."""
    jk = jax.random.split(jax.random.PRNGKey(11))[1]
    tk = t_random.as_key(np.asarray(jk))
    assert tk.dtype == torch.uint32 and tuple(tk.shape) == (2,)
    _eq(jax.random.split(jk, 3), t_random.split(tk, 3))
    assert t_random.key_words(tk) == tuple(int(w) for w in np.asarray(jk))
    with pytest.raises(ValueError):
        t_random.as_key(np.array([1, 2, 3], np.uint32))
    with pytest.raises(ValueError):
        t_random.as_key(np.array([-1, 2], np.int64))


def test_tnn_draws():
    """init_network and both layers' layer_uniforms of the prototype at 4
    sites (the training tests hold 16 sites to the reference through whole
    train steps), the layer uniforms of a single column and of an odd
    3-column 11x9 layer, from the reference's keys. The reference's draws
    run under one jit (integer hashing and an exact float build: the same
    bits as eager, compiled once)."""
    jcfg = j_tnn_mnist.network_config(4, 12, 3)
    tcfg = t_tnn_mnist.network_config(4, 12, 3)
    col_j, col_t = jcfg.layers[0].column, tcfg.layers[0].column
    one_j, one_t = j_layer.LayerConfig(1, col_j), t_layer.LayerConfig(1, col_t)
    odd_j = j_layer.LayerConfig(3, col_j.__class__(p=11, q=9, theta=3))
    odd_t = t_layer.LayerConfig(3, col_t.__class__(p=11, q=9, theta=3))

    @jax.jit
    def reference(k_init, k_u, k_odd):
        return (j_network.init_network(k_init, jcfg),
                [j_layer.layer_uniforms(k_u, l, 2) for l in jcfg.layers],
                j_layer.layer_uniforms(k_u, one_j, 2),
                j_layer.layer_uniforms(k_odd, odd_j, 1))

    jk = jax.random.split(jax.random.PRNGKey(6))[1]
    params_j, us_j, one_u, odd_u = reference(jax.random.PRNGKey(5), jk,
                                             jax.random.PRNGKey(9))
    for a, b in zip(params_j, t_network.init_network(t_random.PRNGKey(5), tcfg,
                                                     device="cpu")):
        _eq(a, b)
    for u, tl in zip(us_j, tcfg.layers):
        _bits_eq(u, t_layer.layer_uniforms(np.asarray(jk), tl, 2, device="cpu"))
    _bits_eq(one_u, t_layer.layer_uniforms(np.asarray(jk), one_t, 2, device="cpu"))
    _bits_eq(odd_u, t_layer.layer_uniforms(t_random.PRNGKey(9), odd_t, 1, device="cpu"))


def test_threefry_wrapper_runs_its_plain_version_on_the_cpu():
    """On the CPU the kernel's wrapper is its plain version (uniform over the
    column keys) and launches nothing."""
    key = t_random.PRNGKey(4)
    before = t_threefry.LAUNCHES.n
    u = t_threefry.layer_uniforms(key, 3, (2, 5, 4, 3), device="cpu")
    assert u.dtype == torch.float32 and tuple(u.shape) == (3, 2, 5, 4, 3)
    want = torch.stack([t_random.uniform(k, (2, 5, 4, 3))
                        for k in t_random.split(key, 3)])
    assert torch.equal(u.view(torch.int32), want.view(torch.int32))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert t_threefry.LAUNCHES.n == before


@pytest.mark.parametrize("lo,hi", [(-3.7, 2.9), (0.3, 1.7), (5.0, 1000.5)])
def test_uniform_minval_maxval(lo, hi):
    """``max(minval, floats * span + minval)``, the product and the sum fused
    as XLA's CPU backend fuses them: 30,000 draws a range."""
    jk = jax.random.PRNGKey(3)
    _bits_eq(jax.random.uniform(jk, (30_000,), jnp.float32, lo, hi),
             t_random.uniform(t_random.PRNGKey(3), (30_000,), minval=lo, maxval=hi))


def test_normal_matches_jax_bit_for_bit():
    """160,000 standard normals over four keys (one jit of the reference's
    draws), a vmap over a batch of keys, and the same normals built from
    the unit floats the threefry kernel's wrapper draws per column."""
    keys = [0, 7, 2**32 - 1, 123456789012]
    draw = jax.jit(lambda k: jax.random.normal(k, (40_000,), jnp.float32))
    for seed in keys:
        _bits_eq(draw(jax.random.PRNGKey(seed)),
                 t_random.normal(t_random.PRNGKey(seed), (40_000,)))
    jks = jax.random.split(jax.random.PRNGKey(3), 5)
    want = jax.vmap(lambda k: jax.random.normal(k, (32, 12)))(jks)
    tks = t_random.split(t_random.PRNGKey(3), 5)
    _bits_eq(want, t_random.normal(tks, (32, 12)))
    floats = t_threefry.layer_uniforms(t_random.PRNGKey(3), 5, (32, 12), device="cpu")
    _bits_eq(want, t_random.unit_to_normal(floats))


def test_erf_inv_edges():
    """``erf_inv`` at +-1 (+-inf), 0, +-nextafter(-1, 0) (the normal's
    lowest draw), and 4,001 consecutive floats on each side of the w = 5
    branch point (|x| = sqrt(1 - exp(-5))), against ``lax.erf_inv``."""
    lo = np.float32(t_random.NORMAL_LO)
    x5 = np.float32(np.sqrt(1 - np.exp(-5.0)))
    around = x5.view(np.int32) + np.arange(-2000, 2001, dtype=np.int32)
    x = np.concatenate([
        np.array([1.0, -1.0, 0.0, -0.0, lo, -lo, 0.5, -0.5], np.float32),
        around.view(np.float32), -around.view(np.float32)])
    want = jax.jit(jax.lax.erf_inv)(jnp.asarray(x))
    got = t_random.erf_inv(torch.from_numpy(x))
    _bits_eq(want, got)
    assert np.isinf(got[:2].numpy()).all()
    w = -t_random._log1p(torch.from_numpy(x[8:]) * -torch.from_numpy(x[8:]))
    assert bool((w < 5).any()) and bool((w >= 5).any())


def test_sqrt32_is_correctly_rounded():
    """The float32 root the normal and the gauss update take: numpy's
    (correctly rounded) on 200,000 floats, zeros and whole counts."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.random(100_000, np.float32) * 50,
                        np.exp(rng.normal(0, 20, 100_000)).astype(np.float32),
                        np.arange(0, 64, dtype=np.float32)])
    got = t_random.sqrt32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), np.sqrt(x).view(np.uint32))


def test_counter_offset_draws_a_window():
    """``random_bits``/``normal`` with an offset give the window of the
    longer draw's flat elements (how the LM weights are drawn in chunks)."""
    key = t_random.PRNGKey(11)
    full = jax.random.normal(jax.random.PRNGKey(11), (3, 50_000), jnp.float32)
    flat = np.asarray(full).reshape(-1)
    for lo, n in ((0, 1000), (49_990, 20), (123_456, 26_544)):
        got = t_random.normal(key, (n,), offset=lo)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      flat[lo:lo + n].view(np.uint32))
    np.testing.assert_array_equal(
        t_random.random_bits(key, (7,), offset=5).numpy(),
        t_random.random_bits(key, (12,)).numpy()[5:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gumbel_and_categorical_match_jax(dtype):
    """Gumbel draws (40,000 over each of three keys) bit for bit, and
    ``categorical`` (the Gumbel-max argmax) on the same logits."""
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    for seed in (0, 7, 2**32 - 1):
        want = jax.random.gumbel(jax.random.PRNGKey(seed), (8, 5000), jdt)
        got = t_random.gumbel(t_random.PRNGKey(seed), (8, 5000), dtype=tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(np.asarray(want.astype(jnp.float32)).view(np.uint32),
                                      got.float().numpy().view(np.uint32))
    logits = np.random.default_rng(0).standard_normal((6, 300)).astype(np.float32)
    for seed in (1, 2, 3):
        want = jax.random.categorical(jax.random.PRNGKey(seed), jnp.asarray(logits, jdt))
        got = t_random.categorical(t_random.PRNGKey(seed), torch.from_numpy(logits).to(tdt))
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
