"""The factorization the port's Hopper column and wave kernels compute on
int8 tensor cores, checked on the CPU where no kernel runs: A and N built
as int8 in the K order that ``csrc/tnn_common.cuh`` documents (Kw ramp
steps per synapse, a multiple of 4, in whole 4-byte groups, padded to whole
k32 steps) multiply in int32 to the JAX reference's ``ramp_matmul``
exactly, and crossing + WTA of that product is the port's plain
``column_forward_layer_plain``.

The K order below is this file's restatement of the header's comments, not
read from the kernels: the test checks the documented order, and the
kernels' own order is held to their plain versions bit for bit on the card
(chip_smoke.py).

Volleys and weights are made with numpy from a seed and handed to both
packages. Every value is an integer, so every comparison is exact
(tolerance 0)."""
import numpy as np
import pytest
import torch

from repro.kernels.tnn_column import ramp_matmul as j_ramp_matmul

from repro_torch.kernels import tnn_column as t_tnn_column


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def ramp_steps(T: int) -> int:
    """Ramp steps per synapse: T - 1 (no later step reaches a tick t < T)
    rounded up to a multiple of 4, so that one 4-byte fragment register
    never holds two synapses."""
    return _ceil_to(T - 1, 4)


def ramp_k_order(p: int, q: int, T: int):
    """The K axis of the kernels' product, padded to whole k32 steps:
    (synapse, ramp step) of every K index, as two int64 tensors, synapse -1
    on padding. ``tnn_layer_crossings`` keeps each synapse's
    :func:`ramp_steps` steps together, step fastest; ``tnn_layer_t8``
    (T = 8, p a multiple of 4 up to 32, q <= 16) gives the 4-byte group
    (h, tig) of k32 step s synapse 4s + tig, steps 4h+1..4h+4."""
    kw = ramp_steps(T)
    kk = torch.arange(_ceil_to(p * kw, 32))
    if T == 8 and p % 4 == 0 and p <= 32 and q <= 16:
        i = 4 * (kk // 32) + (kk // 4) % 4
        k = 4 * ((kk // 16) % 2) + kk % 4 + 1
    else:
        i, k = kk // kw, kk % kw + 1
    return torch.where(i < p, i, -1), k


def ramp_operands(x: torch.Tensor, w: torch.Tensor, *, T: int):
    """A and N of ``ramp_matmul`` as int8 in :func:`ramp_k_order`: x (Bt, Pt),
    w (Pt, q) -> A (Bt*T, K) with row ``b*T + t`` and A[., (i, k)] =
    [x[b,i] + k <= t]; N (K, q) with N[(i, k), j] = [k <= w[i,j]]; padding
    reads 0."""
    bt, p_tile = x.shape
    i, k = ramp_k_order(p_tile, w.shape[1], T)
    live = i >= 0
    ic = i.clamp_min(0)
    t = torch.arange(T, dtype=torch.int32)
    arrive = x.to(torch.int32)[:, ic] + k.to(torch.int32)           # (Bt, K)
    a = (arrive[:, None, :] <= t[:, None]) & live                    # (Bt, T, K)
    n = (k.to(torch.int32)[:, None] <= w.to(torch.int32)[ic]) & live[:, None]
    return a.to(torch.int8).reshape(bt * T, -1), n.to(torch.int8)


@pytest.mark.parametrize("p", [1, 12, 32])
@pytest.mark.parametrize("time_bits,weight_bits", [(1, 1), (3, 3), (4, 2), (7, 7)])
def test_int8_ramp_product_is_the_reference(time_bits, weight_bits, p):
    T, w_max = 1 << time_bits, (1 << weight_bits) - 1
    B, q = 5, 11
    rng = np.random.default_rng(1000 * time_bits + 10 * weight_bits + p)
    x = rng.integers(0, T + 1, (B, p)).astype(np.uint8)
    w = rng.integers(0, w_max + 1, (p, q)).astype(np.int8)

    a, n = ramp_operands(torch.from_numpy(x), torch.from_numpy(w), T=T)
    kw = ramp_steps(T)
    assert kw % 4 == 0 and T - 1 <= kw < T + 3
    syn, step = ramp_k_order(p, q, T)
    K = syn.numel()
    assert K % 32 == 0 and p * kw <= K < p * kw + 32
    assert a.dtype == n.dtype == torch.int8
    assert tuple(a.shape) == (B * T, K) and tuple(n.shape) == (K, q)
    # every synapse has each of its Kw steps once, in whole 4-byte groups
    live = syn >= 0
    assert int(live.sum()) == p * kw
    assert sorted(zip(syn[live].tolist(), step[live].tolist())) == [
        (i, k) for i in range(p) for k in range(1, kw + 1)]
    assert (syn.reshape(-1, 4) == syn.reshape(-1, 4)[:, :1]).all()
    # A's columns of synapse 0 depend on x[:, 0] alone
    x2 = x.copy()
    x2[:, 0] = T  # synapse 0 silent
    a2, _ = ramp_operands(torch.from_numpy(x2), torch.from_numpy(w), T=T)
    assert torch.equal(a2[:, syn != 0], a[:, syn != 0]) and not a2[:, syn == 0].any()

    v = a.numpy().astype(np.int32) @ n.numpy().astype(np.int32)  # (B*T, q)
    want = np.asarray(j_ramp_matmul(x.astype(np.int32), w.astype(np.int32), T=T))
    np.testing.assert_array_equal(v, want)

    theta = max(1, int(v.max()) // 2)
    for wta in (False, True):
        z = t_tnn_column.crossing_wta(torch.from_numpy(v).reshape(B, T, q),
                                      T=T, theta=theta, wta=wta)
        plain = t_tnn_column.column_forward_layer_plain(
            torch.from_numpy(x)[:, None], torch.from_numpy(w)[None],
            theta=theta, T=T, wta=wta)[:, 0]
        assert torch.equal(z, plain)
