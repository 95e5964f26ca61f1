"""The port's per-layer kernel wrappers (``repro_torch.kernels.ops``, on the
CPU their plain versions, which the Hopper kernels are held against on the
card) against the JAX reference's ``repro.kernels.ops`` (Pallas, in
interpret mode on the CPU).

Spike times, weights and STDP uniforms are made with numpy from a seed and
handed to both. Every output is an integer (spike times, counters,
weights), so every comparison is exact."""
import numpy as np
import pytest
import torch

from repro.core.stdp import default_stabilize_table
from repro.kernels import ops as j_ops

from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import stdp_update as t_stdp_update
from repro_torch.kernels import tnn_column as t_tnn_column
from repro_torch.kernels import wta as t_wta
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

T = 8
W_MAX = 7
TABLE = default_stabilize_table(W_MAX)
LAUNCHES = (t_tnn_column.LAUNCHES, t_stdp_update.LAUNCHES, t_wta.LAUNCHES)


def _eq(a, b):
    assert b.dtype == torch.int32, b.dtype
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _spikes(rng, shape):
    return rng.integers(0, T + 1, shape).astype(np.uint8)


def _uniforms(rng, shape, kind):
    if kind == "zeros":  # every nonzero probability fires
        return np.zeros(shape, np.float32)
    if kind == "ones":   # nothing fires
        return np.ones(shape, np.float32)
    return rng.random(shape, dtype=np.float32)


@pytest.fixture(autouse=True)
def no_launches_on_the_cpu():
    """The plain versions never count as kernel launches."""
    before = [c.n for c in LAUNCHES]
    yield
    assert [c.n for c in LAUNCHES] == before


@pytest.mark.parametrize("wta", [False, True])
@pytest.mark.parametrize("B,p,q,theta", [
    (4, 16, 5, 12), (7, 100, 12, 40), (3, 1024, 16, 600),
])
def test_column_forward(B, p, q, theta, wta):
    rng = np.random.default_rng(B * p + q)
    x = _spikes(rng, (B, p))
    w = rng.integers(0, W_MAX + 1, (p, q)).astype(np.int8)
    want = j_ops.column_forward(x, w, theta=theta, T=T, wta=wta)
    got = t_ops.column_forward(torch.from_numpy(x), torch.from_numpy(w),
                               theta=theta, T=T, wta=wta)
    assert tuple(got.shape) == (B, q)
    _eq(want, got)
    assert int((got < T).sum()) > 0  # something crosses: a real check


def test_column_forward_silent_rows_stay_silent():
    """Rows with no input spike, and a threshold out of reach, give T under
    WTA: the winner of an all-T row never passes."""
    rng = np.random.default_rng(3)
    x = _spikes(rng, (6, 32))
    x[2] = T
    w = rng.integers(0, W_MAX + 1, (32, 12)).astype(np.int8)
    for theta in (20, 32 * W_MAX):
        want = j_ops.column_forward(x, w, theta=theta, T=T, wta=True)
        got = t_ops.column_forward(torch.from_numpy(x), torch.from_numpy(w),
                                   theta=theta, T=T, wta=True)
        _eq(want, got)
        assert bool((got[2] == T).all())


@pytest.mark.parametrize("rows,q,kind", [
    (20, 12, "random"), (9, 128, "random"), (16, 10, "ties"), (5, 7, "silent"),
])
def test_wta(rows, q, kind):
    rng = np.random.default_rng(rows + q)
    if kind == "ties":  # many equal earliest times in a row
        z = rng.integers(T - 2, T + 1, (rows, q))
    elif kind == "silent":
        z = np.full((rows, q), T)
        z[1, 3] = T - 1
    else:
        z = rng.integers(0, T + 1, (rows, q))
    z = z.astype(np.int32)
    got = t_ops.wta(torch.from_numpy(z), T=T)
    _eq(j_ops.wta(z, T=T), got)
    assert int(((got < T).sum(-1) <= 1).all())


@pytest.mark.parametrize("out", ["weights", "net"])
@pytest.mark.parametrize("B,p,q,kind", [
    (6, 32, 12, "random"), (5, 12, 10, "random"), (4, 20, 7, "zeros"),
    (4, 20, 7, "ones"),
])
def test_stdp_update(B, p, q, kind, out):
    rng = np.random.default_rng(B * p * q)
    w = rng.integers(0, W_MAX + 1, (p, q)).astype(np.int8)
    w[0, :2] = (0, W_MAX)  # both rails
    x, z = _spikes(rng, (B, p)), _spikes(rng, (B, q))
    u = _uniforms(rng, (2, B, p, q), kind)
    want = j_ops.stdp_update(w, x, z, u[0], u[1], T=T, w_max=W_MAX,
                             table=TABLE, out=out)
    ut = torch.from_numpy(u)
    got = t_ops.stdp_update(torch.from_numpy(w), torch.from_numpy(x),
                            torch.from_numpy(z), ut[0], ut[1], T=T,
                            w_max=W_MAX, table=TABLE, out=out)
    _eq(want, got)
    moved = got if out == "net" else got - torch.from_numpy(w).to(torch.int32)
    assert (int(moved.abs().sum()) == 0) == (kind == "ones")


@pytest.mark.parametrize("B", [8, 5])
def test_layer_forward_and_stdp_fused(B):
    """Both layer entry points at 16 sites: layer 1's shape, then layer 2's
    fed by layer 1's output; STDP in both out modes on the reference's
    (C, 2, B, p, q) uniform layout, handed over as strided views."""
    rng = np.random.default_rng(B)
    C = 16
    x = _spikes(rng, (B, C, 32))
    for p, q, theta in ((32, 12, 12), (12, 10, 3)):
        w = rng.integers(0, W_MAX + 1, (C, p, q)).astype(np.int8)
        z_j = j_ops.layer_forward_fused(x, w, theta=theta, T=T)
        z_t = t_ops.layer_forward_fused(torch.from_numpy(x), torch.from_numpy(w),
                                        theta=theta, T=T)
        _eq(z_j, z_t)
        assert int((z_t < T).sum()) > 0
        z = np.asarray(z_j).astype(np.uint8)
        u = rng.random((C, 2, B, p, q), dtype=np.float32)
        ut = torch.from_numpy(u)
        for out in ("weights", "net"):
            want = j_ops.layer_stdp_fused(w, x, z, u[:, 0], u[:, 1], T=T,
                                          w_max=W_MAX, table=TABLE, out=out)
            got = t_ops.layer_stdp_fused(
                torch.from_numpy(w), torch.from_numpy(x), torch.from_numpy(z),
                ut[:, 0], ut[:, 1], T=T, w_max=W_MAX, table=TABLE, out=out)
            _eq(want, got)
        x = z


def test_wrappers_reject_other_devices_and_bad_modes():
    x = torch.empty((2, 4, 32), dtype=torch.uint8, device="meta")
    w = torch.empty((4, 32, 12), dtype=torch.int8, device="meta")
    z = torch.empty((2, 4, 12), dtype=torch.uint8, device="meta")
    u = torch.empty((4, 2, 32, 12), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        t_ops.layer_forward_fused(x, w, theta=3)
    with pytest.raises(ValueError, match="cpu or cuda"):
        t_ops.layer_stdp_fused(w, x, z, u, u, table=TABLE)
    with pytest.raises(ValueError, match="cpu or cuda"):
        t_ops.wta(z[0])
    xc, wc, zc = (torch.zeros(t.shape, dtype=t.dtype) for t in (x, w, z))
    uc = torch.zeros(u.shape)
    with pytest.raises(ValueError, match="out="):
        t_ops.layer_stdp_fused(wc, xc, zc, uc, uc, table=TABLE, out="both")
    with pytest.raises(ValueError, match="table"):
        t_ops.layer_stdp_fused(wc, xc, zc, uc, uc, table=())
