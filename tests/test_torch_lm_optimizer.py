"""The port's LM optimizers (``repro_torch.train.optimizer``) against the JAX
package's (``repro.train.optimizer``), from the same numpy params, grads and
state: the schedule, the global norm and clipping, int8 compression with
its residual, one AdamW and one Adafactor update (factored 2-D and 3-D
leaves and 1-D leaves), the state layout and ``default_opt_for``.

The port computes every scalar as a float32 tensor in the reference's order
and every elementwise update one rounded op at a time, in place; reductions
sum in torch's order. Tolerances, in float32 ulps (the distance between the
two floats' positions in the ordered float32 line):
- the schedule over 300 steps: 4 ulps of the eager reference (measured 3,
  at 13 of 301 steps; the reference under ``jax.jit`` is 7 ulps from its
  own eager values);
- params and moments after one update (every leaf here holds at most 3,072
  floats): AdamW 2 ulps (measured 0), Adafactor 8 ulps (measured 5: its
  row and column means, and under compression a clip scale one ulp apart,
  squared into the second moment); compression's dequantised grads and
  residual exact.
- norms within 1e-6 relative (float32 sums of ~5,000 squares in two
  orders; measured 2.8e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as J

from repro_torch.models.params import tree_flatten
from repro_torch.train import optimizer as T
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

CFG = dict(lr=3e-3, warmup_steps=20, total_steps=300)
SHAPES = {"attn": {"w": (64, 48), "b": (48,)}, "trunk": {"w": (3, 32, 16)},
          "norm": {"scale": (7,)}}


def ordered(x):
    i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def ulps(a, b) -> int:
    return int(np.abs(ordered(a) - ordered(b)).max())


def _tree(seed, scale=1.0, positive=False):
    rng = np.random.default_rng(seed)
    out = {}
    for k, sub in SHAPES.items():
        out[k] = {}
        for kk, shape in sub.items():
            x = rng.standard_normal(shape).astype(np.float32) * np.float32(scale)
            out[k][kk] = np.abs(x) if positive else x
    return out


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, copy=True)), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _pairs(want, got):
    """(path, reference leaf, port leaf) in leaf order."""
    w, g = tree_flatten(jax.tree.map(np.asarray, want)), tree_flatten(got)
    assert [p for p, _ in w] == [p for p, _ in g]
    for (path, a), (_, b) in zip(w, g):
        yield path, a, b.numpy()


def test_schedule():
    jc, tc = J.OptConfig(**CFG), T.OptConfig(**CFG)
    want = np.array([np.asarray(J.schedule(jc, jnp.asarray(s, jnp.int32)))
                     for s in range(301)], np.float32)
    got = torch.stack([T.schedule(tc, s) for s in range(301)]).numpy()
    assert got.dtype == np.float32
    assert ulps(want, got) <= 4
    assert got[0] == 0.0 and got[20] == np.float32(3e-3)
    np.testing.assert_allclose(got[300], 3e-4, rtol=1e-5)
    # the tensor step (as the update passes it) gives the same values
    assert T.schedule(tc, torch.tensor(7, dtype=torch.int32)) == got[7]


def test_global_norm_and_clip():
    g = _tree(1, 0.3)
    want = float(J.global_norm(_j(g)))
    got = float(T.global_norm(_t(g)))
    assert abs(got - want) <= 1e-6 * want
    for max_norm in (1.0, 100.0):
        clipped, norm = J.clip_by_global_norm(_j(g), max_norm)
        tg = _t(g)
        out, tnorm = T.clip_by_global_norm(tg, max_norm)
        assert out is tg                                   # in place
        assert abs(float(tnorm) - float(norm)) <= 1e-6 * float(norm)
        for path, a, b in _pairs(clipped, out):
            assert ulps(a, b) <= 1, path
    assert float(T.global_norm(out)) == pytest.approx(float(tnorm), rel=1e-6)


def test_compress_decompress():
    g, r = _tree(2, 0.3), _tree(3, 0.01)
    deq, res = J.compress_decompress(_j(g), _j(r))
    tg, tr = _t(g), _t(r)
    out, tres = T.compress_decompress(tg, tr)
    assert out is tg and tres is tr
    for (path, a, b), (_, c, d) in zip(_pairs(deq, out), _pairs(res, tres)):
        np.testing.assert_array_equal(b, a, err_msg=str(path))
        np.testing.assert_array_equal(d, c, err_msg=str(path))
        # 255 levels at most, and the residual under half a step
        scale = np.abs(g_plus := np.asarray(a) + np.asarray(c)).max() / 127
        assert np.abs(d).max() <= scale / 2 + 1e-6 * np.abs(g_plus).max()


def _state(name, compress, seed=4):
    cfg = J.OptConfig(name=name, compress_grads=compress, **CFG)
    st = J.opt_init(_j(_tree(0)), cfg)
    rng = np.random.default_rng(seed)

    def fill(a, scale, positive=False):
        x = rng.standard_normal(a.shape).astype(np.float32) * np.float32(scale)
        return jnp.asarray(np.abs(x) if positive else x)

    if name == "adamw":
        st["m"] = jax.tree.map(lambda a: fill(a, 0.1), st["m"])
        st["v"] = jax.tree.map(lambda a: fill(a, 0.01, True), st["v"])
    else:
        st["vr"] = jax.tree.map(lambda a: fill(a, 0.01, True), st["vr"])
        st["vc"] = jax.tree.map(lambda a: fill(a, 0.01, True), st["vc"])
    if compress:
        st["residual"] = jax.tree.map(lambda a: fill(a, 0.01), st["residual"])
    st["count"] = jnp.asarray(3, jnp.int32)
    return st


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("name,tol", [("adamw", 2), ("adafactor", 8)])
def test_one_update(name, tol, compress):
    jc = J.OptConfig(name=name, compress_grads=compress, **CFG)
    tc = T.OptConfig(name=name, compress_grads=compress, **CFG)
    params, grads, st = _tree(0), _tree(1, 0.3), _state(name, compress)
    new_p, new_s, gnorm = J.opt_update(_j(grads), st, _j(params), jc)
    tp, ts = _t(params), _t(jax.tree.map(np.asarray, st))
    out_p, out_s, tnorm = T.opt_update(_t(grads), ts, tp, tc)
    assert out_p is tp and out_s is ts                      # in place
    assert abs(float(tnorm) - float(gnorm)) <= 1e-6 * float(gnorm)
    for path, a, b in _pairs(new_p, out_p):
        assert ulps(a, b) <= tol, ("params", path, ulps(a, b))
    assert sorted(out_s) == sorted(new_s)
    for k in new_s:
        if k == "count":
            assert out_s[k].dtype == torch.int32 and int(out_s[k]) == int(new_s[k]) == 4
            continue
        for path, a, b in _pairs(new_s[k], out_s[k]):
            assert a.shape == b.shape and ulps(a, b) <= tol, (k, path, ulps(a, b))
    # the update moved (nearly) every weight
    for path, a, b in _pairs(_j(params), out_p):
        assert (a != b).mean() > 0.9, path


def test_adamw_determined_sets_aside_eps_level_elements():
    """``adamw_determined`` keeps an element only where the bias-corrected
    ``sqrt(v / (1 - b2^count))`` is at least 10 eps (1e-7) after every
    given step: 9e-8 at either step sets it aside, 1.1e-7 at both keeps it."""
    cfg = T.OptConfig(**CFG)
    roots = {1: [9e-8, 1.1e-7, 1e-3, 1e-3, 0.0], 2: [1.0, 1.1e-7, 9e-8, 1.1e-7, 1.0]}
    vs = [torch.tensor(roots[c], dtype=torch.float64) ** 2 * (1 - cfg.b2 ** c)
          for c in (1, 2)]
    vs = [v.float() for v in vs]
    got = T.adamw_determined(vs, (1, 2), cfg)
    assert got.dtype == torch.bool and got.tolist() == [False, True, False, True, False]
    assert T.adamw_determined(vs[:1], (1,), cfg).tolist() == [False, True, True, True, False]
    assert T.adamw_determined(vs[1:], (2,), cfg).tolist() == [True, True, False, True, True]



def test_adamw_step_bound_holds_eps_level_moves_and_catches_a_planted_one():
    """Two runs of two AdamW steps from one start whose grads differ by a
    rounding-level delta: at eps-level grads a 1e-9 difference moves a param
    by up to lr * delta / eps (a large share of lr), and
    ``adamw_step_bound`` holds every element after both steps (step 1 from
    the grads read off m, step 2 from both runs' m^ and v^); a param moved
    by twice its bound fails it."""
    cfg = T.OptConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    rng = np.random.default_rng(5)
    p0 = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 0.02)
    g = [torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
         for _ in range(2)]
    for x in g:
        x[:1024] *= 1e-8                      # eps-level grads
    runs = []
    for delta in (0.0, 1e-9):
        p, st = p0.clone(), T.opt_init({"w": p0}, cfg)
        trace = []
        for gk in g:
            gk = gk.clone()
            gk[:1024] += delta
            T.adamw_update({"w": gk}, st, {"w": p}, cfg)
            trace.append((p.clone(), st["m"]["w"].clone(), st["v"]["w"].clone()))
        runs.append(trace)
    dprev = torch.zeros(4096, dtype=torch.float64)
    for k, ((pa, ma, va), (pb, mb, vb)) in enumerate(zip(*runs)):
        bound = T.adamw_step_bound(dprev, (pa, pb), (ma, mb), (va, vb), k + 1, cfg, 2)
        diff = (pa.double() - pb.double()).abs()
        assert bool((diff <= bound).all()), k
        lr = float(T.schedule(cfg, k + 1))
        assert float(diff[:1024].max()) > 0.05 * lr      # eps-level moves are large
        planted = pb.double().clone()
        planted[7] = pa.double()[7] + 2 * bound[7]
        assert not bool(((pa.double() - planted).abs() <= bound).all())
        dprev = diff


def test_state_layout_and_default():
    params = {"w": torch.zeros(64, 32), "s": torch.zeros(3, 8, 4), "v": torch.zeros(16)}
    ad = T.opt_init(params, T.OptConfig())
    assert sorted(ad) == ["count", "m", "v"]
    assert ad["count"].dtype == torch.int32 and ad["count"].shape == ()
    assert all(ad["m"][k].shape == p.shape for k, p in params.items())
    af = T.opt_init(params, T.OptConfig(name="adafactor", compress_grads=True))
    assert sorted(af) == ["count", "residual", "vc", "vr"]
    assert af["vr"]["w"].shape == (64,) and af["vc"]["w"].shape == (32,)
    assert af["vr"]["s"].shape == (3, 8) and af["vc"]["s"].shape == (3, 4)
    assert af["vr"]["v"].shape == (16,) and af["vc"]["v"].shape == (1,)
    assert af["residual"]["s"].shape == (3, 8, 4)
    jparams = jax.tree.map(lambda t: jnp.zeros(t.shape), params)
    jaf = J.opt_init(jparams, J.OptConfig(name="adafactor", compress_grads=True))
    got = {k: (tuple(v.shape) if isinstance(v, torch.Tensor) else
               {kk: tuple(t.shape) for kk, t in v.items()}) for k, v in af.items()}
    want = {k: (tuple(v.shape) if not isinstance(v, dict) else
                {kk: tuple(t.shape) for kk, t in v.items()}) for k, v in jaf.items()}
    assert got == want
    for n in (1e9, 50e9, 50e9 + 1, 314e9):
        assert T.default_opt_for(n) == J.default_opt_for(n)
    with pytest.raises(ValueError):
        T.opt_update(params, ad, params, T.OptConfig(name="sgd"))
