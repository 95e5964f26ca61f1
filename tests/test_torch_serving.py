"""The port's continuous-batching engine against the JAX reference's
``TNNEngine``, on the whole-network wave (``impl="fused"``) and on the
per-layer kernels (``impl="pallas"``, the default of both engines): 16
sites, 8 slots, the same weights (through ``convert.params_from_numpy``),
the same labelled set and requests. The vote tables must be equal and
every request's class id too, pipelined and lock-step, with the same
wave/occupancy accounting."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.tnn_mnist import launcher_network_config as j_launcher_config
from repro.core import network as j_network
from repro.serve.tnn_engine import ClassifyRequest as JRequest
from repro.serve.tnn_engine import TNNEngine as JEngine

from repro_torch import convert
from repro_torch.configs.tnn_mnist import crop_field, launcher_network_config
from repro_torch.data.mnist_like import digits
from repro_torch.serve.tnn_engine import (
    ClassifyRequest, ServeTimeout, TNNEngine,
)
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

SITES, SLOTS, N_REQ = 16, 8, 21  # 21 requests: the last wave is partial
T = 8


@pytest.fixture(scope="module")
def setting():
    """Weights, labelled set and requests; the requests are drawn from a
    seeded pool and keep the rows the reference's vote sums leave neither
    silent nor within 1e-6 (relative) of a tie."""
    jcfg = j_launcher_config(SITES, impl="fused")
    rng = np.random.default_rng(0)
    params = [rng.integers(0, 8, (l.n_cols, l.column.p, l.column.q)).astype(np.int8)
              for l in jcfg.layers]
    lab_imgs, lab_labs = digits(32, seed=1)
    lab_imgs = np.ascontiguousarray(crop_field(lab_imgs, SITES))
    pool = np.ascontiguousarray(crop_field(digits(48, seed=2)[0], SITES))

    @jax.jit
    def sums(lab, test, ps):
        vt = j_network.build_vote_table(
            j_network.network_forward(lab, list(ps), jcfg)[-1],
            jnp.asarray(lab_labs), 10, T)
        winner, fired = j_network.winner_map(
            j_network.network_forward(test, list(ps), jcfg)[-1], T)
        post = vt / jnp.maximum(vt.sum(axis=-1, keepdims=True), 1.0)
        return (post[jnp.arange(SITES)[None, :], winner] * fired[..., None]).sum(1)

    s = np.asarray(sums(j_network.encode_images(jnp.asarray(lab_imgs), jcfg),
                        j_network.encode_images(jnp.asarray(pool), jcfg),
                        tuple(params)))
    top2 = np.sort(s, axis=-1)[:, -2:]
    keep = (top2[:, 1] - top2[:, 0]) > 1e-6 * np.abs(top2[:, 1])
    requests = pool[keep][:N_REQ]
    assert len(requests) == N_REQ
    return params, (lab_imgs, lab_labs), requests


def _run(engine, request_cls, images, pipelined):
    for uid in range(len(images)):
        engine.submit(request_cls(uid=uid, image=images[uid]))
    done = engine.run_until_done(pipelined=pipelined)
    assert sorted(done) == list(range(len(images)))
    return [done[u].result for u in range(len(images))], engine.stats()


def _port_engine(params, label_set, impl="fused"):
    cfg = launcher_network_config(SITES, impl=impl)
    eng = TNNEngine(cfg, convert.params_from_numpy(params, cfg, device="cpu"),
                    n_slots=SLOTS, impl=impl, device="cpu")
    eng.fit(*label_set)
    return eng


@pytest.mark.parametrize("impl", ["fused", "pallas"])
@pytest.mark.parametrize("pipelined", [True, False])
def test_engine_matches_reference(setting, pipelined, impl):
    params, label_set, requests = setting
    jeng = JEngine(j_launcher_config(SITES, impl=impl),
                   [jnp.asarray(w) for w in params], n_slots=SLOTS, impl=impl)
    jeng.fit(*label_set)
    teng = _port_engine(params, label_set, impl)
    assert teng.cfg.layers[0].column.impl == impl
    np.testing.assert_array_equal(np.asarray(jeng.vote_table),
                                  teng.vote_table.numpy())
    want, st_j = _run(jeng, JRequest, requests, pipelined)
    got, st_t = _run(teng, ClassifyRequest, requests, pipelined)
    assert got == want
    assert (st_t.requests, st_t.waves, st_t.occupancy) == (
        st_j.requests, st_j.waves, st_j.occupancy)
    assert st_t.waves == -(-N_REQ // SLOTS)
    assert len(set(got)) > 1  # a readout that really discriminates


def test_pipelined_equals_lockstep_and_reset(setting):
    params, label_set, requests = setting
    eng = _port_engine(params, label_set)
    a, _ = _run(eng, ClassifyRequest, requests, True)
    eng.reset()
    assert eng.done == {} and eng.stats().requests == 0
    b, st = _run(eng, ClassifyRequest, requests, False)
    assert a == b
    assert st.p95_ms >= st.p50_ms >= 0.0
    assert eng.step() == 0 and eng.poll() == 0  # an empty queue launches nothing
    assert eng.waves_served == -(-N_REQ // SLOTS)


def test_timeout_keeps_every_request(setting):
    params, label_set, requests = setting
    eng = _port_engine(params, label_set)
    for uid in range(N_REQ):
        eng.submit(ClassifyRequest(uid=uid, image=requests[uid]))
    with pytest.raises(ServeTimeout) as err:
        eng.run_until_done(max_ticks=2)
    e = err.value
    assert e.served == SLOTS and e.in_flight == SLOTS
    assert e.served + e.unserved == N_REQ
    assert eng.pending == N_REQ - SLOTS
    done = eng.run_until_done()
    assert sorted(done) == list(range(N_REQ))


def test_engine_needs_fit_and_a_known_device(setting):
    params, _, requests = setting
    cfg = launcher_network_config(SITES, impl="fused")
    pt = convert.params_from_numpy(params, cfg, device="cpu")
    eng = TNNEngine(cfg, pt, n_slots=SLOTS, device="cpu")
    eng.submit(ClassifyRequest(uid=0, image=requests[0]))
    with pytest.raises(RuntimeError, match="fit"):
        eng.poll()
    with pytest.raises(ValueError):
        TNNEngine(cfg, pt, n_slots=SLOTS, device="meta")
    assert eng.cfg.layers[0].column.impl == "pallas"  # the reference's default
    with pytest.raises(ValueError, match="unknown impl"):
        TNNEngine(cfg, pt, n_slots=SLOTS, impl="triton", device="cpu")
    direct = TNNEngine(cfg, pt, n_slots=SLOTS, impl="direct", device="cpu")
    assert direct.cfg.layers[0].column.impl == "direct"
    assert torch.equal(direct.params[0], pt[0])
