"""The TNN-frontend -> LM entry point (``repro_torch.launch.tnn_frontend_lm``)
against the reference's ``examples/tnn_frontend_lm.py``: the example's own
computation, step for step on the JAX package, gives the same frontend
spike times, trained weights and winners, bit for bit, on every plain
backend; the LM logits on those embeds agree within the float32
tolerances of tests/test_torch_lm_families.py (3e-4 absolute; measured
~1e-7 at |logits| < 1) and, in the example's bfloat16, within 8e-3; the
entry point prints the example's two lines."""
import dataclasses
import runpy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import smoke_config as j_smoke
from repro.core import ColumnConfig, LayerConfig, init_layer, layer_forward, layer_step
from repro.core.layer import encode_patches_onoff, extract_patches
from repro.core.temporal import WaveSpec, decode_time
from repro.data.mnist_like import digits
from repro.models import model as JM

from repro_torch.core import temporal as t_temporal
from repro_torch.launch import tnn_frontend_lm as entry
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def example():
    """examples/tnn_frontend_lm.py's computation, its lines as written there,
    returning what it prints from; the LM in both dtypes."""
    spec = WaveSpec()
    B = 4
    imgs, _ = digits(B, seed=0)
    patches = extract_patches(jnp.asarray(imgs[:, 8:20, 8:20]), k=4, stride=3)
    x = encode_patches_onoff(patches, spec)
    lcfg = LayerConfig(9, ColumnConfig(p=32, q=12, theta=20, wave=spec))
    w = init_layer(jax.random.PRNGKey(0), lcfg)
    for i in range(4):
        _, w = layer_step(x, w, lcfg, jax.random.PRNGKey(i))
    z = layer_forward(x, w, lcfg)
    out = {"z": np.asarray(z), "weights": np.asarray(w),
           "winners": np.asarray(jnp.argmin(z.astype(jnp.int32), -1))}
    emb = decode_time(z, spec)
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(j_smoke("internvl2-76b"), frontend_len=9, dtype=dtype)
        proj = jnp.tile(emb, (1, 1, cfg.d_model // 12 + 1))[:, :, : cfg.d_model]
        params = JM.init_params(cfg, jax.random.PRNGKey(1))
        tokens = jax.random.randint(jax.random.PRNGKey(2), (B, 8), 0, cfg.vocab_size)
        logits = JM.forward_train(params, cfg, tokens, embeds=proj, kv_chunk=4)
        out[dtype] = np.asarray(logits.astype(jnp.float32))
        out["embeds"] = np.asarray(proj)
    return out


@pytest.mark.parametrize("impl", ["direct", "matmul"])
def test_spikes_and_winners_bit_for_bit(impl, example):
    got = entry.run(impl, "cpu", "float32")
    np.testing.assert_array_equal(got["weights"].numpy(), example["weights"])
    np.testing.assert_array_equal(got["z"].numpy(), example["z"])
    np.testing.assert_array_equal(got["winners"].numpy(), example["winners"])
    np.testing.assert_array_equal(got["embeds"].numpy(), example["embeds"])
    assert got["logits"].shape == (4, 17, 256)
    np.testing.assert_allclose(got["logits"].numpy(), example["float32"], rtol=0, atol=3e-4)


def test_bfloat16_logits(example):
    got = entry.run("direct", "cpu")
    assert entry.lm_config().dtype == "bfloat16"
    np.testing.assert_allclose(got["logits"].numpy(), example["bfloat16"], rtol=0, atol=8e-3)


def test_prints_the_examples_lines(capsys):
    runpy.run_path(os.path.join(ROOT, "examples", "tnn_frontend_lm.py"), run_name="__main__")
    want = capsys.readouterr().out
    entry.main(["--device", "cpu"])
    assert capsys.readouterr().out == want


def test_temporal_helpers_match_reference():
    """The rest of ``core.temporal``: decode_time, is_spike, onoff_encode and
    ramp_response against the reference's, exactly."""
    import torch
    from repro.core import temporal as j_temporal
    spec = WaveSpec()
    rng = np.random.default_rng(0)
    times = rng.integers(0, spec.T + 1, (5, 7)).astype(np.uint8)
    vals = rng.random((5, 6)).astype(np.float32)
    w = rng.integers(0, spec.w_max + 1, (5, 7)).astype(np.int8)
    tspec = t_temporal.WaveSpec()
    tt = torch.from_numpy(times)
    np.testing.assert_array_equal(t_temporal.decode_time(tt, tspec).numpy(),
                                  np.asarray(j_temporal.decode_time(jnp.asarray(times), spec)))
    np.testing.assert_array_equal(t_temporal.is_spike(tt, tspec).numpy(),
                                  np.asarray(j_temporal.is_spike(jnp.asarray(times), spec)))
    np.testing.assert_array_equal(
        t_temporal.onoff_encode(torch.from_numpy(vals), tspec).numpy(),
        np.asarray(j_temporal.onoff_encode(jnp.asarray(vals), spec)))
    for t in (0, 3, spec.T):
        np.testing.assert_array_equal(
            t_temporal.ramp_response(tt, torch.from_numpy(w), t, tspec).numpy(),
            np.asarray(j_temporal.ramp_response(jnp.asarray(times), jnp.asarray(w),
                                                jnp.asarray(t), spec)))
