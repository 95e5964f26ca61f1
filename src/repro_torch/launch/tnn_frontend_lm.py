"""The TNN column as a sensory frontend of an LM, as the reference's
``examples/tnn_frontend_lm.py``: one layer of 9 sites of 32x12 columns over
digit patches, trained by 4 unsupervised STDP waves and frozen; its output
spike times decoded into the vision-stub embedding slots of smoke
internvl2-76b (``frontend_len = 9``) and run through the LM's
``forward_train(embeds=...)``.

    PYTHONPATH=src python -m repro_torch.launch.tnn_frontend_lm --impl pallas

``--impl pallas`` runs the layer through the hand-written kernels (the
column kernel for each forward, the threefry and STDP kernels for each
learning wave); ``direct`` (the default, the example's) and ``matmul`` are
the plain forms, whose uniforms the threefry kernel still draws on the
card. ``--device`` is the card unless ``cpu`` is named; ``--dtype`` the
LM's compute dtype (the smoke config's bfloat16 unless ``float32``). The
keys are the reference's: the layer from ``PRNGKey(0)``, wave ``i`` from
``PRNGKey(i)``, the LM from ``PRNGKey(1)``, the tokens from ``PRNGKey(2)``;
so the spike times and winners are the reference's bits on every backend.
It prints the reference's two lines.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import random as _random
from repro_torch.configs import smoke_config
from repro_torch.core.column import ColumnConfig
from repro_torch.core.layer import (
    LayerConfig, encode_patches_onoff, extract_patches, init_layer, layer_forward,
    layer_step,
)
from repro_torch.core.temporal import WaveSpec, decode_time
from repro_torch.data.mnist_like import digits
from repro_torch.device import resolve_device
from repro_torch.models import model as M

B, WAVES, SITES, N_TOKENS = 4, 4, 9, 8


def frontend_config(impl: str = "direct") -> LayerConfig:
    return LayerConfig(SITES, ColumnConfig(p=32, q=12, theta=20, wave=WaveSpec(), impl=impl))


def lm_config(dtype: Optional[str] = None):
    cfg = dataclasses.replace(smoke_config("internvl2-76b"), frontend_len=SITES)
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def run(impl: str = "direct", device="cuda", dtype: Optional[str] = None) -> Dict[str, object]:
    """The example's computation. Returns the frontend's spike times z (B, 9,
    12) uint8, its winners (B, 9), the embeds and the LM's logits (B, 17,
    vocab), all on the host."""
    dev = resolve_device(device)
    lcfg = frontend_config(impl)
    spec = lcfg.column.wave
    imgs, _ = digits(B, seed=0)
    patches = extract_patches(torch.from_numpy(imgs[:, 8:20, 8:20]).to(dev), k=4, stride=3)
    x = encode_patches_onoff(patches, spec)  # (B, 9, 32)
    w = init_layer(_random.PRNGKey(0), lcfg, dev)
    for i in range(WAVES):  # a few unsupervised STDP waves, then freeze
        _, w = layer_step(x, w, lcfg, _random.PRNGKey(i))
    z = layer_forward(x, w, lcfg)  # (B, 9, 12) spike times

    # spike times -> embeddings for the VLM backbone's frontend slots
    cfg = lm_config(dtype)
    emb = decode_time(z, spec)  # (B, 9, 12) in [0, 1]
    proj = emb.repeat(1, 1, cfg.d_model // 12 + 1)[:, :, :cfg.d_model]
    params = M.init_params(cfg, _random.PRNGKey(1), dev)
    tokens = _random.randint(_random.PRNGKey(2), (B, N_TOKENS), 0, cfg.vocab_size)
    logits = M.forward_train(params, cfg, tokens.to(dev, torch.int64), embeds=proj,
                             kv_chunk=4)
    return {"z": z.cpu(), "winners": torch.argmin(z.to(torch.int32), -1).cpu(),
            "embeds": proj.cpu(), "logits": logits.float().cpu(), "weights": w.cpu()}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--impl", default="direct", choices=ColumnConfig.IMPLS,
                    help="the layer's backend: pallas = the per-layer kernels")
    ap.add_argument("--dtype", default=None, choices=("bfloat16", "float32"),
                    help="the LM's compute dtype (default: the config's)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = parse_args(argv)
    out = run(args.impl, args.device, args.dtype)
    logits = out["logits"]
    print(f"TNN frontend spikes -> LM logits {tuple(logits.shape)}; "
          f"finite={bool(torch.isfinite(logits).all())}")
    print("frontend winners (site-major):", np.asarray(out["winners"].numpy())[0])
    return out


if __name__ == "__main__":
    main()
