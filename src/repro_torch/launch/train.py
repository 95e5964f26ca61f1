"""Training launcher: the paper's prototype learning by online STDP on the
card, through the port's trainer (``train.tnn_trainer``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tnn-mnist \
        --sites 625 --impl fused --superbatch-k 4 --ckpt-dir build/tnn_ckpt

Epochs of gamma waves (16 images a wave at 625 sites), vote-table evals and
checkpoints on the reference's layout; running the same command again
resumes from the directory's latest checkpoint. ``--smoke`` trains 16 sites
on a small stream in seconds; ``--device cpu`` runs the plain PyTorch path.
``--mesh DxM`` trains on a (data, model) process mesh, one process per
rank under ``torchrun``: batch rows over "data", sites over "model", to the
same bits as one process (NCCL with one card per rank by default; ``--backend
gloo`` when ranks share a card, and on the CPU):

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch tnn-mnist \
        --smoke --mesh 2x2 --device cpu
From the same flags the run equals ``python -m repro.launch.train --arch
tnn-mnist`` of the JAX package bit for bit: weights, key, wave, vote table
and accuracy, and the two packages restore each other's checkpoints.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.configs.tnn_mnist import (
    DEFAULT_CKPT_DIR, launcher_network_config, train_config,
)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import describe, make_mesh_2d, parse_mesh
from repro_torch.train.tnn_trainer import TNNTrainer


def train_tnn(args: argparse.Namespace) -> Dict[str, Any]:
    """Build the network and trainer from the flags, run it, return its
    summary (the trainer is ``summary["trainer"]``)."""
    mesh = (make_mesh_2d(*parse_mesh(args.mesh), device=args.device,
                         backend=args.backend) if args.mesh else None)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    main_rank = mesh is None or mesh.is_main
    sites = 16 if args.smoke and args.sites == 625 else args.sites
    cfg = launcher_network_config(sites, depth=args.depth, impl=args.impl,
                                  packed=args.packed)
    ckpt_dir = args.ckpt_dir or DEFAULT_CKPT_DIR
    tcfg = train_config(
        sites=sites, smoke=args.smoke, epochs=args.epochs, ckpt_dir=ckpt_dir,
        superbatch_k=args.superbatch_k, eval_every=args.eval_every,
        ckpt_every=args.ckpt_every,
        metrics_path=os.path.join(ckpt_dir, "metrics.jsonl"))
    if mesh is not None and tcfg.wave_batch % mesh.n_data:
        tcfg = dataclasses.replace(
            tcfg, wave_batch=mesh.n_data * max(tcfg.wave_batch // mesh.n_data, 1))
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    if main_rank:
        print(f"training tnn-mnist ({cfg.n_neurons:,} neurons, "
              f"{cfg.n_synapses:,} synapses, impl={args.impl}) on {where}, "
              f"{describe(mesh)}: {tcfg.epochs} epoch(s) x "
              f"{tcfg.waves_per_epoch} waves x batch {tcfg.wave_batch}")
    trainer = TNNTrainer(cfg, tcfg, device=device, mesh=mesh)
    summary = trainer.run()
    if main_rank:
        print(summary)
    return dict(summary, trainer=trainer)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tnn-mnist", choices=("tnn-mnist",),
                    help="the port trains the TNN prototype only")
    ap.add_argument("--smoke", action="store_true",
                    help="16 sites and a small stream (seconds on a CPU)")
    ap.add_argument("--ckpt-dir", default=None,
                    help=f"checkpoint directory (default {DEFAULT_CKPT_DIR})")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--sites", type=int, default=625,
                    help="prototype sites (perfect square; --smoke -> 16)")
    ap.add_argument("--impl", default="pallas",
                    choices=("direct", "matmul", "pallas", "fused"),
                    help="'pallas' = the per-layer kernels; 'fused' = one "
                         "wave-kernel launch per gamma wave; 'direct'/"
                         "'matmul' = the plain per-layer forms")
    ap.add_argument("--depth", type=int, default=2,
                    help="cascade depth: 2 = the paper prototype, other "
                         "depths build the deep_config N-layer cascade")
    ap.add_argument("--superbatch-k", type=int, default=1,
                    help="gamma waves per step call, clamped at eval and "
                         "checkpoint boundaries; any K gives the same bits")
    ap.add_argument("--packed", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="kept for config parity with the reference; the "
                         "kernels' IO is uint8/int8 either way")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="waves between vote-table evals (0 = epoch ends)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="waves between checkpoints (0 = epoch ends)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="(data, model) process mesh, e.g. --mesh 2x2 under "
                         "torchrun --nproc-per-node 4: batch rows shard over "
                         "data, sites over model")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="the mesh's backend (default nccl on cuda, gloo on "
                         "cpu; gloo when ranks share one card)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    return train_tnn(parse_args(argv))


if __name__ == "__main__":
    main()
