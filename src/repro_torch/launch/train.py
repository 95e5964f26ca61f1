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

``--arch <LM>`` (any of the ten registry archs) trains the LM through the
fault-tolerant ``train.trainer.Trainer`` on the synthetic token stream, with
the reference's flags and defaults: params from ``PRNGKey(0)``, AdamW (or
Adafactor over 50B parameters by ``n_params()``), the warmup-cosine schedule
over ``--steps``, ``kv_chunk`` 128, a checkpoint every ``max(steps // 3,
5)`` steps and at the end, ``metrics.jsonl`` in the checkpoint directory
(default ``$TMPDIR/repro_launch_ckpt``); running the same command again
resumes. ``--smoke`` trains the family's smoke config:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --smoke --steps 6 --batch 2 --seq 16 --device cpu

``--mesh DxM`` with an LM trains on a (data, model) process mesh under
``torchrun --nproc-per-node D*M``: the state's leaves are DTensors placed by
the reference's ``param_rules`` (FSDP over "data", tensor parallel over
"model"; ``Dx1`` is the reference's host mesh, all ranks on "data"), the
batch rows over "data", the MoE routing groups tiled to the data shards
(the reference's ``_tuned``); each param is drawn whole on the rank's
device from ``PRNGKey(0)``, bit for bit, its block kept and the rest freed.
Rank 0 prints and writes the checkpoints, which are the files one process
writes:

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch llama3.2-3b --smoke --mesh 2x2 --device cpu

``--production-mesh`` (the reference's 16x16 and 2x16x16 meshes) needs 256
and 512 cards and is refused.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch import random as t_random
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.configs.tnn_mnist import (
    DEFAULT_CKPT_DIR, launcher_network_config, train_config,
)
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import describe, make_mesh_2d, parse_mesh
from repro_torch.models.model import param_count
from repro_torch.sharding import partition as PT
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS
from repro_torch.train.tnn_trainer import TNNTrainer
from repro_torch.train.trainer import Trainer, TrainerConfig

LM_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_launch_ckpt")
PRODUCTION = {"single": "16x16 mesh (256 cards)", "multi": "2x16x16 mesh (512 cards)"}
# The archs whose train step needs an input the token stream does not carry.
NO_STREAM_INPUTS = {
    "whisper-tiny": "the encoder-decoder's decoder cross-attends to encoder frames "
                    "(batch['frames']).",
    "internvl2-76b": "the VLM's logits start with a prefix of image embeds "
                     "(batch['embeds']), and the stream's labels cover only the tokens.",
}


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


def lm_opt_config(args: argparse.Namespace, cfg) -> OPT.OptConfig:
    """The reference launcher's optimizer for the flags: AdamW, or Adafactor
    over 50B parameters by the reference's ``n_params()``; warmup over the
    first ``min(20, steps // 5 + 1)`` steps, cosine decay to ``--steps``."""
    return OPT.OptConfig(
        name=OPT.default_opt_for(cfg.n_params()), lr=args.lr,
        warmup_steps=min(20, args.steps // 5 + 1), total_steps=args.steps,
        compress_grads=args.compress_grads)


def lm_trainer(args: argparse.Namespace, cfg=None) -> Trainer:
    """The LM run of the flags, built and ready to ``run()``: the model
    ``cfg`` (default: the arch's config, or its smoke config with
    ``--smoke``), its state drawn from ``PRNGKey(0)`` on the device (with
    ``--mesh``: sharded on the process mesh, ``cfg`` tuned to it), the
    train step, the token stream and the trainer, which can draw the step-0
    state again, with the SIGTERM handler installed."""
    mesh = (make_mesh_2d(*parse_mesh(args.mesh), device=args.device,
                         backend=args.backend) if args.mesh else None)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    main_rank = mesh is None or mesh.is_main
    if cfg is None:
        cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    prof = PT.RunProfile()
    if mesh is not None:
        cfg = PT.tuned_config(cfg, mesh, prof)
    ckpt_dir = args.ckpt_dir or LM_CKPT_DIR
    opt_cfg = lm_opt_config(args, cfg)
    tc = TS.TrainConfig(micro_steps=args.micro_steps, kv_chunk=128)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    if main_rank:
        print(f"training {cfg.name} ({param_count(cfg):,} parameters, {cfg.dtype}, "
              f"{opt_cfg.name}, remat {cfg.remat}) on {where}, {describe(mesh)}: "
              f"{args.steps} steps x batch {args.batch} x seq {args.seq}", flush=True)
    shardings = TS.state_shardings(cfg, opt_cfg, mesh, prof) if mesh is not None else None

    def draw():
        return TS.init_state(cfg, opt_cfg, t_random.PRNGKey(0), device, shardings)

    stream = TokenStream(cfg.vocab_size, args.batch, args.seq, seed=0)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=max(args.steps // 3, 5),
                         ckpt_dir=ckpt_dir, log_every=5,
                         metrics_path=os.path.join(ckpt_dir, "metrics.jsonl"))
    trainer = Trainer(TS.make_train_step(cfg, opt_cfg, tc, mesh=mesh, prof=prof), draw(),
                      stream, tcfg, shardings=shardings, init_state=draw)
    trainer.install_preemption_handler()
    return trainer


def train_lm(args: argparse.Namespace, cfg=None) -> Dict[str, Any]:
    """Run :func:`lm_trainer`; returns its summary (the trainer is
    ``summary["trainer"]``)."""
    trainer = lm_trainer(args, cfg)
    summary = trainer.run()
    if trainer.is_main:
        print(summary, flush=True)
    return dict(summary, trainer=trainer)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tnn-mnist", choices=("tnn-mnist", *ARCHS),
                    help="the TNN prototype, or an LM of the registry")
    ap.add_argument("--smoke", action="store_true",
                    help="tnn-mnist: 16 sites and a small stream; an LM: its "
                         "smoke config (seconds on a CPU)")
    ap.add_argument("--ckpt-dir", default=None,
                    help=f"checkpoint directory (default {DEFAULT_CKPT_DIR} for "
                         f"tnn-mnist, {LM_CKPT_DIR} for an LM)")
    # LM options (the reference's)
    ap.add_argument("--production-mesh", choices=["single", "multi"], default=None,
                    help="an LM's production mesh (16x16 = 256 cards, 2x16x16 "
                         "= 512): refused, use --mesh DxM")
    ap.add_argument("--steps", type=int, default=50, help="LM train steps")
    ap.add_argument("--batch", type=int, default=8, help="LM rows a step")
    ap.add_argument("--seq", type=int, default=128, help="LM tokens a row")
    ap.add_argument("--lr", type=float, default=1e-3, help="LM peak learning rate")
    ap.add_argument("--micro-steps", type=int, default=1,
                    help="LM gradient-accumulation microbatches a step")
    ap.add_argument("--compress-grads", action="store_true",
                    help="LM int8 gradient compression with error feedback")
    # tnn-mnist options
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
                         "data; sites over model (tnn-mnist), or the weights' "
                         "tensor-parallel axes over model and their embed axis "
                         "over data (an LM)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="the mesh's backend (default nccl on cuda, gloo on "
                         "cpu; gloo when ranks share one card)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.arch in NO_STREAM_INPUTS:
        ap.error(f"--arch {args.arch}: {NO_STREAM_INPUTS[args.arch]} The token stream "
                 f"carries no such input, and the reference launcher fails the same "
                 f"way (ROADMAP Queue 3 item 15); train it through "
                 f"train_step.make_train_step with the input in the batch")
    if args.production_mesh and args.arch != "tnn-mnist":
        ap.error(f"--production-mesh {args.production_mesh} is the reference's "
                 f"{PRODUCTION[args.production_mesh]}: a process mesh of that size "
                 f"needs that many cards; train on a --mesh DxM process mesh of "
                 f"the cards this host has (torchrun --nproc-per-node D*M)")
    return args


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    if args.arch == "tnn-mnist":
        return train_tnn(args)
    return train_lm(args)


if __name__ == "__main__":
    main()
