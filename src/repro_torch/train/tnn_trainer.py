"""Streaming online-STDP trainer for the TNN prototype, as the reference's
``repro.train.tnn_trainer``.

* **Wave batching.** Each step is one gamma wave over a fixed-shape batch of
  encoded images through ``core.network.make_train_step`` (forward and
  counter-form STDP, the weights updated in place). The network config's
  ``impl`` picks the backend: ``"pallas"`` runs each layer on the per-layer
  column and STDP kernels, ``"fused"`` the whole wave as one wave-kernel
  launch; on the card the threefry kernel draws every layer's STDP uniforms.
  Every backend trains to the same bits, and to the reference's.
* **K-wave superbatches.** ``superbatch_k > 1`` runs K waves per
  ``make_superbatch_step`` call on pre-split keys; chunks are clamped so that
  no eval, checkpoint or epoch end falls inside one, so any K gives the same
  run, checkpoints included.
* **Deterministic stream.** :class:`WaveStream` generates and encodes the
  labelled set once; ``batch_at(wave)`` is a pure function of the wave
  counter, which makes resume exact.
* **Checkpointed resume.** The state (weights, key, wave counter) and the
  vote table go through ``checkpoint.Checkpointer`` on the reference's
  layout; train N, save, restore, train M equals N + M straight through.
* **Eval cadence.** On ``eval_every`` waves (else at epoch ends) and at the
  end, a labelled pass over the train set rebuilds the vote table
  (``refresh_vote_table``) and the soft site vote scores held-out accuracy.

* **(data, model) mesh.** ``mesh=`` (``launch.mesh.Mesh2D``) trains one
  rank's part: every rank builds the same global wave from the seeded stream
  and cuts its window (``MeshSpec.local_spikes``); the state holds the
  rank's site-padded weight slices; the step all-reduces the STDP counters
  over the data axis. Evaluation runs unsharded on the gathered weights,
  as the reference's; rank 0 writes the checkpoints and the metrics and
  prints. Any factorization trains to the unmeshed bits.

Entry point: ``python -m repro_torch.launch.train --arch tnn-mnist [--smoke]
[--mesh DxM]``.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import random as _random
from repro_torch.checkpoint.checkpointer import (
    Checkpointer,
    agreed_latest_step,
    restore_tnn,
    save_tnn,
    tnn_config_fingerprint,
)
from repro_torch.configs.tnn_mnist import DEFAULT_CKPT_DIR, crop_field
from repro_torch.core.network import (
    NetworkConfig,
    classify,
    encode_images,
    forward_all_padded,
    init_train_state,
    make_superbatch_step,
    make_train_step,
    network_forward,
    local_tree,
    logical_params,
    network_mesh_spec,
    refresh_vote_table,
)
from repro_torch.data.mnist_like import digits
from repro_torch.device import resolve_device


@dataclasses.dataclass
class TNNTrainConfig:
    """Hyper-parameters for wave-batched online STDP training."""

    epochs: int = 1
    wave_batch: int = 16
    superbatch_k: int = 1          # gamma waves per step call
    train_size: int = 256          # images in the (generated) labelled set
    eval_size: int = 128           # held-out images scored at eval points
    eval_every: int = 0            # waves between evals; 0 = epoch ends only
    ckpt_every: int = 0            # waves between checkpoints; 0 = epoch ends
    ckpt_dir: str = DEFAULT_CKPT_DIR
    keep: int = 3
    seed: int = 0                  # weights + STDP randomness
    data_seed: int = 1             # train-set generator
    eval_seed: int = 2             # held-out-set generator
    log_every: int = 10
    metrics_path: Optional[str] = None

    @property
    def waves_per_epoch(self) -> int:
        return max(self.train_size // self.wave_batch, 1)

    @property
    def total_waves(self) -> int:
        return self.epochs * self.waves_per_epoch


class WaveStream:
    """Deterministic wave-indexed stream of encoded spike batches: ``n``
    MNIST-like digits generated once, cropped to the config's field and
    encoded to (n, sites, p) uint8 spike times on ``device``;
    ``batch_at(wave)`` takes ``wave_batch`` rows with wrap-around."""

    def __init__(self, cfg: NetworkConfig, n: int, wave_batch: int,
                 seed: int = 1, device="cuda"):
        self.device = resolve_device(device)
        imgs, labels = digits(n, seed=seed)
        imgs = crop_field(imgs, cfg.layers[0].n_cols)
        self.images = imgs
        self.labels = labels
        self.x = encode_images(
            torch.from_numpy(np.ascontiguousarray(imgs)).to(self.device), cfg)
        self.n = n
        self.wave_batch = wave_batch

    def batch_at(self, wave: int) -> torch.Tensor:
        """Rows ``wave * wave_batch ...`` (mod n) of the encoded set: a view
        where they do not wrap, so no index crosses to the device."""
        start = (wave * self.wave_batch) % self.n
        if start + self.wave_batch <= self.n:
            return self.x[start:start + self.wave_batch]
        idx = (np.arange(self.wave_batch) + start) % self.n
        return self.x[torch.from_numpy(idx).to(self.device)]

    def superbatch_at(self, wave: int, k: int) -> torch.Tensor:
        """K consecutive wave batches on a leading axis ((k, wave_batch, C,
        p)): slice ``i`` is ``batch_at(wave + i)``."""
        return torch.stack([self.batch_at(wave + i) for i in range(k)])


class TNNTrainer:
    """Checkpointed, resumable, wave-batched STDP training loop on
    ``device`` (the card unless the caller names the CPU), or on the rank's
    device of ``mesh``."""

    def __init__(self, cfg: NetworkConfig, tcfg: TNNTrainConfig, device="cuda",
                 mesh=None):
        cfg.validate()
        if tcfg.superbatch_k < 1:
            raise ValueError(f"superbatch_k={tcfg.superbatch_k} must be >= 1")
        if mesh is not None and tcfg.wave_batch % mesh.n_data:
            raise ValueError(
                f"wave_batch={tcfg.wave_batch} not divisible by data "
                f"axis size {mesh.n_data}")
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.spec = network_mesh_spec(cfg, mesh)
        self.step_fn = make_train_step(cfg, mesh)
        self.superbatch_fn = (make_superbatch_step(cfg, mesh)
                              if tcfg.superbatch_k > 1 else None)
        state = init_train_state(_random.PRNGKey(tcfg.seed), cfg, self.device)
        self.state = dict(state, params=local_tree(state["params"], cfg, mesh))
        self.stream = WaveStream(cfg, tcfg.train_size, tcfg.wave_batch,
                                 seed=tcfg.data_seed, device=self.device)
        self.eval_stream = WaveStream(cfg, tcfg.eval_size, tcfg.wave_batch,
                                      seed=tcfg.eval_seed, device=self.device)
        self.train_labels = torch.as_tensor(self.stream.labels, dtype=torch.int64,
                                            device=self.device)
        last = cfg.layers[-1]
        self.vote_table = torch.zeros((last.n_cols, last.column.q, cfg.n_classes),
                                      dtype=torch.float32, device=self.device)
        self.has_vote = False
        self._eval_wave = -1  # wave the vote table was last built at
        self.ckpt = Checkpointer(tcfg.ckpt_dir, keep=tcfg.keep)
        self.accuracy: Optional[float] = None
        self.wave_times: list = []
        self._metrics_f = (open(tcfg.metrics_path, "a")
                           if tcfg.metrics_path and self._is_main else None)

    @property
    def _is_main(self) -> bool:
        return self.mesh is None or self.mesh.is_main

    def _x(self, x: torch.Tensor, row_axis: int = 0) -> torch.Tensor:
        """A global wave (or superbatch) -> the rank's window."""
        if self.mesh is None:
            return x
        T = self.cfg.layers[0].column.wave.T
        return self.spec.local_spikes(x, T, row_axis=row_axis, site_axis=row_axis + 1)

    def params(self):
        """The logical weights: gathered over the model axis on a mesh (a
        collective: every rank calls it)."""
        return logical_params(self.state["params"], self.cfg, self.mesh)

    def _forward(self, ps, x: torch.Tensor) -> torch.Tensor:
        return network_forward(x, list(ps), self.cfg)[-1]

    # -- metrics-handle lifecycle -----------------------------------------

    def close(self) -> None:
        """Flush and close the metrics JSONL handle (idempotent)."""
        f, self._metrics_f = self._metrics_f, None
        if f is not None:
            f.close()

    def __enter__(self) -> "TNNTrainer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass  # interpreter teardown: never raise from a finalizer

    # -- checkpointing -----------------------------------------------------

    @property
    def wave(self) -> int:
        return int(self.state["wave"])

    def checkpoint(self, block: bool = False) -> None:
        save_tnn(
            self.ckpt, self.cfg, self.wave,
            dict(self.state, vote_table=self.vote_table), mesh=self.mesh,
            extra={"arch": "tnn-mnist",
                   "config": tnn_config_fingerprint(self.cfg),
                   "wave": self.wave, "has_vote": self.has_vote,
                   "eval_wave": self._eval_wave,
                   "accuracy": self.accuracy},
            block=block)

    def maybe_resume(self) -> bool:
        latest = agreed_latest_step(self.ckpt, self.mesh)
        if latest is None:
            return False
        state, extra = restore_tnn(self.ckpt, self.cfg, latest, self.device,
                                   mesh=self.mesh)
        self.vote_table = state.pop("vote_table")
        self.state = state
        self.has_vote = bool(extra.get("has_vote", False))
        self._eval_wave = int(extra.get("eval_wave", -1))
        self.accuracy = extra.get("accuracy")
        return True

    # -- readout / eval ----------------------------------------------------

    def evaluate(self) -> float:
        """Labelled pass over the train set -> vote table; held-out accuracy
        by the soft site vote. On a mesh every rank runs it unsharded on the
        gathered weights."""
        T = self.cfg.layers[-1].column.wave.T
        params = self.params()
        self.vote_table = refresh_vote_table(
            self._forward, params, self.stream.x, self.train_labels,
            self.cfg, self.tcfg.wave_batch)
        self.has_vote = True
        z_eval = forward_all_padded(self._forward, params, self.eval_stream.x,
                                    self.tcfg.wave_batch, T)
        preds = classify(z_eval, self.vote_table, T, soft=True).cpu().numpy()
        self.accuracy = float((preds == self.eval_stream.labels).mean())
        self._eval_wave = self.wave
        return self.accuracy

    # -- the loop ----------------------------------------------------------

    def _log(self, rec: Dict[str, Any]) -> None:
        if self._metrics_f:
            self._metrics_f.write(json.dumps(rec) + "\n")
            self._metrics_f.flush()
        if self._is_main and ((self.tcfg.log_every
                               and rec["wave"] % self.tcfg.log_every == 0)
                              or "accuracy" in rec):
            print("[tnn-trainer] " +
                  " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in rec.items()))

    def run(self) -> Dict[str, Any]:
        try:
            return self._run()
        finally:
            self.close()

    def _chunk_k(self, wave: int, total: int) -> int:
        """Waves the next step call may run: up to ``superbatch_k``, clamped
        so no eval, checkpoint or epoch end (or the end of training) falls
        inside the chunk."""
        tc = self.tcfg
        nxt = total
        if tc.eval_every:
            nxt = min(nxt, (wave // tc.eval_every + 1) * tc.eval_every)
        if tc.ckpt_every:
            nxt = min(nxt, (wave // tc.ckpt_every + 1) * tc.ckpt_every)
        if not tc.eval_every or not tc.ckpt_every:
            wpe = tc.waves_per_epoch
            nxt = min(nxt, (wave // wpe + 1) * wpe)
        return min(tc.superbatch_k, nxt - wave)

    def _fired(self, z: torch.Tensor, T: int) -> float:
        """Share of the last layer's (batch, site, neuron) times that fired;
        on a mesh summed over every rank's window (pad sites never fire)."""
        if self.mesh is None:
            return float((z < T).to(torch.float32).mean())
        n = (z < T).sum().to(torch.int64).reshape(1)
        n = self.mesh.all_reduce_sum(n, "world")
        q = self.cfg.layers[-1].column.q
        return float(n[0]) / (self.tcfg.wave_batch * self.spec.n_cols * q)

    def _run(self) -> Dict[str, Any]:
        resumed = self.maybe_resume()
        if resumed and self._is_main:
            print(f"[tnn-trainer] resumed at wave {self.wave} "
                  f"from {self.tcfg.ckpt_dir}")
        total = self.tcfg.total_waves
        wpe = self.tcfg.waves_per_epoch
        T = self.cfg.layers[-1].column.wave.T
        while self.wave < total:
            wave = self.wave
            t0 = time.perf_counter()
            if self.superbatch_fn is None:
                k = 1
                self.state, z = self.step_fn(self.state,
                                             self._x(self.stream.batch_at(wave)))
            else:
                k = self._chunk_k(wave, total)
                self.state, z_k = self.superbatch_fn(
                    self.state, self._x(self.stream.superbatch_at(wave, k), 1))
                z = z_k[-1]  # the chunk-end wave's readout, as lock-step
            fired = self._fired(z, T)  # waits for the wave
            dt = time.perf_counter() - t0
            self.wave_times.append(dt / k)
            wave += k
            rec = {"wave": wave, "dt_s": round(dt, 4),
                   "waves_per_s": round(k / max(dt, 1e-9), 3),
                   "fired": round(fired, 4)}
            if k > 1:
                rec["superbatch_k"] = k
            at_epoch_end = wave % wpe == 0
            if (self.tcfg.eval_every and wave % self.tcfg.eval_every == 0) or \
                    (not self.tcfg.eval_every and at_epoch_end):
                rec["accuracy"] = self.evaluate()
            self._log(rec)
            if (self.tcfg.ckpt_every and wave % self.tcfg.ckpt_every == 0) or \
                    (not self.tcfg.ckpt_every and at_epoch_end):
                self.checkpoint()
        # the saved vote table must match the final weights: re-label if waves
        # ran since the last eval, and skip the final save only when the loop
        # already wrote this exact state
        did_final_eval = False
        if self._eval_wave != self.wave:
            self.evaluate()
            did_final_eval = True
        self.ckpt.wait()
        save = did_final_eval or self.ckpt.latest_step() != self.wave
        if self.mesh is not None:   # one decision: the save is a collective
            save = bool(self.mesh.broadcast_floats([save])[0])
        if save:
            self.checkpoint(block=True)
            self.ckpt.wait()
        med = float(np.median(self.wave_times)) if self.wave_times else 0.0
        return {
            "final_wave": self.wave,
            "epochs": self.wave // wpe,
            "accuracy": self.accuracy,
            "waves_per_s": (1.0 / med) if med else None,
            "resumed": resumed,
        }
