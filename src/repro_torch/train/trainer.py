"""Fault-tolerant LM training loop, as ``repro.train.trainer`` runs it.

* Checkpoint and restart: periodic background checkpoints carrying the data
  cursor (``extra["data_step"]``); ``Trainer.run`` resumes from the
  directory's latest checkpoint on start.
* Failure handling: a step that raises, or whose loss is not finite, is
  restored from the last checkpoint and replayed, up to ``max_restarts``;
  the token stream is a function of the step, so the replay is exact. A
  step may update the state in place, so a step that raises before the
  first checkpoint may leave it half updated, and no copy of the state
  before it is kept (the reference, whose states are immutable, replays
  from that state). With ``init_state`` (a callable that draws the step-0
  state again, bit for bit, on the same shardings) the trainer then
  rebuilds the step-0 state and replays from step 0, which ends where the
  reference ends; without it such a step ends the run. A non-finite loss
  before the first checkpoint is replayed from the state as it is:
  ``train.train_step`` applies no update when the loss is not finite. A
  CUDA error that poisons the process's context (an illegal address, a
  device-side assert) cannot be replayed in process: every later call
  raises, the restarts run out, and the error propagates.
* Stragglers: a step slower than ``straggler_factor`` times the rolling
  median of the last 50 is counted and flagged in its metrics line.
* Preemption: SIGTERM sets a flag; the loop then writes a blocking
  checkpoint and stops.

The state is a nested dict of tensors. A step function may return a new
state or update the given one in place (``train.train_step``); a restore
copies the checkpoint into the state's own tensors, so the state keeps its
devices and its memory. On a mesh the state's leaves are DTensors and
``shardings`` their ``NamedSharding`` tree, as in the reference: every
rank runs the loop, a checkpoint is a collective that rank 0 writes, and a
restore reads each rank's blocks alone.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer, LeafSpec
from repro_torch.data.tokens import TokenStream
from repro_torch.models.params import tree_flatten, tree_map
from repro_torch.sharding.partition import local


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    keep: int = 3
    max_restarts: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10
    metrics_path: Optional[str] = None


def _leaf_spec(t: torch.Tensor) -> LeafSpec:
    return LeafSpec(tuple(t.shape), np.dtype(str(t.dtype).replace("torch.", "")))


def load_into(state, tree) -> None:
    """Copy a restored tree (numpy arrays, or DTensors on the state's
    placements) into the state's tensors, in place; the dtypes must
    agree."""
    for (path, t), (_, a) in zip(tree_flatten(state), tree_flatten(tree)):
        if isinstance(a, torch.Tensor):
            if a.dtype != t.dtype:
                raise TypeError(f"{path}: checkpoint {a.dtype} != state {t.dtype}")
            local(t).copy_(local(a))
            continue
        if a.dtype != _leaf_spec(t).dtype:
            raise TypeError(f"{path}: checkpoint {a.dtype} != state {t.dtype}")
        t.copy_(torch.as_tensor(a))


class Trainer:
    def __init__(self, step_fn: Callable, state, stream: TokenStream, cfg: TrainerConfig,
                 shardings=None, init_state: Optional[Callable[[], Any]] = None):
        self.step_fn = step_fn
        self.state = state
        self.stream = stream
        self.cfg = cfg
        self.shardings = shardings
        self.init_state = init_state
        # on a mesh only rank 0 prints and writes the metrics
        self.is_main = shardings is None or dist.get_rank() == 0
        self.ckpt = Checkpointer(cfg.ckpt_dir, keep=cfg.keep)
        self.step = 0
        self.restarts = 0
        self.stragglers = 0
        self.step_times: list = []
        self._preempted = False
        self._metrics_f = (open(cfg.metrics_path, "a")
                           if cfg.metrics_path and self.is_main else None)

    # -- lifecycle -----------------------------------------------------------

    def install_preemption_handler(self):
        def handler(signum, frame):  # noqa: ARG001
            self._preempted = True

        signal.signal(signal.SIGTERM, handler)

    def maybe_resume(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        tree, extra = self.ckpt.restore(latest, tree_map(_leaf_spec, self.state),
                                        self.shardings)
        load_into(self.state, tree)
        self.step = int(extra.get("data_step", latest))
        return True

    # -- the loop ------------------------------------------------------------

    def _checkpoint(self, block: bool = False):
        self.ckpt.save(self.step, self.state, extra={"data_step": self.step}, block=block)

    def _log(self, metrics: Dict[str, Any], dt: float):
        rec = {"step": self.step, "dt_s": round(dt, 4),
               **{k: float(v) for k, v in metrics.items()}}
        if self._metrics_f:
            self._metrics_f.write(json.dumps(rec) + "\n")
            self._metrics_f.flush()
        if self.step % self.cfg.log_every == 0 and self.is_main:
            print(f"[trainer] step={self.step} " +
                  " ".join(f"{k}={v:.4g}" for k, v in rec.items() if k != "step"),
                  flush=True)

    def _restart(self, err: Exception):
        """Count a failed step; past ``max_restarts`` raise ``err``, else
        restore the latest checkpoint, if any, for the step's replay."""
        self.restarts += 1
        print(f"[trainer] step {self.step} failed ({err}); "
              f"restart {self.restarts}/{self.cfg.max_restarts}", flush=True)
        if self.restarts > self.cfg.max_restarts:
            raise err
        if self.ckpt.latest_step() is not None:
            self.maybe_resume()

    def run(self) -> Dict[str, Any]:
        try:
            return self._run()
        finally:
            if self._metrics_f:
                self._metrics_f.close()
                self._metrics_f = None

    def _run(self) -> Dict[str, Any]:
        self.maybe_resume()
        while self.step < self.cfg.total_steps:
            if self._preempted:
                self._checkpoint(block=True)
                print(f"[trainer] preempted at step {self.step}; state flushed", flush=True)
                break
            batch = self.stream.batch_at(self.step)
            t0 = time.time()
            try:
                new_state, metrics = self.step_fn(self.state, batch)
                loss = float(metrics.get("loss_total", metrics.get("loss")))
            except Exception as e:  # noqa: BLE001 (the restart path)
                self.ckpt.wait()  # a checkpoint still being written counts
                if self.ckpt.latest_step() is None:
                    # the step may have updated the state in place before it
                    # raised, and no checkpoint holds the state before it
                    if self.init_state is None:
                        print(f"[trainer] step {self.step} failed ({e}) before the "
                              f"first checkpoint: no untouched state to replay from",
                              flush=True)
                        raise
                    self._restart(e)
                    self.state = None   # free it before the new draw
                    self.state, self.step = self.init_state(), 0
                    print("[trainer] no checkpoint yet: the step-0 state drawn again, "
                          "replaying from step 0", flush=True)
                    continue
                self._restart(e)
                continue
            if not np.isfinite(loss):
                self._restart(FloatingPointError(f"non-finite loss {loss}"))
                continue
            self.state = new_state
            dt = time.time() - t0
            # straggler watchdog against the rolling median
            self.step_times.append(dt)
            med = float(np.median(self.step_times[-50:]))
            if len(self.step_times) > 5 and dt > self.cfg.straggler_factor * med:
                self.stragglers += 1
                metrics = dict(metrics, straggler=1.0)
            self.step += 1
            self._log(metrics, dt)
            if self.step % self.cfg.ckpt_every == 0:
                self._checkpoint()
        self.ckpt.wait()
        self._checkpoint(block=True)
        return {"final_step": self.step, "restarts": self.restarts,
                "stragglers": self.stragglers}
