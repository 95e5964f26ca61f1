"""TNN-as-a-service: the continuous-batching wave pipeline of
``repro.serve.tnn_engine``, on the port's Hopper kernels: by default the
per-layer kernels (``impl="pallas"``, one column-kernel launch per layer
per wave), or the whole-network wave kernel (``impl="fused"``, one launch
per wave).

``n_slots`` fixed batch rows make one gamma wave; every wave admits up to
``n_slots`` queued requests (FIFO), pads a partial wave with the no-op
spike time ``T`` and skips the launch when the queue is empty.

* **Double buffering.** ``poll`` stages and launches wave *i+1* (host
  staging, encode, forward, classify, all enqueued on the current CUDA
  stream) BEFORE it waits for wave *i*. Each wave's (n_slots,) predictions
  are copied to pinned host memory right behind its classify on the same
  stream, with an event recorded after the copy; waiting on that event is
  the pipeline's only sync point, so wave *i+1*'s device work is never
  waited for early.
* **Latency accounting.** Every request carries enqueue/serve timestamps;
  :meth:`TNNEngine.stats` aggregates them into a :class:`ServeStats`.

The readout is the paper's unsupervised labelling: :meth:`TNNEngine.fit`
runs one labelled pass to build the per-site vote table, and every request
is classified by the soft site vote. :meth:`TNNEngine.from_checkpoint`
serves a training checkpoint's weights and vote table instead.

Not ported yet: device meshes, learning while serving (online STDP and hot
swap) and K-wave superbatch drains.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.network import (
    NetworkConfig,
    classify,
    encode_images,
    network_forward,
    params_from_tree,
    refresh_vote_table,
    with_impl,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.padding import pad_batch_rows


@dataclasses.dataclass
class ClassifyRequest:
    uid: int
    image: np.ndarray  # (H, W) float intensities in [0, 1]
    result: Optional[int] = None  # class id, filled when served
    t_enqueue: Optional[float] = None  # perf_counter at submit()
    t_done: Optional[float] = None  # perf_counter when the wave retired

    @property
    def latency_s(self) -> Optional[float]:
        """Enqueue-to-serve latency: queueing + staging + wave compute."""
        if self.t_enqueue is None or self.t_done is None:
            return None
        return self.t_done - self.t_enqueue


@dataclasses.dataclass(frozen=True)
class ServeStats:
    """Aggregate serving record. ``wall_s`` spans first dispatch to last
    retire; occupancy is served rows over offered slot rows
    (``waves * n_slots``)."""

    requests: int
    waves: int
    wall_s: float
    waves_per_s: float
    images_per_s: float
    p50_ms: float
    p95_ms: float
    occupancy: float


class ServeTimeout(RuntimeError):
    """``run_until_done`` hit ``max_ticks`` with requests outstanding.
    ``unserved`` counts the queued requests and the wave still in flight
    (``in_flight``); a later ``poll``/``run_until_done`` retires them."""

    def __init__(self, served: int, unserved: int, max_ticks: int,
                 in_flight: int = 0):
        self.served = served
        self.unserved = unserved
        self.max_ticks = max_ticks
        self.in_flight = in_flight
        super().__init__(
            f"run_until_done hit max_ticks={max_ticks} with {unserved} "
            f"request(s) outstanding ({served} served, {in_flight} of the "
            f"unserved still in flight)")


# One dispatched wave: its admitted requests, the host buffer its
# predictions land in, and the event recorded after that copy (None on CPU).
_Inflight = Tuple[List[ClassifyRequest], torch.Tensor, Optional[torch.cuda.Event]]


class TNNEngine:
    """Continuous-batching classification engine for the TNN prototype.

    Args:
        cfg: network config; its backend is overridden by ``impl``.
        params: per-layer int8 weight tensors (as from ``init_network``,
            ``network_train_wave`` or ``convert.params_from_numpy``); they
            are moved to ``device``.
        n_slots: images per gamma wave (the fixed batch shape).
        impl: ``"pallas"`` (default, as in the reference) classifies each
            wave through the per-layer column kernel, one launch per layer;
            ``"fused"`` in ONE wave-kernel launch; ``"direct"`` and
            ``"matmul"`` run the plain per-layer forms. All give the same
            class ids.
        device: ``"cuda"`` (default) or ``"cpu"`` (the plain PyTorch path).
    """

    def __init__(
        self,
        cfg: NetworkConfig,
        params: Sequence[torch.Tensor],
        n_slots: int = 8,
        impl: str = "pallas",
        device="cuda",
    ):
        if n_slots < 1:
            raise ValueError(f"n_slots={n_slots} must be >= 1")
        cfg = with_impl(cfg, impl)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.params: List[torch.Tensor] = [
            w.to(self.device, torch.int8).contiguous() for w in params]
        self.vote_table: Optional[torch.Tensor] = None
        self.T = cfg.layers[-1].column.wave.T
        self.queue: Deque[ClassifyRequest] = collections.deque()
        self.done: Dict[int, ClassifyRequest] = {}
        self.waves_served = 0
        self._inflight: Optional[_Inflight] = None
        self._lat_ms: List[float] = []
        self._slots_filled = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._label_set: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    @classmethod
    def from_checkpoint(
        cls,
        ckpt_dir: str,
        cfg: NetworkConfig,
        *,
        step: Optional[int] = None,
        n_slots: int = 8,
        impl: str = "pallas",
        label_data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        device="cuda",
    ) -> "TNNEngine":
        """Serve a TNN training checkpoint (either package's; ``step=None``
        takes the latest): its weights, and its vote table when the trainer
        had run a labelling pass (``extra["has_vote"]``), so the engine
        classifies without a ``fit`` pass. A checkpoint written before any
        labelling pass holds an all-zero table: ``label_data=(images,
        labels)`` rebuilds the readout at load, and without it this raises.
        The checkpoint's key and wave counter are not used (learning while
        serving is not ported)."""
        from repro_torch.checkpoint.checkpointer import Checkpointer, restore_tnn

        state, extra = restore_tnn(Checkpointer(ckpt_dir), cfg, step, device)
        eng = cls(cfg, params_from_tree(state["params"], cfg), n_slots=n_slots,
                  impl=impl, device=device)
        if label_data is not None:
            eng.set_label_data(*label_data)
        if extra.get("has_vote"):
            eng.vote_table = state["vote_table"]
        elif label_data is not None:
            x, labs = eng._label_set
            eng.vote_table = refresh_vote_table(
                eng._forward, eng.params, x, labs, eng.cfg, n_slots)
        else:
            raise ValueError(
                f"checkpoint step {extra.get('wave', step)} under {ckpt_dir!r} "
                f"has no vote table (extra['has_vote'] is falsy: it was "
                f"written before any labelling pass). Pass label_data=(images, "
                f"labels) to rebuild the readout at load, or serve a "
                f"checkpoint written after an eval pass.")
        return eng

    def _forward(self, ps: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """(b, S, p) spikes -> (b, S, q) last-layer post-WTA times."""
        return network_forward(x, list(ps), self.cfg)[-1]

    def _encode(self, images: np.ndarray) -> torch.Tensor:
        imgs = torch.from_numpy(np.ascontiguousarray(images, np.float32))
        return encode_images(imgs.to(self.device), self.cfg)

    # -- readout ----------------------------------------------------------

    def set_label_data(self, images: np.ndarray, labels: np.ndarray) -> None:
        """Encode the labelled set once (in ``n_slots`` chunks, as serving
        stages waves) and keep it on the device for :meth:`fit`."""
        images = np.asarray(images, np.float32)
        xs = [self._encode(images[off:off + self.n_slots])
              for off in range(0, images.shape[0], self.n_slots)]
        self._label_set = (torch.cat(xs, dim=0),
                           torch.as_tensor(np.asarray(labels), dtype=torch.int64,
                                           device=self.device))

    def fit(self, images: np.ndarray, labels: np.ndarray) -> None:
        """Build the vote-table readout from one labelled pass (weights are
        not updated)."""
        self.set_label_data(images, labels)
        x, labs = self._label_set
        self.vote_table = refresh_vote_table(
            self._forward, self.params, x, labs, self.cfg, self.n_slots)

    # -- request loop ------------------------------------------------------

    def submit(self, req: ClassifyRequest) -> None:
        req.t_enqueue = time.perf_counter()
        self.queue.append(req)

    @property
    def pending(self) -> int:
        """Requests not yet retired: queued + riding the in-flight wave."""
        inflight = len(self._inflight[0]) if self._inflight else 0
        return len(self.queue) + inflight

    def _require_vote(self) -> None:
        if self.vote_table is None:
            raise RuntimeError("call fit(images, labels) before serving")

    def _admit(self) -> List[ClassifyRequest]:
        admitted: List[ClassifyRequest] = []
        while self.queue and len(admitted) < self.n_slots:
            admitted.append(self.queue.popleft())
        return admitted

    def _dispatch(self, admitted: List[ClassifyRequest]) -> _Inflight:
        """Stage one wave (host stack, encode, no-op pad to the slot shape)
        and enqueue forward + classify + the copy of the predictions to
        host memory. Nothing here waits for the device."""
        if self._t_first is None:
            self._t_first = time.perf_counter()
        x = pad_batch_rows(
            self._encode(np.stack([np.asarray(r.image, np.float32)
                                   for r in admitted])),
            self.n_slots, self.T)
        preds = classify(self._forward(self.params, x), self.vote_table,
                         self.T, soft=True)
        if self.device.type != "cuda":
            return admitted, preds, None
        host = torch.empty(preds.shape, dtype=preds.dtype, pin_memory=True)
        host.copy_(preds, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return admitted, host, event

    def _retire(self, wave: _Inflight) -> int:
        """Wait for one wave's predictions (the pipeline's only sync point)
        and complete its requests with serve timestamps."""
        admitted, host, event = wave
        if event is not None:
            event.synchronize()
        preds = host.numpy()
        now = time.perf_counter()
        for slot, req in enumerate(admitted):
            req.result = int(preds[slot])
            req.t_done = now
            self.done[req.uid] = req
            self._lat_ms.append(1e3 * (now - req.t_enqueue)
                                if req.t_enqueue else 0.0)
        self._slots_filled += len(admitted)
        self.waves_served += 1
        self._t_last = now
        return len(admitted)

    def _drain_inflight(self) -> int:
        if self._inflight is None:
            return 0
        wave, self._inflight = self._inflight, None
        return self._retire(wave)

    def step(self) -> int:
        """One LOCK-STEP tick: admit up to ``n_slots`` requests, run one
        wave, wait, complete them. Returns how many were served. The
        reference loop the pipelined :meth:`poll` is checked against."""
        self._require_vote()
        if not self.queue:
            return 0
        return self._retire(self._dispatch(self._admit()))

    def poll(self) -> int:
        """One PIPELINED tick: stage + launch the next wave (skipped when
        the queue is empty), THEN wait for the previously launched wave.
        Returns requests retired this tick."""
        self._require_vote()
        nxt = self._dispatch(self._admit()) if self.queue else None
        served = self._drain_inflight()
        self._inflight = nxt
        return served

    def run_until_done(self, max_ticks: int = 10_000, *,
                       pipelined: bool = True) -> Dict[int, ClassifyRequest]:
        """Serve until the queue drains. ``pipelined=False`` runs the
        lock-step loop. Hitting ``max_ticks`` with requests outstanding
        raises :class:`ServeTimeout`; the wave in flight is not waited for
        and stays in flight."""
        ticks = 0
        served = 0
        while self.queue or self._inflight is not None:
            if ticks >= max_ticks:
                in_flight = len(self._inflight[0]) if self._inflight else 0
                raise ServeTimeout(served=served,
                                   unserved=len(self.queue) + in_flight,
                                   max_ticks=max_ticks, in_flight=in_flight)
            served += self.poll() if pipelined else self.step()
            ticks += 1
        return self.done

    # -- latency accounting ------------------------------------------------

    def stats(self) -> ServeStats:
        """Aggregate the serve record so far."""
        wall = ((self._t_last - self._t_first)
                if self._t_first is not None and self._t_last is not None
                else 0.0)
        served = len(self._lat_ms)
        lat = np.asarray(self._lat_ms, np.float64)
        waves = self.waves_served
        return ServeStats(
            requests=served,
            waves=waves,
            wall_s=wall,
            waves_per_s=waves / wall if wall > 0 else 0.0,
            images_per_s=served / wall if wall > 0 else 0.0,
            p50_ms=float(np.percentile(lat, 50)) if served else 0.0,
            p95_ms=float(np.percentile(lat, 95)) if served else 0.0,
            occupancy=(self._slots_filled / (waves * self.n_slots)) if waves else 0.0,
        )

    def reset(self) -> None:
        """Forget served requests and latency samples between load runs;
        params and vote table stay."""
        self._drain_inflight()
        self.queue.clear()
        self.done = {}
        self.waves_served = 0
        self._lat_ms = []
        self._slots_filled = 0
        self._t_first = self._t_last = None
