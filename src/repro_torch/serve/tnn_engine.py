"""TNN-as-a-service: the continuous-batching wave pipeline of
``repro.serve.tnn_engine``, on the port's Hopper kernels: by default the
per-layer kernels (``impl="pallas"``, one column-kernel launch per layer
per wave), or the whole-network wave kernel (``impl="fused"``, one launch
per wave).

``n_slots`` fixed batch rows make one gamma wave; every wave admits up to
``n_slots`` queued requests (FIFO), pads a partial wave with the no-op
spike time ``T`` and skips the launch when the queue is empty.

* **Double buffering.** ``poll`` stages and launches dispatch *i+1* (host
  staging, encode, forward, classify, all enqueued on the current CUDA
  stream) BEFORE it waits for dispatch *i*. Each dispatch's (k, n_slots)
  predictions are copied to pinned host memory right behind its classify on
  the same stream, with an event recorded after the copy; waiting on that
  event is the pipeline's only sync point.
* **K-wave superbatch drain.** With ``superbatch_k > 1`` a tick whose
  backlog is deeper than one wave admits up to ``K x n_slots`` requests as
  ONE dispatch of K waves; latency stays per request and every wave counts
  in ``ServeStats.waves``.
* **Latency accounting.** Every request carries enqueue/serve timestamps;
  :meth:`TNNEngine.stats` aggregates them into a :class:`ServeStats`.

The readout is the paper's unsupervised labelling: :meth:`TNNEngine.fit`
runs one labelled pass to build the per-site vote table, and every request
is classified by the soft site vote. :meth:`TNNEngine.from_checkpoint`
serves a training checkpoint's weights and vote table instead.

**Learning while serving** (``online_stdp=True``): every served wave also
runs the trainer's step on a shadow state (``core.network.make_online_step``),
so the shadow equals ``TNNTrainer`` on the same volley stream, while the
requests are classified under the published weights. Every ``swap_every``
learning waves (or on :meth:`hot_swap`) the engine re-labels at the shadow
weights, checkpoints when it has a ``ckpt_dir``, and publishes
``(params, vote_table, version)`` in one tuple assignment; each dispatch
reads that tuple once, so a request never sees one version's weights with
another's table. The train steps update the shadow's tensors in place, so
the shadow starts from clones of the published weights and a swap publishes
clones of the shadow. Requests record their version;
:meth:`TNNEngine.stats_by_version` splits the record by it.

**(data, model) mesh** (``mesh=``, a ``launch.mesh.Mesh2D``): slots shard
over "data" and sites over "model". Every rank runs the same deterministic
admission over the same request stream, encodes the whole slot batch and
cuts its window; the forward, the K-wave drain and the online steps run on
the local rows and site slice, and the last layer's spike times are
gathered over both axes, so classify runs on the logical (unpadded) z on
every rank, as the reference's engine does. A hot swap publishes the same
snapshot on every rank (its re-label forward runs meshed); rank 0 writes
its checkpoint. Class ids are identical on every rank; :meth:`stats` and
:meth:`stats_by_version` are collectives there, which carry rank 0's clock
to every rank.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import random as _random
from repro_torch.checkpoint.checkpointer import (
    Checkpointer, agreed_latest_step, restore_tnn, save_tnn,
    tnn_config_fingerprint,
)
from repro_torch.core.network import (
    NetworkConfig,
    TrainState,
    classify,
    encode_images,
    local_param_cols,
    logical_params,
    make_online_step,
    make_online_superbatch_step,
    network_forward,
    network_forward_superbatch,
    network_mesh_spec,
    params_from_tree,
    params_to_tree,
    refresh_vote_table,
    train_stream_start,
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
    version: Optional[int] = None  # published version it was classified under

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
    ``unserved`` counts the queued requests and the dispatch still in flight
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


# One dispatch: its admitted requests per wave, the host buffer its (k,
# n_slots) predictions land in, and the event recorded after that copy (None
# on CPU).
_Inflight = Tuple[List[List[ClassifyRequest]], torch.Tensor,
                  Optional[torch.cuda.Event]]


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
        superbatch_k: most gamma waves one ``poll`` dispatches when the
            backlog is deeper than ``n_slots``; 1 = one wave a dispatch.
        online_stdp: learn while serving: every served wave also steps a
            shadow training state that :meth:`hot_swap` publishes.
        swap_every: learning waves between automatic hot swaps (0 = only
            explicit :meth:`hot_swap` calls); a swap re-labels, so it needs
            ``fit`` or :meth:`set_label_data` first.
        seed: the shadow stream's seed when ``online_stdp`` starts fresh:
            its key and wave are ``init_train_state(PRNGKey(seed))``'s, as a
            ``TNNTrainConfig(seed=seed)`` trainer's (``from_checkpoint``
            continues the checkpoint's instead).
        ckpt_dir: where hot swaps checkpoint the shadow state and its vote
            table (None = no checkpoint).
        mesh: a (data, model) ``launch.mesh.Mesh2D``: the engine serves on
            the rank's device (``device`` is not read) and holds the rank's
            site slices of the weights; ``n_slots`` must divide by the data
            axis. ``None`` serves in one process.
    """

    def __init__(
        self,
        cfg: NetworkConfig,
        params: Sequence[torch.Tensor],
        n_slots: int = 8,
        impl: str = "pallas",
        device="cuda",
        superbatch_k: int = 1,
        online_stdp: bool = False,
        swap_every: int = 0,
        seed: int = 0,
        ckpt_dir: Optional[str] = None,
        mesh=None,
    ):
        if n_slots < 1:
            raise ValueError(f"n_slots={n_slots} must be >= 1")
        if superbatch_k < 1:
            raise ValueError(f"superbatch_k={superbatch_k} must be >= 1")
        if swap_every < 0:
            raise ValueError(f"swap_every={swap_every} must be >= 0")
        if swap_every and not online_stdp:
            raise ValueError("swap_every needs online_stdp=True: there is no "
                             "shadow state to swap in otherwise")
        if mesh is not None and n_slots % mesh.n_data:
            raise ValueError(f"n_slots={n_slots} not divisible by "
                             f"data axis size {mesh.n_data}")
        cfg = with_impl(cfg, impl)
        self.cfg = cfg
        self.mesh = mesh
        self.spec = network_mesh_spec(cfg, mesh)
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.n_slots = n_slots
        self.superbatch_k = superbatch_k
        # the published snapshot: params, vote table and version move
        # together; a dispatch reads the tuple once, a swap replaces it once
        ps = [w.to(self.device, torch.int8).contiguous() for w in params]
        if mesh is not None:
            ps = self.spec.local_weights(ps)
        self._published: Tuple[List[torch.Tensor], Optional[torch.Tensor], int] = (
            ps, None, 0)
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
        # per-version accounting: latencies, waves, slots, (first, last) retire
        self._lat_by_ver: Dict[int, List[float]] = {}
        self._waves_by_ver: Dict[int, int] = {}
        self._slots_by_ver: Dict[int, int] = {}
        self._span_by_ver: Dict[int, Tuple[float, float]] = {}

        self.online_stdp = online_stdp
        self.swap_every = swap_every
        self.swaps = 0
        self._learn_waves = 0  # learning waves since the last hot swap
        self.ckpt = Checkpointer(ckpt_dir) if ckpt_dir is not None else None
        self.learn_state: Optional[TrainState] = None
        self._online = self._online_sb = None
        if online_stdp:
            self._online = make_online_step(cfg, mesh)
            self._online_sb = (make_online_superbatch_step(cfg, mesh)
                               if superbatch_k > 1 else None)
            self.learn_state = self._shadow(train_stream_start(_random.PRNGKey(seed)))

    def _shadow(self, stream: TrainState) -> TrainState:
        """A shadow state at the published weights (clones: the train steps
        update the shadow in place) on ``stream``'s key and wave."""
        return {"params": params_to_tree([w.clone() for w in self.params]),
                "rng": stream["rng"], "wave": stream["wave"]}

    # -- the published snapshot --------------------------------------------

    @property
    def params(self) -> List[torch.Tensor]:
        """The published serving weights (version ``version``): on a mesh,
        the rank's site slices."""
        return self._published[0]

    def logical_params(self, params: Optional[Sequence[torch.Tensor]] = None
                       ) -> List[torch.Tensor]:
        """``params`` (default: the published weights) at the logical
        extent: on a mesh gathered over the model axis (a collective)."""
        ps = self.params if params is None else list(params)
        return logical_params(params_to_tree(ps), self.cfg, self.mesh)

    @property
    def vote_table(self) -> Optional[torch.Tensor]:
        """The published vote table, built for the published weights."""
        return self._published[1]

    @vote_table.setter
    def vote_table(self, vt: Optional[torch.Tensor]) -> None:
        ps, _, ver = self._published
        self._published = (ps, vt, ver)

    @property
    def version(self) -> int:
        """The publish counter: each :meth:`hot_swap` adds one."""
        return self._published[2]

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
        superbatch_k: int = 1,
        online_stdp: bool = False,
        swap_every: int = 0,
        swap_ckpt_dir: Optional[str] = None,
        mesh=None,
    ) -> "TNNEngine":
        """Serve a TNN training checkpoint (either package's; ``step=None``
        takes the latest): its weights, and its vote table when the trainer
        had run a labelling pass (``extra["has_vote"]``), so the engine
        classifies without a ``fit`` pass. A checkpoint written before any
        labelling pass holds an all-zero table: ``label_data=(images,
        labels)`` rebuilds the readout at load, and without it this raises.

        With ``online_stdp=True`` the shadow continues the checkpoint's key
        and wave counter, so N online waves equal the trainer resuming for
        N waves on the same stream; swap checkpoints go to ``ckpt_dir``
        unless ``swap_ckpt_dir`` names another directory. Checkpoints carry
        no mesh: on a ``mesh`` every rank reads the full tree and cuts its
        window."""
        ckpt = Checkpointer(ckpt_dir)
        if step is None and mesh is not None:
            step = agreed_latest_step(ckpt, mesh)
        if mesh is not None:
            device = mesh.device
        state, extra = restore_tnn(ckpt, cfg, step, device)
        eng = cls(cfg, params_from_tree(state["params"], cfg), n_slots=n_slots,
                  impl=impl, device=device, superbatch_k=superbatch_k,
                  online_stdp=online_stdp, swap_every=swap_every,
                  ckpt_dir=(swap_ckpt_dir or ckpt_dir) if online_stdp
                  else swap_ckpt_dir, mesh=mesh)
        if online_stdp:
            eng.learn_state = eng._shadow(state)
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
        """(b, S, p) spikes -> (b, S, q) last-layer post-WTA times (on a mesh:
        the rank's window through its weights, then gathered)."""
        return self._gather(network_forward(self._local(x), list(ps), self.cfg)[-1])

    def _local(self, x: torch.Tensor, row_axis: int = 0) -> torch.Tensor:
        """Global encoded spikes -> the rank's (rows, sites) window."""
        if self.mesh is None:
            return x
        return self.spec.local_spikes(x, self.cfg.layers[0].column.wave.T,
                                      row_axis=row_axis, site_axis=row_axis + 1)

    def _gather(self, z: torch.Tensor, row_axis: int = 0) -> torch.Tensor:
        """The rank's z window -> the logical z, gathered over both axes."""
        if self.mesh is None:
            return z
        return self.mesh.gather_grid(z, self.spec, row_axis=row_axis,
                                     site_axis=row_axis + 1)

    def _encode(self, images: np.ndarray) -> torch.Tensor:
        imgs = torch.from_numpy(np.ascontiguousarray(images, np.float32))
        return encode_images(imgs.to(self.device), self.cfg)

    # -- readout ----------------------------------------------------------

    def set_label_data(self, images: np.ndarray, labels: np.ndarray) -> None:
        """Encode the labelled set once (in ``n_slots`` chunks, as serving
        stages waves) and keep it on the device for :meth:`fit` and every
        hot swap's re-labelling."""
        images = np.asarray(images, np.float32)
        xs = [self._encode(images[off:off + self.n_slots])
              for off in range(0, images.shape[0], self.n_slots)]
        self._label_set = (torch.cat(xs, dim=0),
                           torch.as_tensor(np.asarray(labels), dtype=torch.int64,
                                           device=self.device))

    def fit(self, images: np.ndarray, labels: np.ndarray) -> None:
        """Build the vote-table readout from one labelled pass (weights are
        not updated); the labelled set is kept for hot swaps."""
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
        """Requests not yet retired: queued + riding the in-flight dispatch."""
        return len(self.queue) + self._in_flight()

    def _in_flight(self) -> int:
        return sum(len(w) for w in self._inflight[0]) if self._inflight else 0

    def _require_vote(self) -> None:
        if self.vote_table is None:
            raise RuntimeError("call fit(images, labels) before serving")

    def _admit(self) -> List[ClassifyRequest]:
        admitted: List[ClassifyRequest] = []
        while self.queue and len(admitted) < self.n_slots:
            admitted.append(self.queue.popleft())
        return admitted

    def _admit_waves(self, max_waves: int) -> List[List[ClassifyRequest]]:
        """FIFO-admit up to ``max_waves`` waves (only the last may be
        partial)."""
        waves: List[List[ClassifyRequest]] = []
        while self.queue and len(waves) < max_waves:
            waves.append(self._admit())
        return waves

    def _stage_wave(self, admitted: List[ClassifyRequest]) -> torch.Tensor:
        """Host stack, encode and no-op pad one wave to the (n_slots, S, p)
        spike shape, alone or inside a superbatch."""
        return pad_batch_rows(
            self._encode(np.stack([np.asarray(r.image, np.float32)
                                   for r in admitted])),
            self.n_slots, self.T)

    def _dispatch(self, admitted: List[ClassifyRequest]) -> _Inflight:
        """Stage one wave and enqueue forward (online: the online step) +
        classify + the copy of the predictions to host memory, under one
        read of the published tuple. Nothing here waits for the device."""
        ps, vt, ver = self._published
        if self._t_first is None:
            self._t_first = time.perf_counter()
        x = self._stage_wave(admitted)
        if self._online is not None:
            self.learn_state, z = self._online(ps, self.learn_state, self._local(x))
            z = self._gather(z)
            self._learn_waves += 1
        else:
            z = self._forward(ps, x)
        return self._readout([admitted], z, vt, ver)

    def _dispatch_super(self, waves: List[List[ClassifyRequest]]) -> _Inflight:
        """Stage K waves and enqueue them as one dispatch: the K-wave forward
        (online: the K-wave online step) and one classify over the K x
        n_slots rows, all under one read of the published tuple. Classify is
        row-independent, so every class id equals K single dispatches'."""
        ps, vt, ver = self._published
        if self._t_first is None:
            self._t_first = time.perf_counter()
        x_k = self._local(torch.stack([self._stage_wave(w) for w in waves]), 1)
        if self._online_sb is not None:
            self.learn_state, z_k = self._online_sb(ps, self.learn_state, x_k)
            self._learn_waves += len(waves)
        else:
            z_k = network_forward_superbatch(x_k, ps, self.cfg)[-1]
        z_k = self._gather(z_k, 1)
        return self._readout(waves, z_k.reshape(-1, *z_k.shape[2:]), vt, ver)

    def _readout(self, waves: List[List[ClassifyRequest]], z: torch.Tensor,
                 vt: torch.Tensor, ver: int) -> _Inflight:
        """Tag the requests with ``ver``, enqueue classify and the copy of the
        (k, n_slots) predictions to pinned host memory, and record the event
        the retire waits on."""
        for w in waves:
            for req in w:
                req.version = ver
        preds = classify(z, vt, self.T, soft=True).reshape(len(waves), self.n_slots)
        if self.device.type != "cuda":
            return waves, preds, None
        host = torch.empty(preds.shape, dtype=preds.dtype, pin_memory=True)
        host.copy_(preds, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return waves, host, event

    def _retire(self, dispatch: _Inflight) -> int:
        """Wait for one dispatch's predictions (the pipeline's only sync
        point) and complete its requests with serve timestamps; every wave
        counts in the totals and in its version's."""
        waves, host, event = dispatch
        if event is not None:
            event.synchronize()
        preds = host.numpy()
        now = time.perf_counter()
        for w, admitted in enumerate(waves):
            ver = admitted[0].version  # one snapshot per dispatch
            for slot, req in enumerate(admitted):
                req.result = int(preds[w, slot])
                req.t_done = now
                self.done[req.uid] = req
                lat = 1e3 * (now - req.t_enqueue) if req.t_enqueue else 0.0
                self._lat_ms.append(lat)
                self._lat_by_ver.setdefault(ver, []).append(lat)
            self._slots_filled += len(admitted)
            self._waves_by_ver[ver] = self._waves_by_ver.get(ver, 0) + 1
            self._slots_by_ver[ver] = self._slots_by_ver.get(ver, 0) + len(admitted)
            first, _ = self._span_by_ver.get(ver, (now, now))
            self._span_by_ver[ver] = (first, now)
        self.waves_served += len(waves)
        self._t_last = now
        return sum(len(w) for w in waves)

    def _drain_inflight(self) -> int:
        if self._inflight is None:
            return 0
        dispatch, self._inflight = self._inflight, None
        return self._retire(dispatch)

    # -- learning while serving ----------------------------------------------

    def _maybe_swap(self) -> None:
        """Publish the shadow once ``swap_every`` learning waves have
        accumulated; called at the top of every tick, so the next dispatch
        classifies under the new version while the one in flight keeps its
        own."""
        if self.swap_every and self._learn_waves >= self.swap_every:
            self.hot_swap()

    def hot_swap(self, block: bool = False) -> int:
        """Publish the shadow weights as version v+1, in order: (1) re-label
        at the shadow weights through ``refresh_vote_table`` on the stored
        labelled set; (2) with a ``ckpt_dir``, checkpoint the shadow state
        and that table in the trainer's layout (``block`` waits for the
        write); (3) publish params, table and version in ONE tuple
        assignment. The published weights are clones: the next online wave
        updates the shadow in place while this version's requests may still
        be in flight. Returns the new version."""
        if not self.online_stdp:
            raise RuntimeError("hot_swap needs online_stdp=True: a serve-only "
                               "engine has no shadow weights")
        if self._label_set is None:
            raise RuntimeError(
                "hot_swap rebuilds the vote table at the new weights and needs "
                "a labelled set: call fit(images, labels) or "
                "set_label_data(images, labels) before swapping")
        new_ps = [w.clone() for w in params_from_tree(
            self.learn_state["params"], self.cfg,
            n_cols=local_param_cols(self.cfg, self.mesh))]
        x, labs = self._label_set
        vt = refresh_vote_table(self._forward, new_ps, x, labs, self.cfg,
                                self.n_slots)
        wave = int(self.learn_state["wave"])
        if self.ckpt is not None:
            save_tnn(
                self.ckpt, self.cfg, wave, dict(self.learn_state, vote_table=vt),
                mesh=self.mesh, extra={"arch": "tnn-mnist",
                       "config": tnn_config_fingerprint(self.cfg),
                       "wave": wave, "has_vote": True, "eval_wave": wave,
                       "accuracy": None},
                block=block)
        ver = self.version + 1
        self._published = (new_ps, vt, ver)  # the atomic publish
        self.swaps += 1
        self._learn_waves = 0
        return ver

    # -- ticks -------------------------------------------------------------

    def step(self) -> int:
        """One LOCK-STEP tick: admit up to ``n_slots`` requests, run one
        wave, wait, complete them. Returns how many were served. The
        reference loop the pipelined :meth:`poll` is checked against."""
        self._require_vote()
        self._maybe_swap()
        if not self.queue:
            return 0
        return self._retire(self._dispatch(self._admit()))

    def poll(self) -> int:
        """One PIPELINED tick: a due hot swap publishes first; then stage and
        launch the next dispatch (skipped when the queue is empty: K waves
        when ``superbatch_k > 1`` and the backlog is deeper than one wave),
        THEN wait for the dispatch launched before. Returns requests
        retired this tick."""
        self._require_vote()
        self._maybe_swap()
        nxt = None
        if self.queue:
            if self.superbatch_k > 1 and len(self.queue) > self.n_slots:
                k = min(self.superbatch_k, -(-len(self.queue) // self.n_slots))
                nxt = self._dispatch_super(self._admit_waves(k))
            else:
                nxt = self._dispatch(self._admit())
        served = self._drain_inflight()
        self._inflight = nxt
        return served

    def run_until_done(self, max_ticks: int = 10_000, *,
                       pipelined: bool = True) -> Dict[int, ClassifyRequest]:
        """Serve until the queue drains. ``pipelined=False`` runs the
        lock-step loop. Hitting ``max_ticks`` with requests outstanding
        raises :class:`ServeTimeout`; the dispatch in flight is not waited
        for and stays in flight."""
        ticks = 0
        served = 0
        while self.queue or self._inflight is not None:
            if ticks >= max_ticks:
                in_flight = self._in_flight()
                raise ServeTimeout(served=served,
                                   unserved=len(self.queue) + in_flight,
                                   max_ticks=max_ticks, in_flight=in_flight)
            served += self.poll() if pipelined else self.step()
            ticks += 1
        return self.done

    # -- latency accounting ------------------------------------------------

    def _mk_stats(self, lat_ms: List[float], waves: int, wall: float,
                  slots_filled: int) -> ServeStats:
        """One record; on a mesh (a collective) its clock readings are rank
        0's, so every rank returns the same stats."""
        served = len(lat_ms)
        lat = np.asarray(lat_ms, np.float64)
        p50 = float(np.percentile(lat, 50)) if served else 0.0
        p95 = float(np.percentile(lat, 95)) if served else 0.0
        if self.mesh is not None:
            wall, p50, p95 = self.mesh.broadcast_floats([wall, p50, p95])
        return ServeStats(
            requests=served,
            waves=waves,
            wall_s=wall,
            waves_per_s=waves / wall if wall > 0 else 0.0,
            images_per_s=served / wall if wall > 0 else 0.0,
            p50_ms=p50,
            p95_ms=p95,
            occupancy=(slots_filled / (waves * self.n_slots)) if waves else 0.0,
        )

    def stats(self) -> ServeStats:
        """Aggregate the serve record so far."""
        wall = ((self._t_last - self._t_first)
                if self._t_first is not None and self._t_last is not None
                else 0.0)
        return self._mk_stats(self._lat_ms, self.waves_served, wall,
                              self._slots_filled)

    def stats_by_version(self) -> Dict[int, ServeStats]:
        """The serve record split by the published version each request was
        classified under; a version's ``wall_s`` spans its first to last
        retire."""
        out: Dict[int, ServeStats] = {}
        for ver, lat in sorted(self._lat_by_ver.items()):
            first, last = self._span_by_ver[ver]
            out[ver] = self._mk_stats(lat, self._waves_by_ver.get(ver, 0),
                                      last - first, self._slots_by_ver.get(ver, 0))
        return out

    def reset(self) -> None:
        """Forget served requests and latency samples between load runs;
        the published snapshot, version and shadow state stay."""
        self._drain_inflight()
        self.queue.clear()
        self.done = {}
        self.waves_served = 0
        self._lat_ms = []
        self._slots_filled = 0
        self._t_first = self._t_last = None
        self._lat_by_ver = {}
        self._waves_by_ver = {}
        self._slots_by_ver = {}
        self._span_by_ver = {}
