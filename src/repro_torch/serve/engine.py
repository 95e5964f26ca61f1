"""Batched LM serving engine (continuous-batching-lite), as
``repro.serve.engine`` runs it.

Fixed-slot engine: ``n_slots`` concurrent sequences share one decode step;
finished sequences free their slot, and queued requests (FIFO) are
prefilled into free slots between decode steps. All per-slot state lives in
ONE batched cache (slot = batch row, bfloat16 whatever ``cfg.dtype`` is, as
the reference keeps it), so each tick is a single batched decode with
per-row positions, whatever the request mix.

Greedy sampling, or temperature sampling on the reference's key chain
(``split``, then ``categorical``, bit for bit ``jax.random``'s draws); the
first token of a request is the prefill's argmax either way. A slot stops
on its eos id, its ``max_new_tokens`` or at position ``max_len - 1``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import random as _random
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.params import tree_flatten, tree_map

CACHE_DTYPE = torch.bfloat16


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int
    max_new_tokens: int = 16
    eos_id: int = -1  # -1: never
    out_tokens: Optional[List[int]] = None
    # with Engine(record=True): per output token, the float32 logits it was
    # drawn from and the trunk increment of the position that produced it
    logits: Optional[List[torch.Tensor]] = None
    increments: Optional[List[torch.Tensor]] = None


class Engine:
    """``params`` is a param tree (``models.model.init_params``); the engine
    keeps one compute copy of it in ``cfg.dtype`` on ``device`` (norm scales
    stay float32). ``prefill_ms`` and ``decode_ms`` hold the host wall time
    of every prefill and decode tick, each ending in the sync that reads its
    tokens."""

    def __init__(self, cfg: ModelConfig, params, n_slots: int = 4,
                 max_len: int = 256, temperature: float = 0.0, seed: int = 0,
                 device="cuda", record: bool = False):
        M.check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = M.compute_params(
            tree_map(lambda t: t.to(self.device), params), cfg.dtype)
        self.n_slots = n_slots
        self.max_len = max_len
        self.temperature = temperature
        self.record = record
        self.rng = _random.PRNGKey(seed)
        self.cache = M.init_cache(cfg, n_slots, max_len, CACHE_DTYPE, self.device)
        self.pos = np.zeros(n_slots, np.int64)  # per-slot next position
        self.active: List[Optional[Request]] = [None] * n_slots
        self.last_token = np.zeros(n_slots, np.int64)
        self.queue: List[Request] = []
        self.done: Dict[int, Request] = {}
        self.prefill_ms: List[float] = []
        self.decode_ms: List[float] = []

    # -- request management ----------------------------------------------

    def submit(self, req: Request) -> None:
        req.out_tokens = []
        if self.record:
            req.logits, req.increments = [], []
        self.queue.append(req)

    def _admit(self) -> None:
        for slot in range(self.n_slots):
            if self.active[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            t0 = time.perf_counter()
            # prefill this slot: one-row prefill into a 1-row cache, then
            # written into the batched cache at `slot` (axis 1 of every
            # stacked trunk leaf is the batch axis)
            toks = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int64,
                                   device=self.device)[None]
            cache1 = M.init_cache(self.cfg, 1, self.max_len, CACHE_DTYPE, self.device)
            out = M.prefill(self.params, self.cfg, toks, cache1, increment=self.record)
            logits, cache1 = out[0], out[1]
            for (_, full), (_, one) in zip(tree_flatten(self.cache), tree_flatten(cache1)):
                full[:, slot] = one[:, 0]
            self.active[slot] = req
            self.pos[slot] = len(req.prompt)
            self.last_token[slot] = int(torch.argmax(logits[0]))
            req.out_tokens.append(int(self.last_token[slot]))
            if self.record:
                req.logits.append(logits[0].float().cpu())
                req.increments.append(out[2][0, -1].cpu())
            self.prefill_ms.append((time.perf_counter() - t0) * 1e3)

    # -- decode loop -------------------------------------------------------

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        self.rng, k = _random.split(self.rng)
        # logits / temperature with the temperature in the logits' dtype
        t = torch.full_like(logits, self.temperature)
        scaled = (logits.float() / t.float()).to(logits.dtype)
        return _random.categorical(k, scaled).cpu().numpy()

    def step(self) -> int:
        """One engine tick: admit -> ONE batched decode for all slots (per-row
        positions; idle rows decode harmlessly into their own stale slots and
        are ignored). Returns number of active slots."""
        self._admit()
        slots = [i for i, r in enumerate(self.active) if r is not None]
        if not slots:
            return 0
        t0 = time.perf_counter()
        tok = torch.as_tensor(self.last_token, device=self.device)
        pos = torch.as_tensor(self.pos, device=self.device)  # (n_slots,) per-row
        out = M.decode_step(self.params, self.cfg, tok, pos, self.cache,
                            increment=self.record)
        logits = out[0]
        nxt = self._sample(logits)
        self.decode_ms.append((time.perf_counter() - t0) * 1e3)
        if self.record:
            rows = logits.float().cpu()
            incs = out[2].cpu()
        for s in slots:
            req = self.active[s]
            t = int(nxt[s])
            req.out_tokens.append(t)
            if self.record:
                req.logits.append(rows[s])
                req.increments.append(incs[s])
            self.pos[s] += 1
            if (len(req.out_tokens) >= req.max_new_tokens
                    or t == req.eos_id or self.pos[s] >= self.max_len - 1):
                self.done[req.uid] = req
                self.active[s] = None
            else:
                self.last_token[s] = t
        return len([r for r in self.active if r is not None])

    def run_until_done(self, max_ticks: int = 10_000) -> Dict[int, Request]:
        ticks = 0
        while (self.queue or any(self.active)) and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.done
