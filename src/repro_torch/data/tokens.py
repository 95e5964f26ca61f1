"""Synthetic token pipeline: deterministic, shardable, resumable.

A copy of ``repro.data.tokens``: importing that module would import the JAX
package, which the port never does. Batches are numpy on the host, equal to
the reference's bit for bit for any ``(seed, step, shard, num_shards,
structured)``; the train step moves them to its device.

Every batch is a pure function of ``(seed, step, shard)``, so exact resume
after preemption needs only the step counter (stored in a checkpoint's
``extra``), each host generates only its own shard, and re-sharding re-slices
the same global stream. A background prefetch thread keeps ``depth`` batches
ahead.

The stream mixes structured sequences (repeated n-gram motifs with 5% noise)
rather than uniform noise, so short training runs show the loss move.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


class TokenStream:
    def __init__(self, vocab_size: int, batch: int, seq: int, seed: int = 0,
                 shard: int = 0, num_shards: int = 1, structured: bool = True):
        if batch % num_shards:
            raise ValueError(f"batch {batch} not divisible by {num_shards} shards")
        self.vocab = vocab_size
        self.batch = batch // num_shards
        self.seq = seq
        self.seed = seed
        self.shard = shard
        self.num_shards = num_shards
        self.structured = structured

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """``{"tokens": (B, S), "labels": (B, S)}``, the labels the tokens
        shifted by one; the draws in the reference's call order, and its
        dtypes (int32, or int64 where the structured stream's noise
        ``np.where`` promotes)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))
        B, S, V = self.batch, self.seq, self.vocab
        if not self.structured:
            toks = rng.integers(0, V, (B, S + 1), dtype=np.int32)
        else:
            motif_len = 8
            n_motifs = 64
            motifs = rng.integers(0, V, (n_motifs, motif_len), dtype=np.int32)
            idx = rng.integers(0, n_motifs, (B, (S + 1) // motif_len + 1))
            toks = motifs[idx].reshape(B, -1)[:, : S + 1].astype(np.int32)
            noise = rng.random((B, S + 1)) < 0.05
            toks = np.where(noise, rng.integers(0, V, (B, S + 1)), toks)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


class Prefetcher:
    """Background-thread double buffering over any ``batch_at(step)`` source:
    iterating yields ``(step, batch)`` from ``start_step`` on."""

    def __init__(self, source: TokenStream, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
