"""Input pipelines: the training loader, a deterministic synthetic corpus
sharded per data-parallel rank with a checkpointable cursor
(:class:`ShardedLoader`, :func:`make_batch_spec`), and
:class:`Prefetcher`, a bounded background prefetch over any iterator (the
streaming replay's :class:`~repro_torch.data.trace_store.TraceStore`
chunk windows).

The synthetic corpus is a seeded Markov-ish token stream (transition
structure gives a model something to learn, so a training run's loss
falls).  Every (seed, shard, step) triple is reproducible, so restoring
``{"step": n}`` resumes the exact stream.  The loader is numpy, as the
reference's: its batches are bit-identical to the JAX package's for a
seed.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig


def make_batch_spec(cfg: ArchConfig, seq_len: int, batch: int) -> Dict:
    spec = {"tokens": ((batch, seq_len, cfg.n_codebooks) if cfg.n_codebooks
                       else (batch, seq_len))}
    if cfg.cross_attn_every:
        spec["frontend"] = (batch, cfg.n_frontend_tokens, cfg.d_model)
    return spec


class ShardedLoader:
    """Per-DP-rank loader.  ``state()``/``restore()`` capture the cursor."""

    def __init__(self, cfg: ArchConfig, seq_len: int, per_shard_batch: int,
                 shard: int = 0, num_shards: int = 1, seed: int = 1234) -> None:
        self.cfg = cfg
        self.seq_len = seq_len
        self.batch = per_shard_batch
        self.shard = shard
        self.num_shards = num_shards
        self.seed = seed
        self._step = 0
        # fixed Markov transition table (shared across shards)
        rng = np.random.default_rng(seed)
        self._n_states = 64
        v = min(cfg.vocab, 1 << 15)
        self._emit = rng.integers(0, v, size=(self._n_states, 8))
        self._trans = rng.integers(0, self._n_states, size=(self._n_states, 8))

    # ------------------------------------------------------------- batches
    def _tokens(self, rng: np.random.Generator, shape) -> np.ndarray:
        # Vectorized Markov walk, byte-identical to the original
        # per-element loop (the rng draw order — one state draw, then one
        # batched choice draw — is part of the contract).  Each choice c
        # induces a state map s -> trans[s, c]; the state *before* step i
        # is the composition of the first i maps applied to the start
        # state, computed in O(log n) doubling passes over (n, 64) maps.
        flat = int(np.prod(shape))
        state = int(rng.integers(0, self._n_states))
        choices = rng.integers(0, 8, size=flat)
        if flat == 0:
            return np.empty(shape, np.int32)
        states = np.empty(flat, np.intp)
        states[0] = state
        if flat > 1:
            # maps[i] = the map applied after emitting token i
            # (state_{i+1} = maps[i][state_i]); inclusive prefix compose.
            maps = self._trans.T[choices[:-1]]
            d = 1
            while d < maps.shape[0]:
                maps[d:] = np.take_along_axis(maps[d:], maps[:-d], axis=1)
                d *= 2
            states[1:] = maps[:, state]
        out = self._emit[states, choices].astype(np.int32)
        return out.reshape(shape)

    def next(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed, self.shard, self._step, 0xD00D))
        self._step += 1
        batch = {"tokens": self._tokens(
            rng, make_batch_spec(self.cfg, self.seq_len, self.batch)["tokens"])}
        if self.cfg.cross_attn_every:
            batch["frontend"] = rng.standard_normal(
                (self.batch, self.cfg.n_frontend_tokens, self.cfg.d_model)
            ).astype(np.float32) * 0.1
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()

    # --------------------------------------------------------------- state
    def state(self) -> Dict:
        return {"step": self._step, "shard": self.shard, "seed": self.seed}

    def restore(self, state: Dict) -> None:
        if state.get("seed", self.seed) != self.seed:
            raise ValueError("restoring loader with a different seed")
        self._step = int(state["step"])
        self.shard = int(state.get("shard", self.shard))


_DONE = object()


class Prefetcher:
    """Double-buffered background prefetch over any iterator.

    A producer thread pulls items from ``it`` into a bounded queue of
    ``depth`` slots, so the consumer (e.g. a replay chunk loop) overlaps
    the next window's disk read with the current window's compute while
    holding at most ``depth + 1`` items alive — the streaming-replay
    memory bound.  Producer exceptions are re-raised in the consumer at
    the point of ``next()``; ``close()`` stops the producer and drains
    the queue (safe to call twice, and from ``finally``).
    """

    def __init__(self, it, depth: int = 2) -> None:
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._buffered = 0
        self.peak_buffered_bytes = 0
        self._thread = threading.Thread(
            target=self._produce, args=(iter(it),), daemon=True)
        self._thread.start()

    @staticmethod
    def _nbytes(item) -> int:
        if isinstance(item, np.ndarray):
            return int(item.nbytes)
        if isinstance(item, dict):
            return sum(Prefetcher._nbytes(v) for v in item.values())
        if isinstance(item, (tuple, list)):
            return sum(Prefetcher._nbytes(v) for v in item)
        return 0

    def _produce(self, it) -> None:
        try:
            for item in it:
                if self._stop.is_set():
                    return
                nb = self._nbytes(item)
                with self._lock:
                    self._buffered += nb
                    self.peak_buffered_bytes = max(
                        self.peak_buffered_bytes, self._buffered)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                else:
                    return
        except BaseException as exc:  # forwarded to the consumer
            self._err = exc
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(_DONE, timeout=0.1)
                    return
                except queue.Full:
                    continue

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self):
        item = self._q.get()
        if item is _DONE:
            self._q.put(_DONE)  # keep exhaustion idempotent
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        with self._lock:
            self._buffered -= self._nbytes(item)
        return item

    def close(self) -> None:
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)
