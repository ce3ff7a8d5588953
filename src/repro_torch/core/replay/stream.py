"""Streaming replay front end: the scan lane straight from a TraceStore.

``replay_stream(path_or_store, device, chunk_size=...)`` replays an
on-disk columnar trace (:class:`repro_torch.data.trace_store.TraceStore`)
through :meth:`~repro_torch.core.replay.engine.ReplayEngine.run_store`
without ever holding the full trace in host or device memory:

* input — each chunk is a memmap slice copied on demand; a background
  :class:`~repro_torch.data.pipeline.Prefetcher` keeps at most ``depth``
  windows queued while one replays, so peak input residency is
  ``(prefetch_depth + 1) * chunk_size * row_bytes``, independent of
  trace length;
* carry — one ``replay_scan`` launch a chunk resumes the carry and the
  stack state the previous launch left on the device
  (:class:`~repro_torch.kernels.replay_scan.Carry`);
* output — pass ``return_latencies=False`` (with a
  :class:`~repro_torch.core.replay.metrics.MetricsSpec` for telemetry)
  for O(buckets + windows) outputs too; the default keeps per-access
  latencies, which are inherently O(trace).

Crash safety: with ``checkpoint_dir=`` and ``checkpoint_every=K``, every
K chunks the whole resumable state — the carry, the stack state, the
streaming accumulators, the stream cursor, the per-chunk output parts and
the fault / ECMP / poison feed accumulators — is written atomically (tmp
dir + per-file fsync + ``os.replace``) with per-leaf SHA-256 through
:class:`~repro_torch.checkpoint.manager.CheckpointManager`.  A killed run
restarted with ``resume=True`` walks back to the newest checkpoint that
verifies (torn or bit-flipped snapshots are skipped) and continues
tick-identical to an uninterrupted run — byte-equal latencies, flags and
MetricsBundle — fault plans included.  The snapshot's leaves are the
port's own, so it refuses (never resumes) a snapshot the JAX package
wrote.

Tick-identical to one-shot replay at any chunk size, or it refuses with
the same :class:`~repro_torch.core.replay.spec.ReplayUnsupported` error.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.replay.engine import ReplayEngine, ReplayResult
from repro_torch.core.replay.metrics import MetricsSpec

#: snapshot encoding (changed with the layout: resume refuses a snapshot
#: it cannot decode rather than guessing; the JAX package's are format 1)
SNAPSHOT_FORMAT = "repro_torch/1"


def _encode_snapshot(snap: Dict, *, n: int, size: int,
                     chunk: int) -> Tuple[Dict, Dict]:
    """Flatten a ``run_store`` snapshot into ``(flat_arrays, extra_json)``
    for :class:`CheckpointManager` (whose leaves are arrays and whose
    ``extra`` is JSON) — inverse of :func:`_decode_snapshot`."""
    flat = {f"carry/{k}": v for k, v in snap["carry"].items()}
    for t, (iss, dn, fl) in enumerate(snap["parts"]):
        flat[f"parts/{t}/iss"] = iss
        flat[f"parts/{t}/dn"] = dn
        flat[f"parts/{t}/fl"] = fl
    for t, pz in enumerate(snap["poison_parts"]):
        flat[f"poison/{t}"] = np.asarray(pz, np.uint8)
    if snap["route_counts"] is not None:
        flat["route_counts"] = snap["route_counts"]
    b = snap["builder"]
    if b is not None:
        flat["builder/pkts"] = b["pkts"]
        flat["builder/occt"] = b["occt"]
        flat["builder/counters"] = b["counters"]
        flat["builder/deg"] = np.asarray(b["deg"], np.uint8)
        flat["builder/fo"] = np.asarray(b["fo"], np.uint8)
        for key, v in b["ecmp"].items():
            flat[f"builder/ecmp/{key}"] = np.asarray(v, np.int64)
    extra = {
        "format": SNAPSHOT_FORMAT,
        "seen": int(snap["seen"]),
        "psum": int(snap["psum"]),
        "n_parts": len(snap["parts"]),
        "n_poison": len(snap["poison_parts"]),
        "has_route_counts": snap["route_counts"] is not None,
        "has_builder": b is not None,
        "ecmp_keys": sorted(b["ecmp"]) if b is not None else [],
        "n": int(n), "size": int(size), "chunk": int(chunk),
    }
    return flat, extra


def _decode_snapshot(flat: Dict, extra: Dict, *, n: int,
                     size: int) -> Dict:
    """Rebuild the ``run_store`` ``resume_state`` dict from a restored
    checkpoint, validating that it is the port's and belongs to this
    trace."""
    if extra.get("format") != SNAPSHOT_FORMAT:
        raise ValueError(f"unsupported replay snapshot format "
                         f"{extra.get('format')!r}")
    if int(extra["n"]) != n or int(extra["size"]) != size:
        raise ValueError(
            f"checkpoint belongs to a different trace: snapshot pins "
            f"n={extra['n']} size={extra['size']}, store has "
            f"n={n} size={size}")
    carry = {k[len("carry/"):]: v for k, v in flat.items()
             if k.startswith("carry/")}
    parts = [(flat[f"parts/{t}/iss"], flat[f"parts/{t}/dn"],
              flat[f"parts/{t}/fl"]) for t in range(extra["n_parts"])]
    poison = [np.asarray(flat[f"poison/{t}"], bool)
              for t in range(extra["n_poison"])]
    builder = None
    if extra["has_builder"]:
        builder = {
            "pkts": flat["builder/pkts"],
            "occt": flat["builder/occt"],
            "counters": flat["builder/counters"],
            "deg": np.asarray(flat["builder/deg"], bool),
            "fo": np.asarray(flat["builder/fo"], bool),
            "ecmp": {key: flat[f"builder/ecmp/{key}"]
                     for key in extra["ecmp_keys"]},
        }
    return {
        "seen": int(extra["seen"]),
        "psum": int(extra["psum"]),
        "parts": parts,
        "poison_parts": poison,
        "route_counts": (flat["route_counts"]
                         if extra["has_route_counts"] else None),
        "builder": builder,
        "carry": carry,
    }


def replay_stream(store, device, *, chunk_size: int,
                  prefetch_depth: int = 2, outstanding: int = 32,
                  issue_overhead_ns: float = 0.5,
                  posted_writes: bool = True, block_size: int = 1,
                  metrics: Optional[MetricsSpec] = None,
                  start_tick: int = 0, return_latencies: bool = True,
                  stats: Optional[dict] = None,
                  checkpoint_dir: Optional[str] = None,
                  checkpoint_every: int = 0,
                  checkpoint_keep: int = 3, resume: bool = False,
                  torch_device="cuda") -> ReplayResult:
    """Replay ``store`` (a TraceStore or a path to one) on ``device``, on
    ``torch_device`` (the card by default, ``"cpu"`` for the plain twin).

    ``stats``, if given a dict, is filled with the streaming memory
    model: ``chunks``, ``chunk_input_bytes`` (one window),
    ``peak_input_bound_bytes`` (the analytic ``(depth + 1) * window``
    bound: ``depth`` queued windows plus the one the producer holds
    while the queue is full) and ``peak_buffered_bytes`` (the measured
    high-water mark, always <= the bound); when checkpointing is active
    it also records ``checkpoints_written`` and ``resumed_from`` (the
    access cursor the run continued from, 0 for a fresh start).

    ``checkpoint_dir`` + ``checkpoint_every=K`` snapshot the resumable
    state every K chunks; ``resume=True`` restarts from the newest
    verifiable snapshot under ``checkpoint_dir`` (falling back past torn
    or corrupt ones, or to a fresh start when none exists) and is
    byte-identical to the uninterrupted run.
    """
    from repro_torch.data.pipeline import Prefetcher
    from repro_torch.data.trace_store import TraceStore

    if not hasattr(store, "chunks"):
        store = TraceStore(store)
    chunk = int(chunk_size)
    every = int(checkpoint_every)
    if resume and checkpoint_dir is None:
        raise ValueError("resume=True needs checkpoint_dir=")
    if every and checkpoint_dir is None:
        raise ValueError("checkpoint_every needs checkpoint_dir=")
    engine = ReplayEngine(device, outstanding=outstanding,
                          issue_overhead_ns=issue_overhead_ns,
                          posted_writes=posted_writes,
                          block_size=block_size, metrics=metrics,
                          torch_device=torch_device)
    mgr = None
    if checkpoint_dir is not None:
        from repro_torch.checkpoint.manager import CheckpointManager
        mgr = CheckpointManager(checkpoint_dir, keep=checkpoint_keep)
    resume_state = None
    if resume:
        try:
            flat, extra, _step = mgr.restore_latest_good()
        except FileNotFoundError:
            flat = None      # nothing usable: fresh start
        if flat is not None:
            resume_state = _decode_snapshot(flat, extra, n=int(store.n),
                                            size=int(store.size))
    seen0 = int(resume_state["seen"]) if resume_state is not None else 0
    written = 0
    on_chunk = None
    if mgr is not None and every > 0:
        pending = {"chunks": 0}

        def on_chunk(seen, snapshot):
            nonlocal written
            pending["chunks"] += 1
            if pending["chunks"] % every == 0 and seen < store.n:
                flat, extra = _encode_snapshot(
                    snapshot(), n=int(store.n), size=int(store.size),
                    chunk=chunk)
                mgr.save(int(seen), flat, extra=extra)
                written += 1

    pf = Prefetcher(store.chunks(chunk, start=seen0) if seen0
                    else store.chunks(chunk), depth=prefetch_depth)
    try:
        res = engine.run_store(store, chunk_size=chunk,
                               start_tick=start_tick,
                               return_latencies=return_latencies,
                               chunk_iter=pf, resume_state=resume_state,
                               on_chunk=on_chunk)
    finally:
        pf.close()
    if stats is not None:
        window = chunk * store.row_bytes
        stats["chunks"] = -(-(store.n - seen0) // chunk)
        stats["chunk_input_bytes"] = window
        stats["peak_input_bound_bytes"] = (prefetch_depth + 1) * window
        stats["peak_buffered_bytes"] = pf.peak_buffered_bytes
        if mgr is not None:
            stats["checkpoints_written"] = written
            stats["resumed_from"] = seen0
    return res
