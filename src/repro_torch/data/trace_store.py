"""Columnar on-disk trace format for streaming replay.

A ``TraceStore`` is a directory with one ``.npy`` file per access field
plus a small JSON header::

    trace.store/
        header.json     {"format": 1, "n": ..., "size": 64,
                         "max_addr": ..., "columns": {"addr": "int64",
                         "op": "uint8", ...}}
        addr.npy        int64   byte address per access
        op.npy          uint8   1 = write, 0 = read
        tick.npy        int64   optional issue-tick hints
        host.npy        int32   optional originating host index
        route.npy       int32   optional pinned ECMP route choice

Columns are standard ``np.save`` files, so readers open them with
``np.load(mmap_mode="r")`` and never materialize the full trace: slicing
a memmap copies only the requested rows.  ``addr`` and ``op`` are
required; the rest are optional annotations that replay front ends may
consume or ignore.

The header pins the replay-relevant scalars — uniform access ``size``
(validated to stay inside one 64 B line, mirroring
``spec.trace_to_arrays``) and ``max_addr`` — so ``ReplayEngine`` can
size its stack without scanning the address column first.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

HEADER = "header.json"
FORMAT = 1
LINE_BYTES = 64


class TraceStoreCorrupt(ValueError):
    """A column file failed integrity validation — truncated, bit-flipped
    (checksum mismatch), or otherwise unreadable.  Typed so streaming
    consumers (:class:`~repro_torch.data.pipeline.Prefetcher` forwards
    producer exceptions) can distinguish data corruption from
    configuration errors."""

#: column name -> required dtype (anything else in the header is rejected)
_COLUMN_DTYPES = {
    "addr": "int64",
    "op": "uint8",
    "tick": "int64",
    "host": "int32",
    "route": "int32",
}
_REQUIRED = ("addr", "op")


class TraceStore:
    """Read-side handle on a columnar trace directory.

    Columns are opened lazily as read-only memmaps and cached; ``slice``
    and ``chunks`` hand out *copies* of the requested window, so the
    caller's working set is O(chunk) regardless of trace length.
    """

    def __init__(self, path) -> None:
        self.path = Path(path)
        hdr_path = self.path / HEADER
        if not hdr_path.is_file():
            raise FileNotFoundError(f"not a TraceStore (no {HEADER}): "
                                    f"{self.path}")
        with open(hdr_path) as fh:
            hdr = json.load(fh)
        if hdr.get("format") != FORMAT:
            raise ValueError(f"unsupported TraceStore format "
                             f"{hdr.get('format')!r} (expected {FORMAT})")
        self._n = int(hdr["n"])
        self._size = int(hdr["size"])
        self._max_addr = int(hdr["max_addr"])
        self._columns: Dict[str, str] = dict(hdr["columns"])
        # optional (absent in stores written before integrity landed):
        # sha256 over each column's full .npy file bytes
        self._checksums: Dict[str, str] = dict(hdr.get("checksums", {}))
        for name in _REQUIRED:
            if name not in self._columns:
                raise ValueError(f"TraceStore missing required column "
                                 f"{name!r}")
        for name, dtype in self._columns.items():
            want = _COLUMN_DTYPES.get(name)
            if want is None:
                raise ValueError(f"unknown TraceStore column {name!r}")
            if dtype != want:
                raise ValueError(f"column {name!r} has dtype {dtype}, "
                                 f"expected {want}")
            if not (self.path / f"{name}.npy").is_file():
                raise FileNotFoundError(f"missing column file {name}.npy "
                                        f"in {self.path}")
        self._mm: Dict[str, np.ndarray] = {}

    # ------------------------------------------------------------ metadata
    @property
    def n(self) -> int:
        """Number of accesses."""
        return self._n

    @property
    def size(self) -> int:
        """Uniform per-access size in bytes."""
        return self._size

    @property
    def max_addr(self) -> int:
        """Largest byte address in the trace (pinned in the header)."""
        return self._max_addr

    @property
    def row_bytes(self) -> int:
        """Bytes per access across the columns ``chunks`` yields."""
        return (np.dtype(np.int64).itemsize
                + np.dtype(np.uint8).itemsize)

    @property
    def column_names(self) -> Tuple[str, ...]:
        return tuple(sorted(self._columns))

    def __len__(self) -> int:
        return self._n

    # ------------------------------------------------------------- reading
    def column(self, name: str) -> np.ndarray:
        """The full column as a read-only memmap (no copy)."""
        if name not in self._columns:
            raise KeyError(f"TraceStore has no column {name!r}")
        mm = self._mm.get(name)
        if mm is None:
            mm = np.load(self.path / f"{name}.npy", mmap_mode="r")
            self._mm[name] = mm
        return mm

    def writes(self) -> np.ndarray:
        """The full op column as a fresh bool array (one pass, O(n))."""
        return np.asarray(self.column("op")) != 0

    def slice(self, lo: int, hi: int) -> Dict[str, np.ndarray]:
        """Copy rows ``[lo, hi)`` of the replay columns into host arrays."""
        if not 0 <= lo <= hi <= self._n:
            raise IndexError(f"slice [{lo}, {hi}) out of range for "
                             f"n={self._n}")
        return {
            "addr": np.array(self.column("addr")[lo:hi], np.int64),
            "wr": np.array(self.column("op")[lo:hi], np.uint8) != 0,
        }

    def chunks(self, chunk_size: int,
               start: int = 0) -> Iterator[Tuple[int, int, Dict]]:
        """Yield ``(lo, hi, columns)`` windows of at most ``chunk_size``
        rows, in order, beginning at row ``start`` (a chunk-aligned resume
        cursor: a checkpointed run re-enters the stream exactly where the
        snapshot left off).  Each window is an independent copy, safe to
        hand to a prefetch thread."""
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        if not 0 <= start <= self._n:
            raise IndexError(f"start {start} out of range for n={self._n}")
        for lo in range(int(start), self._n, chunk_size):
            hi = min(lo + chunk_size, self._n)
            yield lo, hi, self.slice(lo, hi)

    # ----------------------------------------------------------- integrity
    def validate(self) -> None:
        """Verify every column file against the header: readable as an
        ``.npy``, row count matching ``n``, and (when the header carries
        per-column checksums) byte-exact SHA-256.  Raises
        :class:`TraceStoreCorrupt` naming the first bad column — truncated
        files fail the load/length checks even on stores written before
        checksums landed."""
        for name in sorted(self._columns):
            fpath = self.path / f"{name}.npy"
            try:
                raw = fpath.read_bytes()
            except OSError as exc:
                raise TraceStoreCorrupt(
                    f"column {name!r} unreadable: {exc}") from exc
            digest = self._checksums.get(name)
            if digest is not None:
                got = hashlib.sha256(raw).hexdigest()
                if got != digest:
                    raise TraceStoreCorrupt(
                        f"column {name!r} checksum mismatch "
                        f"(bit-flip or partial write): header pins "
                        f"{digest[:12]}…, file hashes {got[:12]}…")
            try:
                import io
                arr = np.load(io.BytesIO(raw))
            except Exception as exc:
                raise TraceStoreCorrupt(
                    f"column {name!r} is not a readable .npy "
                    f"(truncated?): {exc}") from exc
            if arr.shape != (self._n,):
                raise TraceStoreCorrupt(
                    f"column {name!r} has {arr.shape[0] if arr.ndim else 0} "
                    f"rows, header pins n={self._n} (truncated or "
                    f"mismatched header)")

    # ------------------------------------------------------------- writing
    @classmethod
    def write(cls, path, addrs, writes, *, size: int = 64,
              ticks=None, hosts=None, routes=None) -> "TraceStore":
        """Create a store from in-memory arrays.

        Validation mirrors ``spec.trace_to_arrays``: uniform ``size``
        inside one 64 B line, non-negative addresses — so anything a
        store holds is replayable without re-validation surprises."""
        addrs = np.ascontiguousarray(np.asarray(addrs, np.int64))
        wr = np.ascontiguousarray(
            np.asarray(writes, bool).astype(np.uint8))
        if addrs.ndim != 1 or wr.shape != addrs.shape:
            raise ValueError("addrs and writes must be 1-D and equal "
                             "length")
        if addrs.size == 0:
            raise ValueError("refusing to write an empty TraceStore")
        if size < 1 or int(((addrs % LINE_BYTES) + size).max()) > LINE_BYTES:
            raise ValueError("accesses must stay inside one 64 B line")
        if int(addrs.min()) < 0:
            raise ValueError("negative addresses")

        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        cols: Dict[str, np.ndarray] = {"addr": addrs, "op": wr}
        for name, val in (("tick", ticks), ("host", hosts),
                          ("route", routes)):
            if val is None:
                continue
            arr = np.ascontiguousarray(
                np.asarray(val).astype(_COLUMN_DTYPES[name]))
            if arr.shape != addrs.shape:
                raise ValueError(f"column {name!r} length mismatch")
            cols[name] = arr
        checksums = {}
        for name, arr in cols.items():
            np.save(path / f"{name}.npy", arr)
            checksums[name] = hashlib.sha256(
                (path / f"{name}.npy").read_bytes()).hexdigest()
        header = {
            "format": FORMAT,
            "n": int(addrs.size),
            "size": int(size),
            "max_addr": int(addrs.max()),
            "columns": {name: str(arr.dtype)
                        for name, arr in sorted(cols.items())},
            "checksums": dict(sorted(checksums.items())),
        }
        with open(path / HEADER, "w") as fh:
            json.dump(header, fh, indent=1, sort_keys=True)
            fh.write("\n")
        return cls(path)

    @classmethod
    def from_trace(cls, path, trace, *,
                   hosts=None, routes=None) -> "TraceStore":
        """Create a store from a driver-style ``[(addr, size, write)]``
        trace, reusing the replay layer's validation."""
        from repro_torch.core.replay.spec import trace_to_arrays

        addrs, writes, size = trace_to_arrays(trace)
        return cls.write(path, addrs, writes, size=size,
                         hosts=hosts, routes=routes)
