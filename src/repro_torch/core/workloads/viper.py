"""Viper KV-store workload model (paper §III-C, Figs. 5-6).

Viper is a hybrid KV store: the offset index lives in (local) DRAM, the
value log lives on the device under test.  Each operation therefore issues:

* index probe/update accesses against local DRAM,
* value-log accesses (``ceil(kv_size/64)`` sequential 64 B lines) against
  the target device — appends go to the moving log tail, reads to the key's
  stored offset,
* hot metadata accesses (allocator/block headers) against the target device
  — a tiny set of pages touched by *every* operation.  This is the high
  temporal locality the paper calls out ("repeated metadata access" during
  update/delete), and it is what separates the replacement policies.

Five timed phases of ``ops_per_phase`` operations each: insert, write (put
to an existing key), query, update, delete — matching the paper's list.
QPS per phase = ops / simulated elapsed time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from repro_torch.core.devices import DRAMDevice, MemDevice
from repro_torch.core.engine import ns, to_s

LINE = 64
PAGE = 4096


@dataclass
class ViperConfig:
    kv_bytes: int = 216               # paper: 216 B and 532 B experiments
    ops_per_phase: int = 10_000
    keyspace: int = 28_000
    seed_keys: int = 18_000           # untimed pre-population
    compute_ns: float = 500.0         # per-op CPU work (hashing, memcpy, ...)
    metadata_pages: int = 8           # hot allocator/block headers
    value_base: int = 1 << 30         # value log base address on device
    meta_base: int = 0                # metadata region base on device
    zipf_s: float = 0.9               # key-popularity skew (YCSB-style)
    seed: int = 11

    @property
    def value_lines(self) -> int:
        return (self.kv_bytes + LINE - 1) // LINE


@dataclass
class _State:
    tail: int = 0                                  # log tail offset (bytes)
    offsets: Dict[int, int] = field(default_factory=dict)  # key -> log offset
    op_count: int = 0


class _Viper:
    def __init__(self, cfg: ViperConfig, device: MemDevice, index: DRAMDevice) -> None:
        self.cfg = cfg
        self.dev = device
        self.idx = index
        self.st = _State()
        # Zipf-weighted header choice: the allocator head page is touched far
        # more often than per-block headers (rank-skewed, like real metadata)
        rng = np.random.default_rng(cfg.seed + 1)
        w = 1.0 / np.arange(1, cfg.metadata_pages + 1) ** 1.6
        self._meta_seq = rng.choice(cfg.metadata_pages, size=1 << 16,
                                    p=w / w.sum())

    # --------------------------------------------------------------- pieces
    def _index_probe(self, t: int) -> int:
        t = self.idx.service(t, 0x1000 + (self.st.op_count * 128) % (1 << 20), LINE, False)
        return self.idx.service(t, 0x2000 + (self.st.op_count * 64) % (1 << 20), LINE, False)

    def _index_update(self, t: int) -> int:
        return self.idx.service(t, 0x3000 + (self.st.op_count * 64) % (1 << 20), LINE, True)

    def _metadata(self, t: int, write: bool) -> int:
        page = int(self._meta_seq[self.st.op_count & 0xFFFF])
        addr = self.cfg.meta_base + page * PAGE + (self.st.op_count % 8) * LINE
        t = self.dev.service(t, addr, LINE, False)
        if write:
            t = self.dev.service(t, addr, LINE, True)
        return t

    def _value_lines(self, t0: int, offset: int, write: bool) -> int:
        """Value lines issue back-to-back (multiple LFBs): latencies overlap,
        occupancy/queueing serializes inside the device model."""
        done = t0
        for i in range(self.cfg.value_lines):
            addr = self.cfg.value_base + offset + i * LINE
            done = max(done, self.dev.service(t0 + ns(i), addr, LINE, write))
        return done

    def _append(self, t: int, key: int) -> int:
        off = self.st.tail
        self.st.tail += self.cfg.value_lines * LINE
        done = self._value_lines(t, off, write=True)
        self.st.offsets[key] = off
        return done

    # ------------------------------------------------------------------ ops
    def insert(self, t: int, key: int) -> int:
        self.st.op_count += 1
        t = self._index_probe(t)
        t = self._append(t, key)
        t = self._index_update(t)
        t = self._metadata(t, write=True)
        return t + ns(self.cfg.compute_ns)

    put = insert  # Viper put-to-existing-key is also an append + remap

    def query(self, t: int, key: int) -> int:
        self.st.op_count += 1
        t = self._index_probe(t)
        off = self.st.offsets.get(key, 0)
        t = self._value_lines(t, off, write=False)
        t = self._metadata(t, write=False)
        return t + ns(self.cfg.compute_ns)

    def update(self, t: int, key: int) -> int:
        self.st.op_count += 1
        t = self._index_probe(t)
        off = self.st.offsets.get(key, 0)
        t = self._value_lines(t, off, write=False)   # read old version
        t = self._append(t, key)                     # append new version
        t = self._index_update(t)
        t = self._metadata(t, write=True)
        return t + ns(self.cfg.compute_ns)

    def delete(self, t: int, key: int) -> int:
        self.st.op_count += 1
        t = self._index_probe(t)
        off = self.st.offsets.pop(key, 0)
        t = self.dev.service(t, self.cfg.value_base + off, LINE, True)  # tombstone
        t = self._index_update(t)
        t = self._metadata(t, write=True)
        return t + ns(self.cfg.compute_ns)


def run_viper(device: MemDevice, cfg: ViperConfig | None = None) -> Dict[str, float]:
    """Run the five phases; returns {phase: QPS} plus 'avg'."""
    cfg = cfg or ViperConfig()
    rng = np.random.default_rng(cfg.seed)
    idx = DRAMDevice()
    kv = _Viper(cfg, device, idx)

    t = 0
    # untimed pre-population (builds the log + warms nothing: the device
    # under test still sees the writes, matching a freshly-loaded store)
    for key in range(cfg.seed_keys):
        t = kv.insert(t, key)

    phases: Dict[str, float] = {}
    new_keys = list(range(cfg.seed_keys, cfg.keyspace))
    rng.shuffle(new_keys)
    n = cfg.ops_per_phase

    def timed(name: str, keys, fn) -> None:
        nonlocal t
        t0 = t
        for k in keys:
            t = fn(t, int(k))
        phases[name] = n / max(to_s(t - t0), 1e-12)

    # YCSB-style Zipfian key popularity (hot keys dominate), shuffled over
    # the keyspace so popularity is uncorrelated with insertion order.
    ranks = np.arange(1, cfg.keyspace + 1, dtype=np.float64)
    pk = ranks ** -cfg.zipf_s
    pk /= pk.sum()
    keymap = rng.permutation(cfg.keyspace)

    def live():
        return keymap[rng.choice(cfg.keyspace, size=n, p=pk)]

    timed("insert", (new_keys * (n // len(new_keys) + 1))[:n], kv.insert)
    timed("write", live(), kv.put)
    timed("query", live(), kv.query)
    timed("update", live(), kv.update)
    # delete unique keys (re-inserting is not modeled; sample w/o replacement)
    timed("delete", keymap[rng.choice(cfg.keyspace, size=n, replace=False)], kv.delete)

    phases["avg"] = float(np.mean([phases[p] for p in
                                   ("insert", "write", "query", "update", "delete")]))
    return phases
