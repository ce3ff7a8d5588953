"""Deterministic fault injection: a seeded :class:`FaultPlan` shared by the
interpreted and fused replay paths.

Every fault decision is a pure function of ``(seed, config, stable key)`` —
no wall-clock, no RNG state — so the interpreted drivers and the fused
replay lanes inject *identical* faults and stay tick-exact.  The keys
are chosen to be computable on both sides:

* **link flit CRC retries** — keyed on ``(port, per-host access ordinal)``:
  the interpreted :class:`~repro_torch.core.fabric.fabric.FabricAttachedDevice`
  counts its own accesses, the fused lane uses the trace index, so the
  per-access retry columns precompute exactly.
* **port/link down windows** — declared directly as ordinal intervals
  ``(u, v, first_ordinal, last_ordinal_exclusive)`` per undirected link, so
  both sides see the same degraded route set for the same access.
* **NAND read retries / erase failures** — keyed on a per-flash *operation
  sequence number* (reads and erases counted separately), which advances in
  the same order in the python FTL/PAL and in the in-scan flash state.
* **poison** — keyed on ``(host index, per-host access ordinal)``; reads
  only, surfaced as per-access status, never as fabricated latency.

The decision hash is splitmix64 over the mixed key.  Three twins —
scalar python int, vectorized numpy ``uint64``, and torch tensors holding
the uint64 bits in int64 (for in-scan NAND decisions) — are
property-tested bit-equal.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import FrozenSet, List, Tuple

import numpy as np

_M64 = (1 << 64) - 1
_M32 = (1 << 32) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_MULT1 = 0xBF58476D1CE4E5B9
_MULT2 = 0x94D049BB133111EB
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3

# per-class salts keep the four fault streams independent under one seed
SALT_LINK = 0xA1A1
SALT_DOWN = 0xB2B2          # reserved (windows are explicit, not hashed)
SALT_NAND_READ = 0xC3C3
SALT_NAND_ERASE = 0xD4D4
SALT_POISON = 0xE5E5


class DeviceUnreachable(ValueError):
    """Raised when routing finds zero surviving paths to a device — every
    equal-cost path (and every recomputed fallback route) crosses a down
    port.  Subclasses ``ValueError`` so pre-fault unreachability handling
    keeps working."""


def str_salt(s: str) -> int:
    """FNV-1a over a node/port name — the stable string-keyed salt."""
    h = _FNV_OFFSET
    for b in s.encode():
        h = ((h ^ b) * _FNV_PRIME) & _M64
    return h


def _mix(x: int) -> int:
    """splitmix64 finalizer (scalar python int)."""
    x = (x + _GOLDEN) & _M64
    x = ((x ^ (x >> 30)) * _MULT1) & _M64
    x = ((x ^ (x >> 27)) * _MULT2) & _M64
    return x ^ (x >> 31)


def _mix_np(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (numpy uint64, wraps mod 2^64 like the scalar)."""
    x = x.astype(np.uint64) + np.uint64(_GOLDEN)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(_MULT1)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(_MULT2)
    return x ^ (x >> np.uint64(31))


def fault_hash(seed: int, salt: int, a: int, b: int) -> int:
    """64-bit decision hash over ``(seed, class salt, key a, key b)``."""
    h = _mix((seed + salt) & _M64)
    h = _mix(h ^ (a & _M64))
    return _mix(h ^ (b & _M64))


def fault_hash_np(seed: int, salt: int, a: int, b: np.ndarray) -> np.ndarray:
    """Vectorized :func:`fault_hash` over an array of ``b`` keys."""
    h0 = _mix((seed + salt) & _M64)
    h1 = _mix(h0 ^ (a & _M64))
    return _mix_np(np.uint64(h1) ^ np.asarray(b).astype(np.uint64))


def _rate_threshold(rate: float) -> int:
    """``rate`` in [0, 1] as a 32-bit comparison threshold."""
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"fault rate must be in [0, 1], got {rate}")
    return min(1 << 32, int(rate * (1 << 32)))


def _count_from(h: int, thresh: int, kmax: int) -> int:
    """Low 32 bits gate the event, high bits pick the burst size 1..kmax."""
    if (h & _M32) < thresh:
        return 1 + (h >> 32) % kmax
    return 0


@dataclass(frozen=True)
class FaultConfig:
    """Static fault schedule parameters.  All-zero rates and no down
    windows mean an inert plan (``FaultPlan.active`` is False)."""

    # class 1: link flit CRC-retry bursts — probability per (port, access)
    # that the flit needs 1..link_retry_max extra full serializations
    link_retry_rate: float = 0.0
    link_retry_max: int = 3
    # class 2: down windows, one per undirected link:
    # (u, v, first_ordinal, last_ordinal_exclusive) over per-host access
    # ordinals — both port directions (u, v) and (v, u) are down
    down_links: Tuple[Tuple[str, str, int, int], ...] = ()
    # class 3: NAND read retries (per physical page read) and grown bad
    # blocks (per erase — a failed erase retires the block from the pool)
    nand_read_retry_rate: float = 0.0
    nand_read_retry_max: int = 2
    erase_fail_rate: float = 0.0
    # class 4: poison — probability per (host, read access) that the
    # returned line carries the CXL poison flag
    poison_rate: float = 0.0


class FaultPlan:
    """Seeded, fully deterministic fault schedule (see module docstring)."""

    def __init__(self, config: FaultConfig, seed: int = 0) -> None:
        self.config = config
        self.seed = int(seed) & _M64
        self._link_thresh = _rate_threshold(config.link_retry_rate)
        self._nand_thresh = _rate_threshold(config.nand_read_retry_rate)
        self._erase_thresh = _rate_threshold(config.erase_fail_rate)
        self._poison_thresh = _rate_threshold(config.poison_rate)
        for name, kmax in (("link_retry_max", config.link_retry_max),
                           ("nand_read_retry_max",
                            config.nand_read_retry_max)):
            if kmax < 1:
                raise ValueError(f"{name} must be >= 1, got {kmax}")
        for u, v, a0, a1 in config.down_links:
            if a0 < 0 or a1 < a0:
                raise ValueError(
                    f"down window for {u}->{v} must satisfy 0 <= first <= "
                    f"last, got [{a0}, {a1})")

    # ------------------------------------------------------------ activity
    @property
    def has_link(self) -> bool:
        return self._link_thresh > 0

    @property
    def has_down(self) -> bool:
        return bool(self.config.down_links)

    @property
    def has_nand(self) -> bool:
        return self._nand_thresh > 0 or self._erase_thresh > 0

    @property
    def has_poison(self) -> bool:
        return self._poison_thresh > 0

    @property
    def active(self) -> bool:
        return (self.has_link or self.has_down or self.has_nand
                or self.has_poison)

    @property
    def has_transport_faults(self) -> bool:
        """Fault classes that ride the fabric transport (link retries,
        down windows) or the per-access status path (poison)."""
        return self.has_link or self.has_down or self.has_poison

    def class_names(self) -> Tuple[str, ...]:
        """The active fault classes, by human name, in schedule order —
        refusal messages use this to say exactly *which* class a lane
        cannot mirror (empty for an inert plan)."""
        out = []
        if self.has_link:
            out.append("link-retry")
        if self.has_down:
            out.append("port-down")
        if self.has_nand:
            out.append("NAND")
        if self.has_poison:
            out.append("poison")
        return tuple(out)

    # ------------------------------------------- class 1: link CRC retries
    def link_retries(self, port: Tuple[str, str], ordinal: int) -> int:
        """Extra full serializations (0 = clean) for one flit on one
        directed port, keyed on the issuing host's access ordinal."""
        if not self.has_link:
            return 0
        h = fault_hash(self.seed, SALT_LINK, str_salt(f"{port[0]}->{port[1]}"),
                       ordinal)
        return _count_from(h, self._link_thresh, self.config.link_retry_max)

    def link_retries_np(self, port: Tuple[str, str],
                        ordinals: np.ndarray) -> np.ndarray:
        """Vector twin of :meth:`link_retries` (int64)."""
        n = np.asarray(ordinals).shape[0]
        if not self.has_link:
            return np.zeros(n, np.int64)
        h = fault_hash_np(self.seed, SALT_LINK,
                          str_salt(f"{port[0]}->{port[1]}"), ordinals)
        hit = (h & np.uint64(_M32)) < np.uint64(self._link_thresh)
        k = np.uint64(1) + (h >> np.uint64(32)) \
            % np.uint64(self.config.link_retry_max)
        return np.where(hit, k, np.uint64(0)).astype(np.int64)

    # ------------------------------------------- class 2: down windows
    def down_links_at(self, ordinal: int) -> FrozenSet[Tuple[str, str]]:
        """The set of *directed* port keys down for this access ordinal
        (both orientations of every down undirected link)."""
        out = set()
        for u, v, a0, a1 in self.config.down_links:
            if a0 <= ordinal < a1:
                out.add((u, v))
                out.add((v, u))
        return frozenset(out)

    def down_segments(self, n: int) -> List[Tuple[int, int,
                                                  FrozenSet[Tuple[str, str]]]]:
        """Partition ordinals ``[0, n)`` into maximal runs of constant
        down-set: ``[(lo, hi_exclusive, down_set), ...]`` — the fused lane
        builds one route table entry per distinct segment."""
        cuts = {0, n}
        for _, _, a0, a1 in self.config.down_links:
            cuts.add(min(max(a0, 0), n))
            cuts.add(min(max(a1, 0), n))
        edges = sorted(cuts)
        return [(lo, hi, self.down_links_at(lo))
                for lo, hi in zip(edges, edges[1:]) if hi > lo]

    # ------------------------------------------- class 3: NAND faults
    def nand_read_retries(self, seq: int) -> int:
        """Extra sense+transfer rounds (0 = clean) for the ``seq``-th
        physical page read on a flash instance."""
        if self._nand_thresh == 0:
            return 0
        h = fault_hash(self.seed, SALT_NAND_READ, 0, seq)
        return _count_from(h, self._nand_thresh,
                           self.config.nand_read_retry_max)

    def erase_fails(self, seq: int) -> bool:
        """Whether the ``seq``-th block erase on a flash instance fails
        (the block grows bad and is retired from the free pool)."""
        if self._erase_thresh == 0:
            return False
        h = fault_hash(self.seed, SALT_NAND_ERASE, 0, seq)
        return (h & _M32) < self._erase_thresh

    def nand_statics(self) -> Tuple[int, ...]:
        """Hashable static tuple for the fused stack config:
        ``(seed, read_thresh, read_max, erase_thresh)``; empty when the
        plan schedules no NAND faults."""
        if not self.has_nand:
            return ()
        return (self.seed, self._nand_thresh,
                self.config.nand_read_retry_max, self._erase_thresh)

    # ------------------------------------------- class 4: poison
    def poisoned(self, host_idx: int, ordinal: int, write: bool) -> bool:
        """Whether this (read) access returns a poisoned line."""
        if write or not self.has_poison:
            return False
        h = fault_hash(self.seed, SALT_POISON, host_idx, ordinal)
        return (h & _M32) < self._poison_thresh

    def poisoned_np(self, host_idx: int, ordinals: np.ndarray,
                    writes: np.ndarray) -> np.ndarray:
        """Vector twin of :meth:`poisoned` (bool)."""
        n = np.asarray(ordinals).shape[0]
        if not self.has_poison:
            return np.zeros(n, bool)
        h = fault_hash_np(self.seed, SALT_POISON, host_idx, ordinals)
        return ((h & np.uint64(_M32)) < np.uint64(self._poison_thresh)) \
            & ~np.asarray(writes, bool)


# ------------------------------------------------------------ torch twins
# For the fused scan lane, where the NAND sequence counters are
# data-dependent (GC migration reads advance them) and live on the card.
# uint64 bits are held in int64 tensors (see repro_torch.core.u64); torch
# is imported on first use, so the python lane never loads it.
def nand_read_retries_torch(statics: Tuple[int, ...], seq):
    """Tensor twin of :meth:`FaultPlan.nand_read_retries` over the
    read-sequence counters ``seq`` (an int64 tensor, on its own device;
    int64 -> int64)."""
    import torch

    from repro_torch.core import u64

    seed, read_thresh, read_max, _ = statics
    h = _mix_torch_scalar(seed, SALT_NAND_READ, seq)
    hit = (h & _M32) < read_thresh
    k = 1 + u64.shr(h, 32) % read_max
    return torch.where(hit, k, torch.zeros_like(k))


def erase_fails_torch(statics: Tuple[int, ...], seq):
    """Tensor twin of :meth:`FaultPlan.erase_fails` (int64 -> bool)."""
    seed, _, _, erase_thresh = statics
    h = _mix_torch_scalar(seed, SALT_NAND_ERASE, seq)
    return (h & _M32) < erase_thresh


def folded_key(seed: int, salt: int, a: int = 0) -> int:
    """The seed-side half of ``fault_hash(seed, salt, a, b)``: the uint64
    that ``b`` is xored with before the last mix."""
    return _mix(_mix((seed + salt) & _M64) ^ (a & _M64))


def _mix_torch_scalar(seed: int, salt: int, b, a: int = 0):
    """``fault_hash(seed, salt, a, b)`` with the two seed-side mixes folded
    on the host (python ints) and only the key-side mix on tensors."""
    from repro_torch.core import u64

    x = u64.as_bits(b) ^ u64.const(folded_key(seed, salt, a))
    x = x + u64.const(_GOLDEN)
    x = (x ^ u64.shr(x, 30)) * u64.const(_MULT1)
    x = (x ^ u64.shr(x, 27)) * u64.const(_MULT2)
    return x ^ u64.shr(x, 31)


# ------------------------------------------------------------ installation
def install(plan: FaultPlan, targets) -> FaultPlan:
    """Wire ``plan`` onto replay targets (fabric mounts or direct devices).

    Sets ``fault_plan`` on every target, on the shared fabric of mounted
    targets (link/down faults ride the transport), and on the FTL/PAL of
    any flash stack reachable through the target (NAND faults).  Pool
    views are not supported — fault ordinals are per-host, which pool
    address interleaving would scramble."""
    for t in targets:
        fabric = getattr(t, "fabric", None)
        if fabric is None and hasattr(t, "pool"):
            raise TypeError(
                "fault injection supports fabric mounts and direct "
                "devices, not pool views")
        t.fault_plan = plan
        inner = getattr(t, "inner", t)
        if fabric is not None:
            fabric.fault_plan = plan
        hil = getattr(inner, "hil", None)
        if hil is not None:
            hil.ftl.fault_plan = plan
            hil.ftl.pal.fault_plan = plan
    return plan
