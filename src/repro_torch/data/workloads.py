"""Seeded synthetic workload generators: fleet-scale traces that never
materialize in python.

Every generator is a **pure function of ``(spec, seed, host, i)``** — no RNG
state, no wall clock — in the idiom of :mod:`repro_torch.core.faults.plan`:
a splitmix64 decision hash with three bit-equal twins (scalar python int,
vectorized numpy ``uint64``, and torch tensors holding the uint64 bits in
int64), property-tested against each other and against the JAX package's
generators.  The torch twin (:func:`host_trace_torch`) builds each host's
columns on the card, so a fleet replay's trace costs no host-to-device
transfer and no python per-access object; the numpy twin feeds
:meth:`repro_torch.data.trace_store.TraceStore.write` and the replays'
``run_arrays``; the scalar twin is the oracle both are held against.

Four access patterns (CXL-fabric congestion-study staples):

``zipfian``   page rank drawn from a Zipf(s) distribution over the
              footprint via a precomputed float64 CDF + ``searchsorted``
              (page 0 is the hottest) — multi-tenant skew.
``hotspot``   a ``hot_frac`` coin sends the access into the first
              ``hot_pages`` pages, else uniformly into the cold remainder —
              tenant-with-a-hot-set.
``bursty``    on/off modulation over the access index: ON windows hammer
              the hot set, OFF windows stride through the cold footprint —
              bursty tenants that synchronize across hosts when given the
              same phase.
``scan``      periodic sequential sweep ``(i * stride) % footprint`` —
              backup/compaction traffic.

Writes are an independent hash coin against ``write_frac`` and the
sub-page line offset is a third hash stream, so two kinds sharing a seed
still draw independent decisions (per-stream salts, like the fault
classes).  Every twin runs its integer arithmetic mod 2^64.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.faults.plan import (_M32, _rate_threshold, fault_hash,
                                          fault_hash_np)

# per-stream salts: page choice, hotspot gate, line offset and write coin
# draw from independent hash streams under one seed (like the fault classes)
SALT_PAGE = 0x9A6E
SALT_GATE = 0x6A7E
SALT_OFF = 0x0FF5
SALT_WRITE = 0x3717

WORKLOAD_KINDS = ("zipfian", "hotspot", "bursty", "scan")


@dataclass(frozen=True)
class WorkloadSpec:
    """Static shape of one synthetic workload (hashable)."""

    kind: str
    num_pages: int                  # footprint, in pages
    page_bytes: int = 4096
    line_offsets: int = 64          # sub-page 64 B line slots drawn per access
    write_frac: float = 0.3
    # zipfian
    zipf_s: float = 1.0             # skew exponent (1.0 = classic Zipf)
    # hotspot / bursty hot set
    hot_frac: float = 0.9           # hotspot: P(access lands in the hot set)
    hot_pages: int = 0              # hot-set size (0 -> num_pages // 16)
    # bursty on/off modulation (over the access index)
    on_len: int = 64
    off_len: int = 192
    cold_stride: int = 17           # OFF-window stride through the footprint
    # scan
    stride_pages: int = 1

    def __post_init__(self):
        if self.kind not in WORKLOAD_KINDS:
            raise ValueError(f"unknown workload kind {self.kind!r}; "
                             f"choose from {WORKLOAD_KINDS}")
        if self.num_pages < 2:
            raise ValueError("workload needs a footprint of >= 2 pages")
        if not 1 <= self.line_offsets * 64 <= self.page_bytes:
            raise ValueError("line_offsets must fit inside one page")
        hp = self.hot_set_pages
        if self.kind in ("hotspot", "bursty") and not 1 <= hp < self.num_pages:
            raise ValueError(
                f"hot_pages must be in [1, num_pages) (got {hp} of "
                f"{self.num_pages})")
        if self.kind == "bursty" and (self.on_len < 1 or self.off_len < 0):
            raise ValueError("bursty needs on_len >= 1 and off_len >= 0")
        if self.kind == "scan" and self.stride_pages < 1:
            raise ValueError("scan needs stride_pages >= 1")

    @property
    def hot_set_pages(self) -> int:
        return self.hot_pages if self.hot_pages else max(
            1, self.num_pages // 16)


def zipf_cdf(num_pages: int, s: float) -> np.ndarray:
    """Float64 rank CDF of Zipf(s) over ``num_pages`` ranks — the shared
    lookup table every twin searches (identical bits, so ``searchsorted``
    cannot disagree across the twins)."""
    w = 1.0 / np.power(np.arange(1, num_pages + 1, dtype=np.float64), s)
    cdf = np.cumsum(w)
    return cdf / cdf[-1]


def _u01(h):
    """Top 53 hash bits as a float64 in [0, 1) — exact in every twin (the
    uint64 -> float64 conversion of a value < 2^53 is lossless and the
    2^-53 scale is a power of two)."""
    return (h >> 11) * (2.0 ** -53)


# ------------------------------------------------------------ scalar twin
def access_at(spec: WorkloadSpec, seed: int, host: int, i: int):
    """The scalar oracle: ``(addr, write)`` of access ``i`` of ``host``."""
    page = _page_scalar(spec, seed, host, i)
    off = fault_hash(seed, SALT_OFF, host, i) % spec.line_offsets
    wr = (fault_hash(seed, SALT_WRITE, host, i) & _M32) \
        < _rate_threshold(spec.write_frac)
    return page * spec.page_bytes + off * 64, bool(wr)


def _page_scalar(spec: WorkloadSpec, seed: int, host: int, i: int) -> int:
    h = fault_hash(seed, SALT_PAGE, host, i)
    if spec.kind == "zipfian":
        cdf = zipf_cdf(spec.num_pages, spec.zipf_s)
        return min(int(np.searchsorted(cdf, _u01(h), side="right")),
                   spec.num_pages - 1)
    if spec.kind == "hotspot":
        hot = (fault_hash(seed, SALT_GATE, host, i) & _M32) \
            < _rate_threshold(spec.hot_frac)
        hp = spec.hot_set_pages
        return h % hp if hot else hp + h % (spec.num_pages - hp)
    if spec.kind == "bursty":
        on = i % (spec.on_len + spec.off_len) < spec.on_len
        return (h % spec.hot_set_pages if on
                else (i * spec.cold_stride) % spec.num_pages)
    return (i * spec.stride_pages) % spec.num_pages          # scan


# ------------------------------------------------------------- numpy twin
def host_trace_np(spec: WorkloadSpec, seed: int, host: int, n: int):
    """``(addrs int64 (n,), writes bool (n,))`` for one host — vectorized
    numpy, bit-equal to :func:`access_at` per element."""
    idx = np.arange(n, dtype=np.int64)
    h = fault_hash_np(seed, SALT_PAGE, host, idx)
    if spec.kind == "zipfian":
        cdf = zipf_cdf(spec.num_pages, spec.zipf_s)
        page = np.minimum(
            np.searchsorted(cdf, _u01(h), side="right"),
            spec.num_pages - 1).astype(np.int64)
    elif spec.kind == "hotspot":
        hot = (fault_hash_np(seed, SALT_GATE, host, idx)
               & np.uint64(_M32)) < np.uint64(_rate_threshold(spec.hot_frac))
        hp = spec.hot_set_pages
        page = np.where(hot, h % np.uint64(hp),
                        np.uint64(hp) + h % np.uint64(spec.num_pages - hp)
                        ).astype(np.int64)
    elif spec.kind == "bursty":
        on = idx % (spec.on_len + spec.off_len) < spec.on_len
        page = np.where(on, (h % np.uint64(spec.hot_set_pages)).astype(
            np.int64), (idx * spec.cold_stride) % spec.num_pages)
    else:                                                    # scan
        page = (idx * spec.stride_pages) % spec.num_pages
    off = (fault_hash_np(seed, SALT_OFF, host, idx)
           % np.uint64(spec.line_offsets)).astype(np.int64)
    wr = (fault_hash_np(seed, SALT_WRITE, host, idx) & np.uint64(_M32)) \
        < np.uint64(_rate_threshold(spec.write_frac))
    return page * spec.page_bytes + off * 64, wr


def traces_np(spec: WorkloadSpec, seed: int, num_hosts: int, n: int):
    """Stacked per-host columns ``(addrs (H, n), writes (H, n))`` — the
    exact input shape of :meth:`MultiHostReplay.run_arrays`."""
    cols = [host_trace_np(spec, seed, h, n) for h in range(num_hosts)]
    return (np.stack([a for a, _ in cols]), np.stack([w for _, w in cols]))


def make_traces(spec: WorkloadSpec, seed: int, num_hosts: int, n: int,
                size: int = 64):
    """Python tuple-list traces for the *interpreted* drivers (golden pins,
    small-scale parity checks) — same accesses as the array twins."""
    addrs, writes = traces_np(spec, seed, num_hosts, n)
    return [[(int(a), size, bool(w)) for a, w in zip(addrs[h], writes[h])]
            for h in range(num_hosts)]


# ------------------------------------------------------------- torch twin
def host_trace_torch(spec: WorkloadSpec, seed: int, host: int, n: int,
                     torch_device="cuda"):
    """Tensor twin of :func:`host_trace_np`: one host's ``(addrs int64
    (n,), writes bool (n,))`` built on ``torch_device`` (the card by
    default), bit-equal to the numpy twin.  The uint64 hash bits ride in
    int64 (:mod:`repro_torch.core.u64`): a logical shift for the top 53
    bits and a remainder over the 32-bit halves for the hot-set and
    cold-range draws; the zipfian CDF is numpy's float64 table, searched
    on the tensors' device with numpy's ``side="right"`` rank."""
    import torch

    from repro_torch import torch_device as _td
    from repro_torch.core import u64
    from repro_torch.core.faults.plan import _mix_torch_scalar

    dev = _td.resolve(torch_device)
    idx = torch.arange(n, dtype=torch.int64, device=dev)

    def hash_(salt):
        return _mix_torch_scalar(seed, salt, idx, host)

    def coin(salt, rate):
        return (hash_(salt) & _M32) < _rate_threshold(rate)

    h = hash_(SALT_PAGE)
    if spec.kind == "zipfian":
        cdf = torch.from_numpy(zipf_cdf(spec.num_pages, spec.zipf_s)).to(dev)
        # h >> 11 < 2^53: its float64 is exact, and so is the scale
        u = u64.shr(h, 11).to(torch.float64) * (2.0 ** -53)
        page = torch.searchsorted(cdf, u, right=True).clamp_max(
            spec.num_pages - 1)
    elif spec.kind == "hotspot":
        hp = spec.hot_set_pages
        page = torch.where(coin(SALT_GATE, spec.hot_frac), u64.rem(h, hp),
                           hp + u64.rem(h, spec.num_pages - hp))
    elif spec.kind == "bursty":
        on = idx % (spec.on_len + spec.off_len) < spec.on_len
        page = torch.where(on, u64.rem(h, spec.hot_set_pages),
                           (idx * spec.cold_stride) % spec.num_pages)
    else:                                                    # scan
        page = (idx * spec.stride_pages) % spec.num_pages
    off = u64.rem(hash_(SALT_OFF), spec.line_offsets)
    return (page * spec.page_bytes + off * 64,
            coin(SALT_WRITE, spec.write_frac))
