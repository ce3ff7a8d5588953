"""Replay telemetry: the python driver's metrics and the scan lane's.

The interpreted drivers keep rich component stats — ``DRAMCache.stats``,
``FTL.stats``, ``Fabric.port_report`` — and this module gathers them into
one schema, :class:`MetricsBundle`, so a fused run is *exactly* as
observable as the interpreted run it mirrors:

* **latency histograms** — HDR-style log buckets (4 sub-buckets per
  octave), per host AND per device, with exact nearest-rank percentile
  extraction (``p50/p95/p99``) over the bucket counts;
* **component counters** — the python stats dicts, counter for counter:
  cache hits/misses/MSHR coalesces/stalls/fills/writebacks/evictions,
  page-register buffer hits and flash read/RMW/flush amplification, FTL
  host vs GC writes/erases/runs (write amplification), per-port
  bytes/packets/occupancy/queueing, QoS throttle events, ECMP path
  choice counts;
* **tick-windowed time series** — bytes, latency sum, access count and
  hits per fixed tick window per host.

Parity is the contract: :func:`collect_python` builds the bundle from the
interpreted objects, :func:`bundle_single_deferred` from the scan lane's
per-access ``(issue, done, flags)`` columns (each media event packed into
the flags word, :data:`FLAG_EVENT_BITS`) plus its per-port queueing and
QoS-throttle totals, and :func:`bundle_multi_deferred` from the
multi-host replay's per-step ``(who, issue, done, flags)`` columns; the
golden pins hold them equal.  Per-port byte/packet/occupancy totals are
pure functions of the route choices, so they are reconstructed on the
host with numpy.  A streamed replay that keeps no per-access outputs
(``return_latencies=False``) folds each chunk's columns on the replay's
device into O(buckets + windows) int64 accumulators (:class:`StreamFold`,
the JAX package's in-scan ``acc_update`` / ``media_increments``, the same
integers by construction), which :func:`bundle_single_fused` and
:func:`bundle_multi_fused` turn into the bundle.

Histogram bucketing: values below 8 index themselves (exact small-latency
buckets); otherwise with ``e = bit_length(v) - 1`` the index is
``4*e + ((v >> (e-2)) & 3) - 4`` — four linear sub-buckets per power of
two, continuous across octave boundaries.  :func:`bucket_index` derives
``e`` via ``frexp`` (exact below 2^53), so ``hist_buckets`` is capped at
208 (indices above that are only reachable past 2^53 ticks ~ 100 days of
simulated time).

Numpy only at import: the python lane collects metrics without torch;
the streaming fold loads it on first use.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.engine import to_ns
from repro_torch.core.fabric.fabric import FabricAttachedDevice
from repro_torch.core.fabric.pool import HostPortView
from repro_torch.core.replay.spec import DRAM, PMEM, SSD_BUF, SSD_CACHE

# Counter schema per media kind — names match the python stats dicts they
# mirror (DRAMCache.stats + policy counters, CXLSSDDevice.stats,
# PMEMDevice.stats).  Order is the fused counter-vector layout.
MEDIA_COUNTERS: Dict[str, Tuple[str, ...]] = {
    DRAM: ("accesses", "reads", "writes"),
    PMEM: ("accesses", "reads", "writes", "row_hits"),
    SSD_BUF: ("accesses", "reads", "writes", "buf_hits",
              "flash_reads", "rmw_fills", "flash_writes"),
    SSD_CACHE: ("accesses", "reads", "writes", "hits", "misses",
                "mshr_coalesced", "mshr_stalls", "fills", "writebacks",
                "evictions", "dirty_evictions"),
}

# FTL.stats, key for key (per flash instance / HIL)
FLASH_COUNTERS = ("host_reads", "host_writes", "gc_writes", "gc_erases",
                  "gc_runs")

# Fault/degradation counters — emitted ONLY when an active
# :class:`~repro_torch.core.faults.FaultPlan` is installed, so fault-free runs
# (and the committed golden pins) keep their exact byte-for-byte schema.
FAULT_COUNTERS = ("link_retries", "failovers", "degraded_accesses",
                  "nand_read_retries", "retired_blocks", "poisoned_reads")

# per-kind "hit" counter used by MetricsBundle.hit_rate
_HIT_KEYS = ("hits", "buf_hits", "row_hits")

MAX_HIST_BUCKETS = 208   # numpy frexp stays exact below 2^53 (see module doc)


@dataclass(frozen=True)
class MetricsSpec:
    """Static (hashable) shape of the telemetry carry.

    ``hist_buckets`` log-latency buckets; time series of ``num_windows``
    windows of ``window_ticks`` ticks each (completions past the last
    window clamp into it, so nothing is dropped)."""

    hist_buckets: int = 128
    window_ticks: int = 1_000_000      # 1 us at 1 tick = 1 ps
    num_windows: int = 64

    def __post_init__(self) -> None:
        if not 8 <= self.hist_buckets <= MAX_HIST_BUCKETS:
            raise ValueError(
                f"hist_buckets must be in [8, {MAX_HIST_BUCKETS}], got "
                f"{self.hist_buckets}")
        if self.window_ticks < 1 or self.num_windows < 1:
            raise ValueError("window_ticks and num_windows must be >= 1")


# ------------------------------------------------------------- bucketing
def bucket_index(lat, num_buckets: int) -> np.ndarray:
    """numpy log-bucket index (vectorized); see the module docstring."""
    v = np.maximum(np.asarray(lat, np.int64), 0)
    vv = np.maximum(v, 1)
    _, ex = np.frexp(vv.astype(np.float64))
    e = ex.astype(np.int64) - 1                      # bit_length(v) - 1
    sub = (vv >> np.maximum(e - 2, 0).astype(np.int64)) & 3
    idx = np.where(v < 8, v, 4 * e + sub - 4)
    return np.minimum(idx, num_buckets - 1).astype(np.int64)


def bucket_bounds(idx: int) -> Tuple[int, int]:
    """Inclusive ``(lo, hi)`` tick range of bucket ``idx`` (the top bucket
    of a spec additionally absorbs everything above its ``hi``)."""
    idx = int(idx)
    if idx < 8:
        return idx, idx
    e = (idx + 4) // 4
    sub = (idx + 4) % 4
    lo = (1 << e) + sub * (1 << (e - 2))
    return lo, lo + (1 << (e - 2)) - 1


def percentile_from_hist(hist: np.ndarray, q: float) -> Optional[Dict]:
    """Nearest-rank percentile over bucket counts: the bucket holding the
    ``ceil(q/100 * n)``-th smallest sample, as ``{bucket, lo, hi, rank,
    n}``; ``None`` on an empty histogram.  The true sample at that rank is
    guaranteed to lie in ``[lo, hi]`` (validated against
    ``numpy.percentile``'s inverted-CDF method in the tests)."""
    hist = np.asarray(hist, np.int64)
    n = int(hist.sum())
    if n == 0:
        return None
    k = max(1, int(math.ceil(q / 100.0 * n)))
    idx = int(np.searchsorted(np.cumsum(hist), k))
    lo, hi = bucket_bounds(idx)
    return {"bucket": idx, "lo": lo, "hi": hi, "rank": k, "n": n}


def fold_arrays(spec: MetricsSpec, issues, dones, hits, size: int):
    """Single-host ``(hist, windows, dev_hist)`` from materialized
    per-access arrays, the same integers :func:`collect_python` folds
    from its taps.  The scan lane emits ``(issue, done, flags)`` per
    access, so the fold runs here, off the replay hot path (deferred to
    first bundle access)."""
    NB, W = spec.hist_buckets, spec.num_windows
    issues = np.asarray(issues, np.int64)
    dones = np.asarray(dones, np.int64)
    lat = dones - issues
    b = bucket_index(lat, NB)
    hist = np.bincount(b, minlength=NB).astype(np.int64)[None]
    wdx = np.clip(dones // spec.window_ticks, 0, W - 1)
    cnt = np.bincount(wdx, minlength=W).astype(np.int64)
    windows = np.zeros((1, W, 4), np.int64)
    windows[0, :, 0] = cnt * size
    np.add.at(windows[0, :, 1], wdx, lat)
    windows[0, :, 2] = cnt
    np.add.at(windows[0, :, 3], wdx, np.asarray(hits, np.int64))
    return hist, windows, hist.copy()


# Event booleans the scan packs into the per-access flags word when metrics
# are enabled: every MEDIA_COUNTERS column is then a pure function of
# (writes, flags), so the counter vector needs no carry at all.  Bits 0/1
# are the public hit/evict bits the engine always emits.
FLAG_EVENT_BITS: Dict[str, Tuple[Tuple[int, str], ...]] = {
    DRAM: (),
    PMEM: (),
    SSD_BUF: ((2, "fill"),),
    SSD_CACHE: ((2, "miss"), (3, "coalesce"), (4, "stall"),
                (5, "eviction")),
}


def media_from_flags(kind: str, writes, flags) -> np.ndarray:
    """:data:`MEDIA_COUNTERS`\\ [kind] vector from the input write column
    and the scan's (event-bit-widened) flags word."""
    flags = np.asarray(flags)
    wr = np.asarray(writes, bool)
    n = int(flags.size)
    w = int(wr.sum())

    def cnt(bit: int) -> int:
        return int(((flags >> bit) & 1).sum())

    if kind == DRAM:
        cols = [n, n - w, w]
    elif kind == PMEM:
        cols = [n, n - w, w, cnt(0)]
    elif kind == SSD_BUF:
        fill = ((flags >> 2) & 1).astype(bool)
        cols = [n, n - w, w, cnt(0), int((fill & ~wr).sum()),
                int((fill & wr).sum()), cnt(1)]
    elif kind == SSD_CACHE:
        miss = cnt(2)
        cols = [n, n - w, w, cnt(0), miss, cnt(3), cnt(4), miss, cnt(1),
                cnt(5), cnt(1)]
    else:
        raise ValueError(kind)
    return np.asarray(cols, np.int64)


# ------------------------------------------------- streaming accumulators
BIG_TICK = 1 << 62          # an empty host's first issue (never below it)


def bucket_index_torch(lat, num_buckets: int):
    """torch twin of :func:`bucket_index` (and of the JAX package's
    ``clz``-based ``bucket_index_jnp``), exact at any int64: the bit
    length comes from a binary search over shifts, not from a float."""
    import torch

    v = torch.clamp(lat.to(torch.int64), min=0)
    vv = torch.clamp(v, min=1)
    e = torch.zeros_like(vv)                         # bit_length(vv) - 1
    for shift in (32, 16, 8, 4, 2, 1):
        e = torch.where((vv >> (e + shift)) > 0, e + shift, e)
    sub = (vv >> torch.clamp(e - 2, min=0)) & 3
    idx = torch.where(v < 8, v, 4 * e + sub - 4)
    return torch.clamp(idx, max=num_buckets - 1)


def acc_rows(spec: MetricsSpec, n_hosts: int, n_devs: int) -> int:
    """Row count of the combined accumulator: per-host histogram +
    windows, plus a per-device histogram block when devices != hosts."""
    rows = n_hosts * (spec.hist_buckets + spec.num_windows)
    if n_devs > 1:
        rows += n_devs * spec.hist_buckets
    return rows


def split_acc(spec: MetricsSpec, acc, n_hosts: int, n_devs: int):
    """Decode the combined accumulator into ``(hist (H,NB), windows
    (H,W,4), dev_hist (D,NB))`` numpy arrays."""
    NB, W = spec.hist_buckets, spec.num_windows
    acc = np.asarray(acc)
    per = acc[:n_hosts * (NB + W)].reshape(n_hosts, NB + W, 4)
    hist = per[:, :NB, 0].copy()
    windows = per[:, NB:, :].copy()
    if n_devs > 1:
        dev_hist = acc[n_hosts * (NB + W):].reshape(n_devs, NB, 4)[:, :, 0]
        dev_hist = dev_hist.copy()
    else:
        dev_hist = hist.sum(axis=0, keepdims=True)
    return hist, windows, dev_hist


def media_increments(kind: str, wr, flags):
    """Per-access increments of :data:`MEDIA_COUNTERS`\\ [kind] (int64,
    accesses x counters) from the write column and the flags word's
    event bits: the torch form of the JAX package's ``media_increments``,
    summed by :func:`media_from_flags`."""
    import torch

    wr = wr.to(torch.bool)
    one = torch.ones_like(flags, dtype=torch.int64)

    def bit(b):
        return (flags >> b) & 1

    rd, wrt = (~wr).to(torch.int64), wr.to(torch.int64)
    if kind == DRAM:
        cols = [one, rd, wrt]
    elif kind == PMEM:
        cols = [one, rd, wrt, bit(0)]
    elif kind == SSD_BUF:
        fill = bit(2).to(torch.bool)
        cols = [one, rd, wrt, bit(0), (fill & ~wr).to(torch.int64),
                (fill & wr).to(torch.int64), bit(1)]
    elif kind == SSD_CACHE:
        miss = bit(2)
        cols = [one, rd, wrt, bit(0), miss, bit(3), bit(4), miss, bit(1),
                bit(5), bit(1)]
    else:
        raise ValueError(kind)
    return torch.stack([c.to(torch.int64) for c in cols], dim=-1)


class StreamFold:
    """The streaming accumulators of a replay that keeps no per-access
    outputs, on the replay's device: the combined histogram / window
    accumulator of :func:`acc_rows` rows (``acc``, none without a spec),
    the media counters a device (``med``) and a host each the first issue,
    last completion, latency sum and step count.  :meth:`update` folds
    one chunk's columns in: ``bincount`` / ``index_add_`` on int64, the
    same integers as the JAX package's per-access ``acc_update`` in any
    chunking."""

    def __init__(self, spec: Optional[MetricsSpec], kind: str, device, *,
                 n_hosts: int = 1, n_devs: int = 1, size: int = 64,
                 start_tick: int = 0) -> None:
        import torch

        self.spec, self.kind, self.size = spec, kind, int(size)
        self.n_hosts, self.n_devs = n_hosts, n_devs

        def z(*shape):
            return torch.zeros(shape, dtype=torch.int64, device=device)

        self.acc = (z(acc_rows(spec, n_hosts, n_devs), 4)
                    if spec is not None else z(0, 4))
        self.med = z(n_devs, len(MEDIA_COUNTERS[kind]))
        self.first = torch.full((n_hosts,), BIG_TICK, dtype=torch.int64,
                                device=device)
        self.last = torch.full((n_hosts,), int(start_tick),
                               dtype=torch.int64, device=device)
        self.sum = z(n_hosts)
        self.cnt = z(n_hosts)

    def leaves(self) -> Dict[str, np.ndarray]:
        """The accumulators as host arrays (a checkpoint's leaves)."""
        return {k: getattr(self, k).cpu().numpy()
                for k in ("acc", "med", "first", "last", "sum", "cnt")}

    def load(self, leaves: Dict[str, np.ndarray]) -> None:
        import torch

        for k, v in leaves.items():
            getattr(self, k).copy_(torch.from_numpy(np.asarray(v)))

    def update(self, issues, dones, flags, writes, host=None,
               dev=None) -> None:
        """Fold one chunk: per-access ``issues`` / ``dones`` (int64),
        ``flags`` (int32, event bits included) and ``writes`` (bool), and
        for a multi-host replay each step's ``host`` and media ``dev``
        (int64; ``None`` is host 0, device 0)."""
        import torch

        lat = dones - issues
        H = self.n_hosts
        if host is None:
            self.first[0] = torch.minimum(self.first[0], issues.min())
            self.last[0] = torch.maximum(self.last[0], dones.max())
            self.sum[0] += lat.sum()
            self.cnt[0] += lat.numel()
        else:
            self.first.scatter_reduce_(0, host, issues, "amin")
            self.last.scatter_reduce_(0, host, dones, "amax")
            self.sum.index_add_(0, host, lat)
            self.cnt += torch.bincount(host, minlength=H)
        inc = media_increments(self.kind, writes, flags)
        if dev is None:
            self.med[0] += inc.sum(0)
        else:
            self.med.index_add_(0, dev, inc)
        if self.spec is None:
            return
        NB, W = self.spec.hist_buckets, self.spec.num_windows
        b = bucket_index_torch(lat, NB)
        wdx = torch.clamp(dones // self.spec.window_ticks, 0, W - 1)
        h = torch.zeros_like(b) if host is None else host
        rows = torch.cat([h * (NB + W) + b, h * (NB + W) + NB + wdx])
        vals = torch.zeros(2 * b.numel(), 4, dtype=torch.int64,
                           device=b.device)
        vals[:b.numel(), 0] = 1
        vals[b.numel():, 0] = self.size
        vals[b.numel():, 1] = lat
        vals[b.numel():, 2] = 1
        vals[b.numel():, 3] = flags & 1
        if self.n_devs > 1:
            rows = torch.cat([rows, H * (NB + W) + dev * NB + b])
            extra = torch.zeros(b.numel(), 4, dtype=torch.int64,
                                device=b.device)
            extra[:, 0] = 1
            vals = torch.cat([vals, extra])
        self.acc.index_add_(0, rows, vals)


# --------------------------------------------------------------- the bundle
class MetricsBundle:
    """One run's telemetry, schema-identical between the python driver and
    the fused lanes (integers only, so golden pins compare exactly).

    ``hist (H, hist_buckets)``, ``dev_hist (D, hist_buckets)`` and
    ``windows (H, num_windows, 4)`` (bytes/lat/n/hits) are int64 arrays;
    ``media`` / ``flash`` are per-device / per-flash counter dicts.  Either
    pass them eagerly, or pass ``deferred`` — a zero-arg callable returning
    ``(hist, windows, dev_hist, media)`` — and the fold runs once on first
    access, off the replay hot path (the fused engine defers the O(N)
    histogram/window/counter fold out of ``run_arrays`` this way)."""

    def __init__(self, *, spec: MetricsSpec, hosts: Sequence[str],
                 devices: Sequence[str], hist: Optional[np.ndarray] = None,
                 dev_hist: Optional[np.ndarray] = None,
                 windows: Optional[np.ndarray] = None,
                 media: Optional[List[Dict[str, int]]] = None,
                 flash: Optional[List[Dict[str, int]]] = None,
                 ports: Optional[Dict[str, Dict]] = None,
                 ecmp: Optional[Dict[str, List[int]]] = None,
                 deferred: Optional[Callable] = None,
                 faults: Optional[Dict[str, int]] = None) -> None:
        if deferred is None and (hist is None or dev_hist is None
                                 or windows is None or media is None):
            raise ValueError(
                "MetricsBundle needs hist/dev_hist/windows/media, or a "
                "deferred fold producing them")
        self.spec = spec
        self.hosts = list(hosts)
        self.devices = list(devices)
        self.flash = flash if flash is not None else []
        self.ports = ports if ports is not None else {}
        self.ecmp = ecmp if ecmp is not None else {}
        # FAULT_COUNTERS dict when a fault plan was active; None otherwise
        # (kept out of to_jsonable when None — schema stability)
        self.faults = faults
        self._hist = hist
        self._dev_hist = dev_hist
        self._windows = windows
        self._media = media
        self._deferred = deferred

    def _force(self) -> None:
        if self._deferred is not None:
            (self._hist, self._windows, self._dev_hist,
             self._media) = self._deferred()
            self._deferred = None

    @property
    def hist(self) -> np.ndarray:
        self._force()
        return self._hist

    @property
    def dev_hist(self) -> np.ndarray:
        self._force()
        return self._dev_hist

    @property
    def windows(self) -> np.ndarray:
        self._force()
        return self._windows

    @property
    def media(self) -> List[Dict[str, int]]:
        self._force()
        return self._media

    # ------------------------------------------------------------ analysis
    def percentile(self, q: float, host: Optional[int] = None,
                   device: Optional[int] = None) -> Optional[Dict]:
        """Nearest-rank percentile over one host's, one device's, or the
        aggregate histogram; ``None`` when empty."""
        if host is not None:
            h = self.hist[host]
        elif device is not None:
            h = self.dev_hist[device]
        else:
            h = self.hist.sum(axis=0)
        return percentile_from_hist(h, q)

    def percentile_ticks(self, q: float, host: Optional[int] = None,
                         device: Optional[int] = None) -> Optional[int]:
        """The percentile bucket's upper edge in ticks (conservative)."""
        p = self.percentile(q, host=host, device=device)
        return None if p is None else int(p["hi"])

    def percentile_ns(self, q: float, host: Optional[int] = None,
                      device: Optional[int] = None) -> Optional[float]:
        t = self.percentile_ticks(q, host=host, device=device)
        return None if t is None else to_ns(t)

    @property
    def accesses(self) -> int:
        return int(sum(m.get("accesses", 0) for m in self.media))

    @property
    def hit_rate(self) -> float:
        """Hits over accesses, summed over devices — using each media
        kind's own hit counter (cache hits / buffer hits / row hits);
        0.0 for hit-less media or an empty run."""
        acc = self.accesses
        hits = 0
        for m in self.media:
            for key in _HIT_KEYS:
                if key in m:
                    hits += m[key]
                    break
        return hits / acc if acc else 0.0

    @property
    def write_amplification(self) -> float:
        """``(host + GC writes) / host writes`` over every flash instance
        (1.0 with no flash or no host writes, like
        :meth:`FTL.write_amplification`)."""
        hw = sum(f["host_writes"] for f in self.flash)
        gw = sum(f["gc_writes"] for f in self.flash)
        return (hw + gw) / hw if hw else 1.0

    # ---------------------------------------------------------- export
    def to_jsonable(self) -> Dict:
        """Deterministic, integers-only JSON form.  Histograms and windows
        are sparse ``{index: value}`` maps so golden pins stay compact;
        ``p50/p95/p99`` per host are included for readability (derived
        from the histogram, so parity follows from histogram parity)."""
        def sparse_hist(row):
            return {str(i): int(v) for i, v in enumerate(row) if v}

        def sparse_windows(rows):
            return {str(w): [int(x) for x in r]
                    for w, r in enumerate(rows) if any(r)}

        def pcts(row):
            out = {}
            for q in (50, 95, 99):
                p = percentile_from_hist(row, q)
                out[f"p{q}"] = None if p is None else int(p["hi"])
            return out

        out = {
            "spec": {"hist_buckets": self.spec.hist_buckets,
                     "window_ticks": self.spec.window_ticks,
                     "num_windows": self.spec.num_windows},
            "hosts": list(self.hosts),
            "devices": list(self.devices),
            "hist": [sparse_hist(r) for r in self.hist],
            "dev_hist": [sparse_hist(r) for r in self.dev_hist],
            "windows": [sparse_windows(r) for r in self.windows],
            "percentiles": [pcts(r) for r in self.hist],
            "media": [{k: int(v) for k, v in m.items()} for m in self.media],
            "flash": [{k: int(v) for k, v in f.items()} for f in self.flash],
            "ports": {k: dict(v) for k, v in sorted(self.ports.items())},
            "ecmp": {k: list(v) for k, v in sorted(self.ecmp.items())},
        }
        if self.faults is not None:
            out["faults"] = {k: int(self.faults[k]) for k in FAULT_COUNTERS}
        return out


# ------------------------------------------------------- python collection
def _media_hits(dev) -> int:
    if hasattr(dev, "cache"):
        return int(dev.cache.policy.hits)
    s = getattr(dev, "stats", {})
    for key in ("buf_hits", "row_hits"):
        if key in s:
            return int(s[key])
    return 0


def media_counters_of(dev) -> Dict[str, int]:
    """One device's :data:`MEDIA_COUNTERS` dict from its live stats."""
    if hasattr(dev, "cache"):
        c, pol = dev.cache.stats, dev.cache.policy
        return {"accesses": c["accesses"], "reads": c["reads"],
                "writes": c["writes"], "hits": pol.hits,
                "misses": pol.misses,
                "mshr_coalesced": c["mshr_coalesced"],
                "mshr_stalls": c["mshr_stalls"], "fills": c["fills"],
                "writebacks": c["writebacks"], "evictions": pol.evictions,
                "dirty_evictions": pol.dirty_evictions}
    s = dev.stats
    out = {"accesses": s["reads"] + s["writes"], "reads": s["reads"],
           "writes": s["writes"]}
    if "buf_hits" in s:
        out.update(buf_hits=s["buf_hits"], flash_reads=s["flash_reads"],
                   rmw_fills=s["rmw_fills"], flash_writes=s["flash_writes"])
    elif "row_hits" in s:
        out["row_hits"] = s["row_hits"]
    return {k: int(v) for k, v in out.items()}


def flash_counters_of(hil) -> Dict[str, int]:
    return {k: int(hil.ftl.stats[k]) for k in FLASH_COUNTERS}


def fault_counters_of(targets: Sequence, poisoned: int = 0
                      ) -> Optional[Dict[str, int]]:
    """:data:`FAULT_COUNTERS` dict from the interpreted objects, or
    ``None`` when no *active* fault plan is installed anywhere in the
    target stack — the bundle (and every committed golden pin) is
    byte-identical on fault-free runs.  ``poisoned`` is the driver-side
    poisoned-read count (the plan flags reads corrupt at issue ordinal;
    the analytic path has no flits to carry the bit)."""
    plan = next((p for p in (getattr(t, "fault_plan", None) for t in targets)
                 if p is not None and p.active), None)
    _, _, devices, fabric, _ = _target_layout(targets)
    if plan is None and fabric is not None:
        fp = getattr(fabric, "fault_plan", None)
        if fp is not None and fp.active:
            plan = fp
    if plan is None:
        return None
    stats = (fabric.fault_stats if fabric is not None
             else {"link_retries": 0, "failovers": 0,
                   "degraded_accesses": 0})
    hils = _unique_hils(devices)
    return {
        "link_retries": int(stats["link_retries"]),
        "failovers": int(stats["failovers"]),
        "degraded_accesses": int(stats["degraded_accesses"]),
        "nand_read_retries": sum(int(h.ftl.pal.stats["read_retries"])
                                 for h in hils),
        "retired_blocks": sum(len(h.ftl.retired_blocks) for h in hils),
        "poisoned_reads": int(poisoned),
    }


def _unique_hils(devices: Sequence) -> List:
    """Flash instances in first-appearance order — the same dedupe order
    the fused :func:`~repro_torch.core.replay.multihost._media_setup` uses."""
    seen: Dict[int, object] = {}
    for d in devices:
        hil = getattr(d, "hil", None)
        if hil is not None:
            seen.setdefault(id(hil), hil)
    return list(seen.values())


def _ports_of(fabric) -> Dict[str, Dict]:
    """Integer port counters keyed ``"u->v"`` — :meth:`Fabric.port_report`
    minus the float derivations, same packets>0 filter."""
    out = {}
    for key in sorted(fabric.ports):
        p = fabric.ports[key]
        if not p.packets:
            continue
        out[f"{p.src}->{p.dst}"] = {
            "bytes": int(p.bytes),
            "packets": int(p.packets),
            "occupied_ticks": int(p.occupied_ticks),
            "queued_ticks": int(p.queued_ticks),
            "qos_throttle_events": int(
                getattr(p, "qos_throttle_events", 0)),
            "bytes_by_host": {h: int(b) for h, b in
                              sorted(p.bytes_by_origin.items())},
        }
    return out


def _target_layout(targets: Sequence):
    """(hosts, device labels, device objects, fabric|None, dev_of fns) for
    a homogeneous target list — mirrors the fused engines' labeling, and
    degrades gracefully for plain (fabric-less) devices."""
    first = targets[0]
    if isinstance(first, HostPortView):
        pool = first.pool
        hosts = [t.host for t in targets]
        labels = list(pool.device_nodes)
        devices = list(pool.devices)
        mapper = pool.mapper

        def dev_of(_i):
            return lambda addr: mapper.map(addr)[0]

        return (hosts, labels, devices, pool.fabric,
                [dev_of(i) for i in range(len(targets))])
    if isinstance(first, FabricAttachedDevice):
        hosts = [t.host for t in targets]
        labels = [t.device_node for t in targets]
        devices = [t.inner for t in targets]
        return (hosts, labels, devices, first.fabric,
                [(lambda i: (lambda addr: i))(i)
                 for i in range(len(targets))])
    hosts = [f"host{i}" for i in range(len(targets))]
    if len(targets) == 1:
        hosts = ["host0"]
    labels = [t.name for t in targets]
    return (hosts, labels, list(targets), None,
            [(lambda i: (lambda addr: i))(i) for i in range(len(targets))])


class MetricTap:
    """Wrap one host target, recording per-access ``(issue, done, size,
    device, hit-delta)`` — the python side of histogram/window parity —
    without touching timing."""

    def __init__(self, target, dev_of: Callable[[int], int],
                 hit_count: Callable[[], int]) -> None:
        self._dev = target
        self._dev_of = dev_of
        self._hits = hit_count
        self.records: List[Tuple[int, int, int, int, int]] = []

    def __getattr__(self, name):
        return getattr(self._dev, name)

    def service(self, now, addr, size, write, posted=False):
        h0 = self._hits()
        done = self._dev.service(now, addr, size, write, posted)
        self.records.append((int(now), int(done), int(size),
                             int(self._dev_of(addr)), self._hits() - h0))
        return done


def attach_taps(targets: Sequence) -> List[MetricTap]:
    """One :class:`MetricTap` per host target; run the (python) driver over
    the taps, then hand targets+taps to :func:`collect_python`."""
    _, _, devices, _, dev_fns = _target_layout(targets)

    def hit_count():
        return sum(_media_hits(d) for d in devices)

    return [MetricTap(t, fn, hit_count)
            for t, fn in zip(targets, dev_fns)]


def collect_python(spec: MetricsSpec, targets: Sequence,
                   taps: Sequence[MetricTap],
                   poisoned: int = 0) -> MetricsBundle:
    """Build the bundle from an interpreted run: tap records give the
    histograms/windows, the live stats dicts give every counter."""
    hosts, labels, devices, fabric, _ = _target_layout(targets)
    NB, W, T = spec.hist_buckets, spec.num_windows, spec.window_ticks
    H, D = len(hosts), len(labels)
    hist = np.zeros((H, NB), np.int64)
    dev_hist = np.zeros((D, NB), np.int64)
    windows = np.zeros((H, W, 4), np.int64)
    for i, tap in enumerate(taps):
        for issue, done, size, dev, hit in tap.records:
            b = int(bucket_index(done - issue, NB))
            hist[i, b] += 1
            dev_hist[dev, b] += 1
            w = min(max(done // T, 0), W - 1)
            windows[i, w] += (size, done - issue, 1, hit)
    bundle = MetricsBundle(
        spec=spec, hosts=hosts, devices=labels, hist=hist,
        dev_hist=dev_hist, windows=windows,
        media=[media_counters_of(d) for d in devices],
        flash=[flash_counters_of(h) for h in _unique_hils(devices)],
        ports=_ports_of(fabric) if fabric is not None else {},
        ecmp={k: list(v) for k, v in
              sorted(getattr(fabric, "ecmp_counts", {}).items())}
        if fabric is not None else {},
        faults=fault_counters_of(targets, poisoned),
    )
    return bundle


# --------------------------------------------------------- scan collection
def _flash_dicts(flash_cnt) -> List[Dict[str, int]]:
    if flash_cnt is None:
        return []
    return [dict(zip(FLASH_COUNTERS, (int(x) for x in row)))
            for row in np.asarray(flash_cnt)]


def _single_ports(device, queued, routes: Optional[np.ndarray], n: int,
                  size: int, qthr=None, faulted=None,
                  route_counts: Optional[np.ndarray] = None):
    """``(host_label, dev_label, ports, ecmp)`` for a single-host scan run
    of ``n`` accesses: port byte/packet/occupancy totals and ECMP choice
    counts are reconstructed from the route choices on the host (pure
    functions of the trace); ``queued`` is the scan's per-port queueing
    total and ``qthr`` its QoS-throttle twin (``None`` reads as all-zero,
    matching FCFS ports whose interpreted counter never moves).
    ``routes`` is the per-access ECMP choice column, ``None`` on a fixed
    route.  ``faulted`` (the fault-column builder's totals) overrides the
    clean reconstruction when transport faults rerouted accesses or
    charged retry serializations.  A streamed run that never holds the
    route column passes its choices' counts, ``route_counts``, instead."""
    ports: Dict[str, Dict] = {}
    ecmp: Dict[str, List[int]] = {}
    if not isinstance(device, FabricAttachedDevice):
        return "host0", device.name, ports, ecmp
    fab, host, node = device.fabric, device.host, device.device_node
    queued = [int(q) for q in np.asarray(queued).reshape(-1)]
    qt = ([int(x) for x in np.asarray(qthr).reshape(-1)]
          if qthr is not None else None)
    if faulted is not None:
        for j, key in enumerate(faulted["port_keys"]):
            if not faulted["packets"][j]:
                continue
            ports[f"{key[0]}->{key[1]}"] = {
                "bytes": int(faulted["bytes"][j]),
                "packets": int(faulted["packets"][j]),
                "occupied_ticks": int(faulted["occupied"][j]),
                "queued_ticks": queued[j],
                "qos_throttle_events": qt[j] if qt is not None else 0,
                "bytes_by_host": {host: int(faulted["bytes"][j])}}
        ecmp = {k: list(v) for k, v in sorted(faulted["ecmp"].items())}
        return host, node, ports, ecmp
    if routes is None and route_counts is None:
        for h, (key, occ, _aft) in enumerate(
                fab.route_occupancy(host, node, size)):
            ports[f"{key[0]}->{key[1]}"] = {
                "bytes": n * size, "packets": n,
                "occupied_ticks": n * int(occ),
                "queued_ticks": queued[h],
                "qos_throttle_events": qt[h] if qt is not None else 0,
                "bytes_by_host": {host: n * size}}
        return host, node, ports, ecmp
    K = len(fab.paths(host, node))
    per_route = [fab.route_occupancy(host, node, size, choice=k)
                 for k in range(K)]
    # same port-union indexing as spec._fabric_route_tensors
    port_keys = sorted({key for hops in per_route for key, _, _ in hops})
    pidx = {key: i for i, key in enumerate(port_keys)}
    counts = (np.asarray(route_counts, np.int64) if route_counts is not None
              else np.bincount(np.asarray(routes), minlength=K))
    nb = np.zeros(len(port_keys), np.int64)
    pk = np.zeros(len(port_keys), np.int64)
    occt = np.zeros(len(port_keys), np.int64)
    for k, hops in enumerate(per_route):
        for key, occ, _aft in hops:
            j = pidx[key]
            nb[j] += int(counts[k]) * size
            pk[j] += int(counts[k])
            occt[j] += int(counts[k]) * int(occ)
    for key, j in pidx.items():
        if not pk[j]:
            continue
        ports[f"{key[0]}->{key[1]}"] = {
            "bytes": int(nb[j]), "packets": int(pk[j]),
            "occupied_ticks": int(occt[j]),
            "queued_ticks": queued[j],
            "qos_throttle_events": qt[j] if qt is not None else 0,
            "bytes_by_host": {host: int(nb[j])}}
    if K > 1 and n:
        ecmp[f"{host}->{node}"] = [int(c) for c in counts]
    return host, node, ports, ecmp


def bundle_single_fused(spec: MetricsSpec, device, cfg, acc, med, queued,
                        flash_cnt, routes: Optional[np.ndarray], n: int,
                        size: int, qthr=None,
                        faults: Optional[Dict[str, int]] = None,
                        faulted=None,
                        route_counts: Optional[np.ndarray] = None
                        ) -> MetricsBundle:
    """Assemble the bundle after a single-host streamed run of ``n``
    accesses that kept no per-access outputs (``return_latencies=False``):
    ``acc`` / ``med`` are its :class:`StreamFold` accumulators
    (O(buckets + windows)); the rest as in
    :func:`bundle_single_deferred`."""
    hist, windows, dev_hist = split_acc(spec, acc, 1, 1)
    media = [dict(zip(MEDIA_COUNTERS[cfg.kind],
                      (int(x) for x in np.asarray(med).reshape(-1))))]
    host_label, dev_label, ports, ecmp = _single_ports(
        device, queued, routes, n, size, qthr=qthr, faulted=faulted,
        route_counts=route_counts)
    return MetricsBundle(
        spec=spec, hosts=[host_label], devices=[dev_label], hist=hist,
        dev_hist=dev_hist, windows=windows, media=media,
        flash=_flash_dicts(flash_cnt), ports=ports, ecmp=ecmp,
        faults=faults)


def bundle_single_deferred(spec: MetricsSpec, device, cfg, issues, dones,
                           flags, writes, queued, flash_cnt,
                           routes: Optional[np.ndarray], size: int,
                           qthr=None, faults: Optional[Dict[str, int]] = None,
                           faulted=None,
                           route_counts: Optional[np.ndarray] = None
                           ) -> MetricsBundle:
    """Assemble the bundle after a single-host scan run.  The
    histogram/window fold and the counter vector are pure functions of the
    materialized ``(issue, done, flags)`` columns (the scan packs every
    :data:`FLAG_EVENT_BITS` event into the flags word), so they are
    deferred to first access — replay pays only the per-port queueing
    totals and a few flag bits for full telemetry.  ``faults`` is the
    fault counter block of a run under an active plan, ``faulted`` the
    fault-column builder's port totals (see :func:`_single_ports`)."""
    host_label, dev_label, ports, ecmp = _single_ports(
        device, queued, routes, int(np.asarray(issues).size), size,
        qthr=qthr, faulted=faulted, route_counts=route_counts)

    def fold():
        hist, windows, dev_hist = fold_arrays(
            spec, issues, dones, flags & 1, size)
        media = [dict(zip(MEDIA_COUNTERS[cfg.kind],
                          (int(x) for x in
                           media_from_flags(cfg.kind, writes, flags))))]
        return hist, windows, dev_hist, media

    return MetricsBundle(
        spec=spec, hosts=[host_label], devices=[dev_label],
        flash=_flash_dicts(flash_cnt), ports=ports, ecmp=ecmp,
        deferred=fold, faults=faults)


def _multi_ports(meta: Dict, mcfg, queued, qthr, devs: np.ndarray,
                 routes: Optional[np.ndarray], lens: np.ndarray, size: int,
                 params: Dict, faulted: Optional[Dict] = None):
    """``(ports, ecmp)`` of a multi-host replay: per-port byte / packet /
    occupancy totals and per-host attribution reconstructed from the hop
    tables and route choices (numpy, exact); ``queued`` / ``qthr`` are the
    replay's per-port queueing and QoS-throttle totals.  ``faulted`` (the
    transport-fault code's totals, over the same global sorted port set)
    overrides the clean reconstruction."""
    hosts, nodes = meta["hosts"], meta["nodes"]
    fabric = meta["fabric"]
    H = len(hosts)
    lens = np.asarray(lens)
    devs = np.asarray(devs)
    routes = (np.zeros(devs.shape, np.int32) if routes is None
              else np.asarray(routes))
    ecmp: Dict[str, List[int]] = {}
    if faulted is not None:
        port_keys = list(faulted["port_keys"])
        P = len(port_keys)
        npkts = np.asarray(faulted["packets"], np.int64)
        nbytes = np.asarray(faulted["bytes"], np.int64)
        nocc = np.asarray(faulted["occupied"], np.int64)
        by_host = np.asarray(faulted["by_host"], np.int64)
        ecmp = {k: list(v) for k, v in sorted(faulted["ecmp"].items())}
    else:
        port_keys = sorted(fabric.ports)
        P = len(port_keys)
        nbytes = np.zeros(P, np.int64)
        npkts = np.zeros(P, np.int64)
        nocc = np.zeros(P, np.int64)
        by_host = np.zeros((P, H), np.int64)
        hop_port, hop_occ = params["hop_port"], params["hop_occ"]
        hop_on = params["hop_on"]
        for i in range(H):
            n = int(lens[i])
            if not n:
                continue
            d, r = devs[i, :n], routes[i, :n]
            for h in range(mcfg.max_hops):
                on = hop_on[i, d, r, h]
                pi = hop_port[i, d, r, h][on]
                np.add.at(npkts, pi, 1)
                np.add.at(nbytes, pi, size)
                np.add.at(nocc, pi, hop_occ[i, d, r, h][on])
                np.add.at(by_host[:, i], pi, size)
    queued = np.asarray(queued).reshape(-1)
    qthr = (np.asarray(qthr).reshape(-1) if qthr is not None
            else np.zeros(P, np.int64))
    ports: Dict[str, Dict] = {}
    for j, key in enumerate(port_keys):
        if not npkts[j]:
            continue
        ports[f"{key[0]}->{key[1]}"] = {
            "bytes": int(nbytes[j]), "packets": int(npkts[j]),
            "occupied_ticks": int(nocc[j]),
            "queued_ticks": int(queued[j]),
            "qos_throttle_events": int(qthr[j]),
            "bytes_by_host": {hosts[i]: int(by_host[j, i])
                              for i in range(H) if by_host[j, i]},
        }
    if faulted is None:
        route_count = meta["route_count"]
        for i in range(H):
            n = int(lens[i])
            if not n:
                continue
            d_col, r_col = devs[i, :n], routes[i, :n]
            for d in np.unique(d_col):
                K = int(route_count[i, d])
                if K <= 1:
                    continue
                counts = np.bincount(r_col[d_col == d], minlength=K)
                key = f"{hosts[i]}->{nodes[d]}"
                prev = ecmp.get(key)
                ecmp[key] = ([int(c) for c in counts] if prev is None
                             else [int(a + b) for a, b in zip(prev, counts)])
    return ports, ecmp


def bundle_multi_fused(spec: MetricsSpec, meta: Dict, mcfg, acc, med,
                       queued, qthr, flash_cnt, devs: np.ndarray,
                       routes: Optional[np.ndarray], lens: np.ndarray,
                       size: int, params: Dict,
                       faults: Optional[Dict[str, int]] = None,
                       faulted: Optional[Dict] = None) -> MetricsBundle:
    """Assemble the bundle after a multi-host streamed replay that kept
    no per-step outputs: ``acc`` / ``med`` are its :class:`StreamFold`
    accumulators (hosts and devices), the ports as in
    :func:`bundle_multi_deferred`."""
    hosts, nodes = meta["hosts"], meta["nodes"]
    H, D = len(hosts), len(nodes)
    hist, windows, dev_hist = split_acc(spec, acc, H, D)
    med = np.asarray(med)
    names = MEDIA_COUNTERS[mcfg.stack.kind]
    media = [dict(zip(names, (int(x) for x in med[d]))) for d in range(D)]
    ports, ecmp = _multi_ports(meta, mcfg, queued, qthr, devs, routes, lens,
                               size, params, faulted)
    return MetricsBundle(
        spec=spec, hosts=list(hosts), devices=list(nodes), hist=hist,
        dev_hist=dev_hist, windows=windows, media=media,
        flash=_flash_dicts(flash_cnt), ports=ports, ecmp=ecmp,
        faults=faults)


def bundle_multi_deferred(spec: MetricsSpec, meta: Dict, mcfg, who, issues,
                          dones, flags, step_ord, writes, queued, qthr,
                          flash_cnt, devs: np.ndarray,
                          routes: Optional[np.ndarray], lens: np.ndarray,
                          size: int, params: Dict,
                          faults: Optional[Dict[str, int]] = None,
                          faulted: Optional[Dict] = None) -> MetricsBundle:
    """Assemble the bundle after a multi-host replay from its per-step
    ``(who, issue, done, flags)`` columns: the JAX package's
    ``bundle_multi_fused`` over the in-scan accumulators, folded here on
    the host instead.  ``step_ord`` is each step's ordinal in its host's
    trace, which reads the step's device and write flag from the
    ``(H, L)`` ``devs`` / ``writes`` columns.  Per-host histograms and
    windows, per-device histograms and media counters (from the flags'
    event bits) are deferred to first access; the ports come from
    :func:`_multi_ports`."""
    hosts, nodes = meta["hosts"], meta["nodes"]
    H, D = len(hosts), len(nodes)
    devs = np.asarray(devs)
    ports, ecmp = _multi_ports(meta, mcfg, queued, qthr, devs, routes, lens,
                               size, params, faulted)

    def fold():
        NB, W = spec.hist_buckets, spec.num_windows
        w_ = np.asarray(who, np.int64)
        iss = np.asarray(issues, np.int64)
        dn = np.asarray(dones, np.int64)
        f = np.asarray(flags)
        lat = dn - iss
        b = bucket_index(lat, NB)
        dev = devs[w_, step_ord]
        wr = np.asarray(writes, bool)[w_, step_ord]
        hist = np.zeros((H, NB), np.int64)
        np.add.at(hist, (w_, b), 1)
        dev_hist = np.zeros((D, NB), np.int64)
        np.add.at(dev_hist, (dev, b), 1)
        wdx = np.clip(dn // spec.window_ticks, 0, W - 1)
        windows = np.zeros((H, W, 4), np.int64)
        np.add.at(windows[:, :, 0], (w_, wdx), size)
        np.add.at(windows[:, :, 1], (w_, wdx), lat)
        np.add.at(windows[:, :, 2], (w_, wdx), 1)
        np.add.at(windows[:, :, 3], (w_, wdx), (f & 1).astype(np.int64))
        kind = mcfg.stack.kind
        media = [dict(zip(MEDIA_COUNTERS[kind], (int(x) for x in
                                                 media_from_flags(
                                                     kind, wr[dev == d],
                                                     f[dev == d]))))
                 for d in range(D)]
        return hist, windows, dev_hist, media

    return MetricsBundle(
        spec=spec, hosts=list(hosts), devices=list(nodes),
        flash=_flash_dicts(flash_cnt), ports=ports, ecmp=ecmp,
        deferred=fold, faults=faults)


# -------------------------------------------------- availability (faults)
def availability_series(issues, dones, degraded, failover=None, *,
                        spec: Optional[MetricsSpec] = None,
                        start_tick: int = 0,
                        window_ticks: Optional[int] = None,
                        num_windows: Optional[int] = None) -> Dict:
    """Tick-windowed availability series + degraded-mode summary from the
    per-access ``degraded``/``failover`` flags the transport-fault
    precompute emits: per issue-tick window the access count, degraded
    count and reachable fraction; overall the degraded fraction, the
    failover latency penalty (mean failover latency minus mean
    clean-route latency, in ticks) and the total tick time spent in
    windows with any degraded access.

    Deliberately OUTSIDE the python-parity :class:`MetricsBundle` schema:
    the interpreted driver keeps no per-access flag column, so this rides
    the replay result (``ReplayResult.availability``) and the benchmark
    artifacts, never the golden-pinned bundle."""
    issues = np.asarray(issues, np.int64)
    dones = np.asarray(dones, np.int64)
    deg = np.asarray(degraded, bool)
    fo = (np.asarray(failover, bool) if failover is not None
          else np.zeros(deg.shape, bool))
    n = int(issues.size)
    T = int(window_ticks if window_ticks is not None
            else (spec.window_ticks if spec is not None else 1_000_000))
    W = int(num_windows if num_windows is not None
            else (spec.num_windows if spec is not None else 64))
    wdx = np.clip((issues - int(start_tick)) // T, 0, W - 1)
    total = np.bincount(wdx, minlength=W).astype(np.int64)
    degw = np.bincount(wdx[deg], minlength=W).astype(np.int64)
    lat = dones - issues
    nd = int(deg.sum())
    nf = int(fo.sum())
    clean = lat[~deg]
    penalty = 0.0
    if nf and clean.size:
        penalty = float(lat[fo].mean() - clean.mean())
    return {
        "window_ticks": T,
        "num_windows": W,
        "accesses": n,
        "windows": {
            str(w): {"accesses": int(total[w]), "degraded": int(degw[w]),
                     "reachable_fraction": float((total[w] - degw[w])
                                                 / total[w])}
            for w in range(W) if total[w]},
        "degraded_accesses": nd,
        "degraded_fraction": float(nd / n) if n else 0.0,
        "failovers": nf,
        "failover_latency_penalty_ticks": penalty,
        "time_in_degraded_windows_ticks": int(T * int((degw > 0).sum())),
    }


def down_window_spans(plan, issues_by_host: Sequence[np.ndarray],
                      hosts: Optional[Sequence[str]] = None) -> List[Dict]:
    """Each down-link window of ``plan`` as a duration span on the tick
    axis, one per host whose trace reaches into it: the window is declared
    over per-host access ordinals, and trace order *is* ordinal order, so
    the per-host issue column maps ordinal bounds to ticks exactly.
    Windows past the trace end are dropped; ones cut by it are clamped.
    ``obs.export.to_perfetto`` renders these as Perfetto "X" events."""
    spans: List[Dict] = []
    if plan is None or not plan.has_down:
        return spans
    for i, iss in enumerate(issues_by_host):
        iss = np.asarray(iss, np.int64)
        L = int(iss.size)
        host = hosts[i] if hosts is not None else f"host{i}"
        for u, v, a0, a1 in plan.config.down_links:
            lo = max(int(a0), 0)
            hi = min(int(a1), L)
            if hi <= lo:
                continue
            spans.append({
                "host": host,
                "link": f"{u}<->{v}",
                "first_ordinal": lo,
                "last_ordinal_exclusive": hi,
                "start_tick": int(iss[lo]),
                "end_tick": int(iss[hi - 1]),
            })
    return spans
