"""Render a :class:`~repro_torch.core.replay.metrics.MetricsBundle` to
Chrome/Perfetto ``trace_events`` JSON.

Layout (one *process* per track group, named via ``process_name``
metadata so ui.perfetto.dev groups them):

* one process per **host**, carrying counter tracks (``ph: "C"``) sampled
  once per tick window — ``bandwidth_gbps`` (window bytes over the window
  wall time), ``occupancy`` (latency-ticks accumulated per window tick:
  average requests in flight, Little's law), and ``hit_rate``;
* one ``fabric`` process with a complete event (``ph: "X"``) per **port**
  spanning the observed run, its counters (bytes, packets, queued /
  occupied ticks, QoS throttle events, per-host attribution) as ``args``,
  plus one event per ECMP pair carrying the per-path selection counts;
* one ``devices`` process with a complete event per **device** (media
  counters + per-device p50/p95/p99 latency ticks as ``args``) and per
  **flash** instance (write amplification inputs);
* when the run carried an active fault plan, one ``faults`` process with
  an instant event (``ph: "i"``) per nonzero fault counter (link CRC
  retries, failovers, degraded accesses, NAND read retries, retired
  blocks, poisoned reads) plus one summary event carrying all counters;
  pass ``down_windows=`` (the span dicts from
  :func:`repro_torch.core.replay.metrics.down_window_spans`) to additionally
  render each down-link window as a duration event (``ph: "X"``) on the
  tick axis, one track per (host, link) — the degraded intervals line up
  under the host bandwidth/occupancy tracks they explain.

Timestamps are microseconds (the trace_events unit); 1 tick = 1 ps, so
``ts = ticks / 1e6``.  The output is plain JSON — no Perfetto SDK, no
protobuf, no new dependencies.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.core.replay.metrics import MetricsBundle, percentile_from_hist

_TICKS_PER_US = 1_000_000   # 1 tick = 1 ps


def _bundle_of(obj) -> MetricsBundle:
    if isinstance(obj, MetricsBundle):
        return obj
    mb = getattr(obj, "metrics", None)
    if isinstance(mb, MetricsBundle):
        return mb
    raise TypeError(
        "to_perfetto needs a MetricsBundle or a result carrying one "
        "(run the driver/engine with metrics=MetricsSpec(...))")


def _observed_ticks(mb: MetricsBundle) -> int:
    """Upper edge of the last non-empty window — the run span the counter
    tracks cover (a lower bound on wall ticks, exact when the run ends
    inside the windowed range)."""
    last = 0
    for host_rows in mb.windows:
        for w, row in enumerate(host_rows):
            if any(int(x) for x in row):
                last = max(last, w + 1)
    return last * mb.spec.window_ticks


def _pcts_args(hist_row) -> Dict[str, int]:
    out = {}
    for q in (50, 95, 99):
        p = percentile_from_hist(hist_row, q)
        if p is not None:
            out[f"p{q}_ticks"] = int(p["hi"])
    return out


def to_perfetto(bundle_or_result, down_windows=None) -> Dict:
    """Build the ``trace_events`` JSON document (as a dict) for a metrics
    bundle, or for any replay/driver result carrying one.  ``down_windows``
    optionally adds the transport down-link spans
    (:func:`repro_torch.core.replay.metrics.down_window_spans`) to the faults
    track group."""
    mb = _bundle_of(bundle_or_result)
    wt = mb.spec.window_ticks
    events: List[Dict] = []

    def proc(pid: int, name: str) -> None:
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": name}})

    def counter(pid: int, name: str, ts_us: float, value) -> None:
        events.append({"name": name, "ph": "C", "pid": pid, "tid": 0,
                       "ts": ts_us, "args": {"value": value}})

    # ------------------------------------------------- host counter tracks
    for h, host in enumerate(mb.hosts):
        pid = h + 1
        proc(pid, f"host {host}")
        for w, row in enumerate(mb.windows[h]):
            nbytes, lat, n, hits = (int(x) for x in row)
            if not (nbytes or lat or n or hits):
                continue
            ts = (w * wt) / _TICKS_PER_US
            # bytes per window-second: bytes/(wt ps) -> GB/s is *1e3/wt
            counter(pid, "bandwidth_gbps", ts,
                    round(nbytes * 1e3 / wt, 6))
            counter(pid, "occupancy", ts, round(lat / wt, 6))
            counter(pid, "hit_rate", ts,
                    round(hits / n, 6) if n else 0.0)
        # zero-terminate each track so the last window renders with width
        end = _observed_ticks(mb) / _TICKS_PER_US
        for name in ("bandwidth_gbps", "occupancy", "hit_rate"):
            counter(pid, name, end, 0)

    dur = max(_observed_ticks(mb), 1) / _TICKS_PER_US

    # -------------------------------------------------------- fabric ports
    if mb.ports or mb.ecmp:
        pid = len(mb.hosts) + 1
        proc(pid, "fabric")
        for tid, (key, row) in enumerate(sorted(mb.ports.items())):
            events.append({"name": f"port {key}", "ph": "X", "pid": pid,
                           "tid": tid, "ts": 0.0, "dur": dur,
                           "args": {k: v for k, v in row.items()}})
        for tid, (key, counts) in enumerate(sorted(mb.ecmp.items()),
                                            start=len(mb.ports)):
            events.append({"name": f"ecmp {key}", "ph": "X", "pid": pid,
                           "tid": tid, "ts": 0.0, "dur": dur,
                           "args": {f"path{i}": int(c)
                                    for i, c in enumerate(counts)}})

    # ------------------------------------------------------------- devices
    pid = len(mb.hosts) + 2
    proc(pid, "devices")
    for d, name in enumerate(mb.devices):
        args = dict(mb.media[d]) if d < len(mb.media) else {}
        if d < len(mb.dev_hist):
            args.update(_pcts_args(mb.dev_hist[d]))
        events.append({"name": name, "ph": "X", "pid": pid, "tid": d,
                       "ts": 0.0, "dur": dur, "args": args})
    for i, f in enumerate(mb.flash):
        hw, gw = f["host_writes"], f["gc_writes"]
        args = dict(f)
        args["write_amplification"] = round((hw + gw) / hw, 6) if hw else 1.0
        events.append({"name": f"flash{i}", "ph": "X", "pid": pid,
                       "tid": len(mb.devices) + i, "ts": 0.0, "dur": dur,
                       "args": args})

    # -------------------------------------------------------------- faults
    if mb.faults is not None or down_windows:
        pid = len(mb.hosts) + 3
        proc(pid, "faults")
        tid = 1
        if mb.faults is not None:
            events.append({"name": "fault_counters", "ph": "X", "pid": pid,
                           "tid": 0, "ts": 0.0, "dur": dur,
                           "args": {k: int(v)
                                    for k, v in mb.faults.items()}})
            for k, v in sorted(mb.faults.items()):
                if not int(v):
                    continue
                events.append({"name": f"{k}={int(v)}", "ph": "i",
                               "pid": pid, "tid": tid, "ts": dur, "s": "p",
                               "args": {k: int(v)}})
                tid += 1
        # one track per (host, link): the window a down link was declared
        # over, mapped from access ordinals to ticks by the issue column
        tracks: Dict[str, int] = {}
        for span in down_windows or ():
            label = f"down {span['link']} @{span['host']}"
            t = tracks.setdefault(label, tid + len(tracks))
            ts = span["start_tick"] / _TICKS_PER_US
            events.append({
                "name": label, "ph": "X", "pid": pid, "tid": t, "ts": ts,
                "dur": max(span["end_tick"] / _TICKS_PER_US - ts,
                           1.0 / _TICKS_PER_US),
                "args": {k: (int(v) if not isinstance(v, str) else v)
                         for k, v in span.items()}})

    return {"traceEvents": events, "displayTimeUnit": "ns",
            "otherData": {
                # the JAX package's name, so the two packages' documents
                # of one run compare equal
                "generator": "repro.obs",
                "hosts": list(mb.hosts),
                "devices": list(mb.devices),
                "window_ticks": wt,
            }}


def write_perfetto(bundle_or_result, path: str,
                   indent: Optional[int] = None,
                   down_windows=None) -> str:
    """Serialize :func:`to_perfetto` output to ``path``; returns ``path``."""
    doc = to_perfetto(bundle_or_result, down_windows=down_windows)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=indent)
    return path
