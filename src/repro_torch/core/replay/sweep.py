"""Design-space sweeps over the fused replay: a batch of simulator
configurations against the same (or per-lane) traces, in one launch.

* :func:`cache_design_sweep` — batch over DRAM-cache **capacity**
  (disabled-frame masking inside a fixed frame array), **policy**
  (LRU/FIFO through the per-lane ``is_lru`` flag), and any **timing
  constant** (hit latency, link occupancy, flash timing, ...), on the
  full cached-CXL-SSD stack.  Each lane runs the same tick-exact step the
  single-config engine runs, so lane *k* equals a standalone
  :class:`~repro_torch.core.replay.engine.ReplayEngine` run with that
  config.
* :func:`host_count_sweep` — batch over **host count** on the fused
  multi-host replay: one lane per host count, the hosts a lane leaves
  out masked by zero-length traces.
* :func:`fault_seed_sweep` — batch over **fault-plan seed** on the fused
  multi-host replay under an active transport fault plan: only the
  per-access path ids and retry bytes differ across lanes (over one path
  table, the union of every seed's paths), so one launch yields the
  tail-latency-under-failure / availability distribution across seeds.

The JAX package vmaps its replay over the lanes; here the lanes are a
grid axis of the ``replay_scan`` kernel's sweep instances, one block a
lane, every lane in one launch (:func:`repro_torch.kernels.replay_scan.
replay_sweep`, :func:`~repro_torch.kernels.replay_scan.
replay_multi_sweep`).  With ``torch_device="cpu"`` their plain twins
replay the lanes one after another.  Every function returns numpy
arrays on the host, as :meth:`ReplayEngine.run_arrays` does, and keeps
the reference's refusals word for word.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.replay.metrics import availability_series
from repro_torch.core.replay.multihost import MultiHostReplay
from repro_torch.core.replay.spec import (  # noqa: F401  (DISABLED)
    DISABLED,
    MAX_ACCESSES,
    SSD_CACHE,
    ReplayUnsupported,
    build_stack,
)
from repro_torch.core.workloads.driver import MultiHostResult


def cache_lanes(device, addrs, writes, *, capacity_frames: Sequence[int],
                is_lru: Sequence[bool],
                timing_overrides: Optional[Dict[str, Sequence]] = None,
                outstanding: int = 32, issue_overhead_ns: float = 0.5,
                posted_writes: bool = True):
    """The stack and the lanes of :func:`cache_design_sweep`, after its
    refusals: ``(cfg, lanes)``, ``lanes[k]`` lane k's params dict (its
    ``cap``, ``is_lru`` and overridden constants; every other entry
    shared)."""
    addrs = np.asarray(addrs, np.int64)
    caps = np.asarray(capacity_frames, np.int64)
    lru = np.asarray(is_lru, bool)
    B = caps.size
    if lru.size != B:
        raise ValueError("capacity_frames and is_lru must share a length")
    if addrs.shape[-1] > MAX_ACCESSES:
        raise ReplayUnsupported(
            f"trace longer than {MAX_ACCESSES} accesses (packed-stamp "
            "budget); split the trace")
    cfg, params = build_stack(
        device, size=64, outstanding=outstanding,
        issue_overhead_ns=issue_overhead_ns, posted_writes=posted_writes,
        n_accesses=addrs.shape[-1], max_addr=int(addrs.max(initial=0)))
    if cfg.kind != SSD_CACHE:
        raise ReplayUnsupported("cache_design_sweep needs a cached CXL-SSD")
    if not cfg.cache_assoc:
        raise ReplayUnsupported(
            "the policy axis covers lru/fifo; sweep direct-mapped separately")
    if caps.max() > cfg.cache_frames or caps.min() < 1:
        raise ReplayUnsupported("capacity lane exceeds the device's frames")
    params["is_lru"] = lru
    params["cap"] = caps
    batched = {"is_lru", "cap"}
    for name, vals in (timing_overrides or {}).items():
        if name not in params:
            raise ValueError(f"unknown timing parameter {name!r}")
        vals = np.asarray(vals)
        if vals.shape[0] != B:
            raise ValueError(f"override {name!r} must have {B} lanes")
        params[name] = vals
        batched.add(name)
    if cfg.num_routes > 1:
        # no route column: the replay layer's fallback contract
        raise ReplayUnsupported(
            "ECMP stack needs a per-access route column; this entry point "
            "supports single-route mounts only (use engine='python')")
    if addrs.ndim == 2 and addrs.shape[0] != B:
        raise ValueError(f"per-lane traces must have {B} rows, got "
                         f"{addrs.shape[0]}")
    return cfg, [{k: (v[j] if k in batched else v)
                  for k, v in params.items()} for j in range(B)]


def cache_design_sweep(device, addrs, writes, *,
                       capacity_frames: Sequence[int],
                       is_lru: Sequence[bool],
                       timing_overrides: Optional[Dict[str, Sequence]] = None,
                       outstanding: int = 32,
                       issue_overhead_ns: float = 0.5,
                       posted_writes: bool = True,
                       torch_device="cuda") -> Dict[str, np.ndarray]:
    """Replay a trace under B cached-device configs in one launch.

    ``capacity_frames[k]`` / ``is_lru[k]`` / ``timing_overrides[name][k]``
    describe lane k; all sequences must share length B.  ``device`` provides
    the base config and must have ``capacity_pages >= max(capacity_frames)``.
    ``addrs``/``writes`` may be (N,) — shared by every lane — or (B, N) for
    per-lane traces.  Returns stacked per-lane arrays (``latency_ticks``,
    ``hit_flags`` of shape (B, N)) plus derived (B,) summaries.  The lanes
    run on ``torch_device``: the card by default (one launch), ``"cpu"``
    for the plain twin.
    """
    import torch

    from repro_torch import torch_device as _td
    from repro_torch.core.replay import stack
    from repro_torch.kernels.replay_scan import replay_sweep

    addrs = np.asarray(addrs, np.int64)
    writes = np.asarray(writes, bool)
    cfg, lanes = cache_lanes(
        device, addrs, writes, capacity_frames=capacity_frames,
        is_lru=is_lru, timing_overrides=timing_overrides,
        outstanding=outstanding, issue_overhead_ns=issue_overhead_ns,
        posted_writes=posted_writes)
    B = len(lanes)
    dev = _td.resolve(torch_device)
    state = stack.init_sweep(cfg, [int(p["cap"]) for p in lanes], dev)
    issues, dones, flags, _, _ = replay_sweep(
        cfg, lanes, state, torch.from_numpy(addrs).to(dev),
        torch.from_numpy(writes).to(dev))
    lat = (dones - issues).cpu().numpy()
    issues = issues.cpu().numpy()
    dones = dones.cpu().numpy()
    flags = flags.cpu().numpy()
    flash = state["flash"]
    if flash is not None and "bad" in flash:
        # certify-or-refuse, per lane: a lane whose FTL ran out of free
        # blocks during GC replayed past the point where the interpreted
        # path raises — its numbers must not escape
        bad_lanes = [k for k, b in enumerate(
            flash["bad"].cpu().numpy().reshape(B, -1)) if b.any()]
        if bad_lanes:
            raise ReplayUnsupported(
                f"sweep lane(s) {bad_lanes}: FTL ran out of free blocks "
                "during GC (device overfilled); use engine='python'")
    return {
        "latency_ticks": lat,
        "hit_flags": (flags & 1).astype(bool),
        "evict_flags": (flags & 2).astype(bool),
        "sum_latency_ticks": lat.sum(axis=1),
        "hit_rate": (flags & 1).mean(axis=1),
        "elapsed_ticks": dones.max(axis=1) - issues[:, 0],
    }


def _multi_lanes(prep, params: Dict, lane_lens: np.ndarray, routes,
                 retries, torch_device):
    """The multi-host lanes of ``prep`` under ``params`` (one row of
    ``lane_lens`` each, ``routes`` / ``retries`` shared or a row a lane)
    replayed in one sweep on ``torch_device``: ``(who, issues, dones)``
    (numpy, ``(B, S)``) and each lane's sticky FTL ``bad`` flag."""
    import torch

    from repro_torch import torch_device as _td
    from repro_torch.core.replay import stack
    from repro_torch.kernels.replay_scan import replay_multi_sweep

    cfg = prep.cfg
    dev = _td.resolve(torch_device)

    def on_dev(x):
        return None if x is None else torch.from_numpy(
            np.ascontiguousarray(x)).to(dev)

    B = lane_lens.shape[0]
    state = stack.init_multi_sweep(cfg.stack, B, cfg.num_devs, cfg.n_flash,
                                   dev)
    who, issues, dones, _, _, _ = replay_multi_sweep(
        cfg, params, state, on_dev(prep.addrs), on_dev(prep.writes),
        on_dev(np.asarray(lane_lens, np.int64)), on_dev(prep.devs),
        on_dev(routes), retries=on_dev(retries))
    flash = state["flash"]
    bad = np.zeros(B, bool)
    if flash is not None and "bad" in flash:
        bad = flash["bad"].cpu().numpy().reshape(B, -1).any(1)
    return (who.cpu().numpy(), issues.cpu().numpy(), dones.cpu().numpy(),
            bad)


def host_count_sweep(targets: Sequence, traces: Sequence,
                     host_counts: Sequence[int],
                     outstanding: int = 32,
                     issue_overhead_ns: float = 0.5,
                     posted_writes: bool = True,
                     sharded: bool = False,
                     devices: Optional[Sequence] = None,
                     info: Optional[Dict] = None,
                     torch_device="cuda") -> List[MultiHostResult]:
    """Replay the same multi-host scenario at several host counts in ONE
    launch.

    ``targets``/``traces`` describe the largest configuration; lane k keeps
    the first ``host_counts[k]`` hosts and masks the rest out with
    zero-length traces (an absent host issues nothing, so the shared-port
    and media contention it would have caused never happens — identical to
    running the smaller scenario).  Lane k is tick-identical to
    ``MultiHostReplay(targets[:k]).run(traces[:k])`` over the *same shared
    fabric*.  Any stack-layer media works, cached CXL-SSD included — absent
    hosts leave their private cache lanes (and the shared flash) untouched.

    ``sharded=True`` runs each host count through
    :class:`~repro_torch.core.replay.shard.ShardedMultiHostReplay` with
    ``devices`` bounding its shards: one launch a host count of the
    kernel's sharded instance, the masked lengths its only difference.
    Pass a dict as ``info`` to receive the execution report
    (``{"sharded", "device_count", "hosts_per_device"}``).  The lanes run
    on ``torch_device``: the card by default (one launch), ``"cpu"`` for
    the plain twins.
    """
    if sharded:
        from repro_torch.core.replay.shard import ShardedMultiHostReplay

        eng = ShardedMultiHostReplay(targets, outstanding=outstanding,
                                     issue_overhead_ns=issue_overhead_ns,
                                     posted_writes=posted_writes,
                                     devices=devices,
                                     torch_device=torch_device)
        prep = eng.prepare(traces)
        out: List[MultiHostResult] = []
        for h in host_counts:
            lane = np.where(np.arange(prep.lens.size) < h, prep.lens, 0)
            who, issues, dones, bad = eng.replay_lens(prep, lane)
            if int(lane.sum()) and bad:
                raise ReplayUnsupported(
                    f"host-count lane {h}: FTL ran out of free blocks "
                    "during GC; use engine='python'")
            out.append(eng.aggregate(who, issues, dones, lane, prep.size))
        if info is not None:
            info.update(dict(eng.last_mesh, sharded=True))
        return out
    eng = MultiHostReplay(targets, outstanding=outstanding,
                          issue_overhead_ns=issue_overhead_ns,
                          posted_writes=posted_writes,
                          torch_device=torch_device)
    prep = eng.prepare(traces)
    lens = prep.lens
    if info is not None:
        info.update({"sharded": False, "device_count": 1,
                     "hosts_per_device": int(lens.size)})
    lane_lens = np.stack([
        np.where(np.arange(lens.size) < h, lens, 0) for h in host_counts])
    who, issues, dones, bad = _multi_lanes(prep, prep.params, lane_lens,
                                           prep.routes, prep.retries,
                                           torch_device)
    for k in range(len(host_counts)):
        total = int(lane_lens[k].sum())
        if total and bool(bad[k]):
            raise ReplayUnsupported(
                f"host-count lane {host_counts[k]}: FTL ran out of free "
                "blocks during GC; use engine='python'")
    return [eng.aggregate(who[k], issues[k], dones[k], lane_lens[k],
                          prep.size)
            for k in range(len(host_counts))]


_PATH_KEYS = ("path_port", "path_occ", "path_after", "path_dev")


def _union_paths(tables: Sequence[Dict]):
    """One path table over every lane's (``path_port``, ``path_occ``,
    ``path_after``, ``path_dev`` each): the distinct paths in first-seen
    order, and each lane's map from its path ids to the union's."""
    rows: Dict[tuple, int] = {}
    remaps = []
    for t in tables:
        cols = [np.asarray(t[k]) for k in _PATH_KEYS]
        ids = []
        for r in range(cols[0].shape[0]):
            key = tuple(tuple(np.ravel(c[r]).tolist()) for c in cols)
            ids.append(rows.setdefault(key, len(rows)))
        remaps.append(np.asarray(ids, np.int32))
    union = {}
    for i, k in enumerate(_PATH_KEYS):
        dtype = np.asarray(tables[0][k]).dtype
        union[k] = np.asarray([key[i] if k != "path_dev" else key[i][0]
                               for key in rows], dtype)
    return union, remaps


@dataclass
class FaultLanes:
    """The lanes of :func:`fault_seed_sweep`, on the host: the first
    seed's prepared inputs (``prep``), the params with
    the union path table (``params``), each lane's path ids into it and
    retry bytes (``routes`` ``(B, H, L)``, ``retries`` ``(B, H, L,
    hops)``), its ``(degraded, failover)`` flags and fault counters, and
    the fault-column builders' host seconds over every seed."""

    prep: object
    params: Dict
    routes: np.ndarray
    retries: np.ndarray
    flags: List
    stats: List[Dict]
    column_seconds: float


def fault_lanes(make_targets, traces: Sequence, seeds: Sequence[int], *,
                outstanding: int = 32, issue_overhead_ns: float = 0.5,
                posted_writes: bool = True,
                torch_device="cuda") -> FaultLanes:
    """The lanes of :func:`fault_seed_sweep`, after its refusals: every
    seed prepared (its transport-fault code built on the host), one path
    table over every seed's paths and each seed's path ids mapped into
    it, so that every lane shares one layout."""
    prep0 = None
    routes, retries, tables = [], [], []
    flags, stats = [], []
    column_s = 0.0
    for s in seeds:
        eng = MultiHostReplay(make_targets(s), outstanding=outstanding,
                              issue_overhead_ns=issue_overhead_ns,
                              posted_writes=posted_writes,
                              torch_device=torch_device)
        prep = eng.prepare(traces)
        column_s += eng.last_column_seconds
        if not prep.cfg.fault_hops:
            raise ReplayUnsupported(
                "fault_seed_sweep needs an active transport fault plan "
                "(link-retry and/or down-window classes) installed on the "
                "shared fabric; for fault-free host scaling use "
                "host_count_sweep")
        if prep0 is None:
            prep0 = prep
        elif prep.cfg != prep0.cfg:
            raise ReplayUnsupported(
                "fault seeds changed the compiled shape — down windows "
                "(and the hop/port geometry they induce) must come from "
                "the shared FaultConfig, not the per-lane seed")
        routes.append(prep.routes)
        retries.append(prep.retries)
        tables.append({k: prep.params[k] for k in _PATH_KEYS})
        flags.append(eng.fault_flags)
        stats.append(eng.fault_stats)
    union, remaps = _union_paths(tables)
    return FaultLanes(prep0, {**prep0.params, **union},
                      np.stack([m[r] for m, r in zip(remaps, routes)]),
                      np.stack(retries), flags, stats, column_s)


def fault_seed_sweep(make_targets, traces: Sequence, seeds: Sequence[int],
                     *, outstanding: int = 32,
                     issue_overhead_ns: float = 0.5,
                     posted_writes: bool = True,
                     window_ticks: Optional[int] = None,
                     num_windows: int = 32,
                     torch_device="cuda",
                     info: Optional[Dict] = None) -> List[Dict]:
    """Replay one multi-host scenario under B transport-fault seeds in ONE
    launch — the fleet-scale availability sweep.

    ``make_targets(seed)`` builds fresh fabric-mounted targets with a
    ``FaultPlan(cfg, seed=seed)`` installed; every seed must share the
    FaultConfig (down windows and the derived hop/port shapes are config
    properties — a seed that changed them could not share the lanes'
    shape, and the sweep refuses).  Only the per-access path ids and retry
    bytes differ across lanes (over one table of every seed's paths).

    Lane k is tick-identical to
    ``MultiHostReplay(make_targets(seeds[k])).run(traces)`` (and hence to
    the interpreted ``MultiHostDriver``).  Each returned dict carries the
    per-seed ``result`` (:class:`MultiHostResult`), pooled
    ``latency_ticks`` (valid accesses, host by host in issue order),
    ``availability`` (:func:`~repro_torch.core.replay.metrics.
    availability_series` over the pooled per-access degraded/failover
    flags) and the ``fault_stats`` counter dict.  With
    ``window_ticks=None`` the window width is derived from the batch (max
    completion tick over all lanes / ``num_windows``) so every lane's
    availability curve shares one axis.  The lanes run on
    ``torch_device``: the card by default (one launch), ``"cpu"`` for the
    plain twin.  Pass a dict as ``info`` to receive the host seconds of
    the seeds' fault-column builds (``{"column_seconds"}``).
    """
    fl = fault_lanes(make_targets, traces, seeds, outstanding=outstanding,
                     issue_overhead_ns=issue_overhead_ns,
                     posted_writes=posted_writes, torch_device=torch_device)
    if info is not None:
        info["column_seconds"] = fl.column_seconds
    flags, stats, lens = fl.flags, fl.stats, np.asarray(fl.prep.lens)
    who, issues, dones, bad = _multi_lanes(
        fl.prep, fl.params, np.tile(lens, (len(seeds), 1)), fl.routes,
        fl.retries, torch_device)
    total = int(lens.sum())
    valid = np.arange(who.shape[1]) < total
    if window_ticks is None:
        max_end = int(dones[:, valid].max(initial=0)) if total else 1
        window_ticks = max(1, -(-max_end // num_windows))
    out: List[Dict] = []
    for k, s in enumerate(seeds):
        if total and bool(bad[k]):
            raise ReplayUnsupported(
                f"fault seed lane {s}: FTL ran out of free blocks during "
                "GC (device overfilled); use engine='python'")
        res = MultiHostReplay.aggregate(who[k], issues[k], dones[k],
                                        lens, fl.prep.size)
        deg, fo = flags[k]
        iss_h, dn_h, deg_h, fo_h = [], [], [], []
        for i in range(lens.size):
            m = valid & (who[k] == i)
            iss_h.append(issues[k][m])
            dn_h.append(dones[k][m])
            deg_h.append(deg[i, :lens[i]])
            fo_h.append(fo[i, :lens[i]])
        iss = np.concatenate(iss_h)
        dn = np.concatenate(dn_h)
        av = availability_series(iss, dn, np.concatenate(deg_h),
                                 np.concatenate(fo_h),
                                 window_ticks=window_ticks,
                                 num_windows=num_windows)
        out.append({"seed": int(s), "result": res,
                    "latency_ticks": dn - iss,
                    "availability": av, "fault_stats": stats[k]})
    return out
