"""The scan lane's stack replay, as a CUDA kernel for Hopper beside its
plain PyTorch twin.

:func:`replay_scan` replays a trace through one device stack (LFB issue,
port busy-until transport, the media, the flash backend with greedy GC)
and returns per-access ``(issues, dones, flags)`` plus the per-port
queueing and QoS-throttle totals, updating the stack state in place.  It
is tick-identical to the JAX package's ``ReplayEngine`` scan (its
``_scan_chunk`` over ``stack.step``), its faulted lane included: NAND
read retries and erase-fail retirement from the stack's fault statics,
and link CRC retries and down-port failover from a path table and a
per-access path id and retry bytes.  For CUDA tensors it launches
``csrc/replay_scan.cu`` once for the whole trace; for CPU tensors it runs
:func:`replay_scan_plain`, the loop of ``_scan_chunk`` over
:func:`repro_torch.core.replay.stack.step`.  Nothing falls back from one
to the other.

:func:`replay_multi` is the same for the JAX package's multi-host replay
(``multihost.py``'s ``_make_multi_step``): several hosts' traces
interleaved in issue order over shared ports and lane-stacked media and
flash state, one launch of the kernel's multi-host instance, or on the
CPU :func:`replay_multi_plain`.

Both replays are resumable: given a :class:`Carry` (:func:`new_carry`,
:func:`new_multi_carry`) a call continues the replay the carry and the
state tensors hold, so a trace replayed chunk by chunk, one launch a
chunk, equals its one-call replay output for output; the twins take the
same carry.

:func:`replay_sweep` and :func:`replay_multi_sweep` replay a batch of
configurations (the JAX package's ``sweep.py`` lanes) in one launch of
the kernel's sweep instances, one block a lane, each lane equal to its
own one-launch replay; on the CPU their twins
(:func:`replay_sweep_plain`, :func:`replay_multi_sweep_plain`) replay
the lanes one after another.

The ``LAUNCHES`` counter counts kernel launches only (one a sweep), so a
run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.replay import stack
from repro_torch.core.replay.metrics import FLAG_EVENT_BITS
from repro_torch.core.replay.shard import MAX_SHARDS
from repro_torch.core.replay.spec import (
    DRAM,
    MAX_ACCESSES,
    PMEM,
    SSD_BUF,
    SSD_CACHE,
    StackConfig,
)

LAUNCHES = {"replay_scan": 0}
KINDS = (DRAM, PMEM, SSD_BUF, SSD_CACHE)
# the kernel's argument block (`enum Arg` in csrc/replay_scan.cu, field for
# field): the StackConfig statics, the trace's length and start tick, and
# the int64 tick constants of the params dict
ARGS = ("kind", "n", "start_tick", "outstanding", "posted_writes",
        "num_hops", "num_ports", "num_routes", "page_bytes", "cache_frames",
        "cache_assoc", "mshr_entries", "wb_slots", "channels",
        "dies_per_channel", "pages_per_block", "buf_entries", "gc",
        "num_blocks", "gc_watermark_blocks", "num_pages",
        "issue_ov", "rt_extra", "occ", "load", "pack", "row_bytes",
        "lat_read_miss", "lat_read_hit", "lat_write_miss", "lat_write_hit",
        "hil_ov", "xfer_page", "read_t", "prog_t", "sus_t", "erase_t",
        "internal", "hit_lat", "line_xfer", "page_xfer", "pack10", "is_lru",
        "cap", "fault_hops", "paths", "nand", "rd_key", "rd_thresh",
        "rd_max", "er_key", "er_thresh")
# the kernel's layout (`enum Lay`): the chunk's accesses, the LFB tree's
# leaves, then byte offsets into shared memory; a placed array (`where`
# and after) at an offset < 0 lives in device memory
LAYOUT = ("chunk", "leaves", "in_key", "in_aux", "in_set", "in_rt",
          "out_issue", "out_done", "out_flags", "tree", "pb", "qacc",
          "qthr", "vft", "tables", "mpage", "mready", "wtick", "die_busy",
          "die_prog", "chan_busy", "where", "frames", "links", "l2p",
          "valid", "free_mask", "free_q", "p2l", "retired")
PLACED = LAYOUT[LAYOUT.index("where"):]
# the state's scalars, in and out of the kernel (`enum Scalar`)
SCALARS = ("busy", "row", "dram_busy", "wpb", "wpp", "nfree", "fq_head",
           "fq_count", "gcs", "bad", "c_hr", "c_hw", "c_gw", "c_ge",
           "rd_seq", "er_seq", "c_rr", "c_rb")
MEDIA_ARRAYS = ("frames", "mpage", "mready", "wtick")
FLASH_ARRAYS = ("l2p", "p2l", "valid", "free_q", "free_mask", "rtr_mask",
                "die_busy", "die_prog", "chan_busy")
# placed arrays that live in the scratch tensor when shared memory does
# not hold them (the state has none of them: a map, links, a bitmap)
SCRATCH = ("where", "links", "retired")
MAX_OUTSTANDING = 4096      # LFB slots of the kernel's tournament tree
CHUNK = 256                 # accesses a staged chunk
# the multi-host instance's own argument block (`enum MArg`): hosts, media
# lanes, flash lanes, the trace columns' row stride, QoS on, route or path
# table rows, and the QoS activity window in serialization quanta (a
# sharded replay's hosts, lanes and rows are a shard's)
MARGS = ("hosts", "lanes", "flash_lanes", "stride", "qos", "rows", "window")
# its layout (`enum LayM`): the trees' leaves, then byte offsets into
# shared memory (a sharded replay's election region follows its hosts'
# arrays in `host`); placed arrays as in LAYOUT, every lane's or none
LAYOUT_MULTI = ("leaves", "tree", "host", "next", "pb", "qacc", "qthr",
                "vft", "last", "mtab", "mscal", "fscal", "mpage", "mready",
                "wtick", "die_busy", "die_prog", "chan_busy") + PLACED
# a sharded replay's clusters (`kMaxHops`, `kElect` in the kernel): the
# hops of a row a CTA loads at once (into a row buffer beside the two
# election slots) and an election slot's words
MAX_SHARD_HOPS = 8
ELECT_WORDS = 4
MEDIA_SCALARS = 8           # a media lane's scalars in shared memory
# the carry of a resumable replay (`enum Carry`): its header words, then
# the LFB slots (K) and, a port each, busy-until, queueing and throttle
# totals and QoS virtual clock (4 x ports)
CARRY = ("seen", "now", "fill", "head", "tail")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def num_paths(cfg: StackConfig, params: Dict) -> int:
    """Rows of the route tables: the paths of a faulted stack's path
    table, the ECMP routes, or 1 on a fixed route."""
    if cfg.fault_hops:
        return int(np.asarray(params["hop_port"]).shape[0])
    return cfg.num_routes


def _check(cfg: StackConfig, state: Dict, addrs: torch.Tensor,
           writes: torch.Tensor, routes: Optional[torch.Tensor],
           retries: Optional[torch.Tensor],
           carry: Optional[Carry] = None) -> None:
    n = addrs.shape[0] if addrs.dim() == 1 else -1
    if addrs.dtype != torch.int64 or addrs.dim() != 1 or n < 1:
        raise ValueError(f"addrs must be a non-empty (N,) int64 tensor, got "
                         f"{addrs.dtype} {tuple(addrs.shape)}")
    seen = carry.seen if carry is not None else 0
    if seen + n > MAX_ACCESSES:
        raise ValueError(f"{seen} + {n} accesses exceed the packed stamp's "
                         f"{MAX_ACCESSES}")
    if carry is not None and (
            tuple(carry.words.shape) != (len(CARRY) + cfg.outstanding
                                         + 4 * cfg.num_ports,)
            or carry.words.device != addrs.device
            or carry.maps.device != addrs.device):
        raise ValueError("the carry is not this stack's (new_carry) or lies "
                         "on another device")
    if writes.dtype != torch.bool or tuple(writes.shape) != (n,):
        raise ValueError(f"writes must be a ({n},) bool tensor, got "
                         f"{writes.dtype} {tuple(writes.shape)}")
    if (cfg.num_routes > 1 or cfg.fault_hops) != (routes is not None):
        raise ValueError("a per-access route column goes with an ECMP stack "
                         "(num_routes > 1) or a faulted one (fault_hops), "
                         "and only with one")
    if cfg.fault_hops != (retries is not None):
        raise ValueError("per-access retry bytes go with a faulted stack "
                         "(fault_hops) and only with one")
    tensors = [writes] + [x for x in (routes, retries) if x is not None]
    for part in ("media", "flash"):
        tensors += list((state[part] or {}).values())
    for x in tensors:
        if x.device != addrs.device:
            raise ValueError(f"tensors on {x.device} and {addrs.device}")
    if routes is not None and (routes.dtype != torch.int32
                               or tuple(routes.shape) != (n,)):
        raise ValueError(f"routes must be a ({n},) int32 tensor")
    if retries is not None and (retries.dtype != torch.uint8 or tuple(
            retries.shape) != (n, cfg.num_hops)):
        raise ValueError(f"retries must be a ({n}, {cfg.num_hops}) uint8 "
                         "tensor")


def _check_values(cfg: StackConfig, params: Dict, state: Dict,
                  addrs: torch.Tensor, routes: Optional[torch.Tensor],
                  retries: Optional[torch.Tensor],
                  resumed: bool = False) -> None:
    """The checks that read the tensors (one read from their device): the
    kernel indexes its page map and l2p by the page, and its route tables
    by the route or path, unchecked, charges the retry bytes of a path's
    hops only, and takes a fresh cache only, unless it resumes a carry
    (``resumed``)."""
    top = cfg.num_pages * cfg.page_bytes if stack.has_flash(cfg) else None
    rows = num_paths(cfg, params)
    checks = {"addresses": addrs.min() < 0}
    if top is not None:
        checks["addresses"] |= addrs.max() >= top
    if routes is not None:
        checks["routes"] = (routes.min() < 0) | (routes.max() >= rows)
    if retries is not None:
        # a retry byte on a hop that the access's path does not have
        off = torch.from_numpy(np.asarray(params["hop_port"]) < 0).to(
            routes.device)[routes.clamp(0, rows - 1).long()]
        checks["retries"] = (off & (retries != 0)).any()
    if fully_associative(cfg) and not resumed:
        checks["frames"] = (state["media"]["frames"] != stack.FREE).any()
    failed = dict(zip(checks, torch.stack(list(checks.values())).tolist()))
    if failed["addresses"]:
        raise ValueError("addresses must be >= 0" + (
            "" if top is None else f" and below {top} ({cfg.num_pages} pages, "
            "as build_stack sizes l2p)"))
    if failed.get("routes"):
        raise ValueError(f"routes must lie in [0, {rows})")
    if failed.get("retries"):
        raise ValueError("retry bytes must be 0 on the hops an access's "
                         "path does not have (hop_port -1)")
    if failed.get("frames"):
        raise ValueError(
            "replay_scan starts from a fresh cache: every frame free (-1), "
            "as stack.init_state makes it, unless it resumes a carry; its "
            "stamp counter starts at 1, so the kernel's victim order equals "
            "the reference's only then")


def fully_associative(cfg: StackConfig) -> bool:
    """Whether the stack's frames are fully associative (the CXL-SSD's
    page registers, an LRU or FIFO cache): the kernel keeps a page map and
    a victim order beside them."""
    return cfg.kind == SSD_BUF or (cfg.kind == SSD_CACHE and cfg.cache_assoc)


def _has_links(cfg: StackConfig, params: Dict) -> bool:
    """Whether the frames keep a recency list (a page-register buffer,
    an LRU cache)."""
    return fully_associative(cfg) and (
        cfg.kind == SSD_BUF or bool(np.asarray(params["is_lru"])))


# ------------------------------------------------------------ the carry
@dataclass
class Carry:
    """The state a resumable replay carries from one launch to the next
    besides the stack state: ``words`` (int64, :data:`CARRY` then the LFB
    slots and the ports, or :func:`multi_carry_words` for the multi-host
    replay), the home of the frames' page map and recency links
    (``maps``, bytes: every lane's int32 map, then at the next 16 bytes
    every lane's links as int32 pairs), and ``seen``, the accesses (steps)
    replayed so far, which ``words[0]`` holds on the tensors' device."""

    words: torch.Tensor
    maps: torch.Tensor
    seen: int = 0

    def leaves(self) -> Dict[str, np.ndarray]:
        """The carry as host arrays (a checkpoint's leaves)."""
        return {"words": self.words.cpu().numpy(),
                "maps": self.maps.cpu().numpy()}

    def load(self, leaves: Dict[str, np.ndarray]) -> None:
        """Take ``leaves`` (from :meth:`leaves`) into this carry's
        tensors, after the shape checks of the caller."""
        self.words.copy_(torch.from_numpy(np.asarray(leaves["words"])))
        self.maps.copy_(torch.from_numpy(np.asarray(leaves["maps"])))
        self.seen = int(np.asarray(leaves["words"])[0])


def carry_ports(cfg: StackConfig, carry: Carry):
    """A single-host carry's per-port queueing and QoS-throttle totals
    (int64 numpy each), as the last launch returned them."""
    K, P = len(CARRY) + cfg.outstanding, cfg.num_ports
    w = carry.words[K + P:K + 3 * P].cpu().numpy()
    return w[:P].copy(), w[P:].copy()


def _maps_bytes(cfg: StackConfig, params: Dict, lanes: int = 1) -> int:
    if not fully_associative(cfg):
        return 16
    frames = cfg.buf_entries if cfg.kind == SSD_BUF else cfg.cache_frames
    where = -(-4 * lanes * cfg.num_pages // 16) * 16
    return where + (8 * lanes * frames if _has_links(cfg, params) else 0)


def new_carry(cfg: StackConfig, params: Dict, device,
              start_tick: int = 0) -> Carry:
    """A fresh carry of a single-host replay from ``start_tick`` on
    ``device``: nothing replayed, every slot at ``start_tick``, the ports
    idle, the map empty."""
    K, P = cfg.outstanding, cfg.num_ports
    w = np.zeros(len(CARRY) + K + 4 * P, np.int64)
    w[1] = start_tick
    w[3] = w[4] = -1
    w[len(CARRY):len(CARRY) + K] = start_tick
    return Carry(torch.from_numpy(w).to(device),
                 torch.full((_maps_bytes(cfg, params),), 255,
                            dtype=torch.uint8, device=device))


def victim_order(cfg: StackConfig, params: Dict, frames: np.ndarray):
    """The kernel's victim order of packed ``frames`` (a fresh cache's,
    after any replay): ``(fill, head, tail, where, links)``, the fill
    pointer, the recency list's head and tail, the page map (int32, a
    page each) and the links (int32 pairs, a frame each; -1 past the
    filled frames).  Frames fill in order, the list runs by stamp (an LRU
    touch restamps) and a FIFO's next victim holds the oldest stamp."""
    if not fully_associative(cfg):
        return 0, -1, -1, None, None
    # a cache's order runs over its first `cap` frames (a capacity lane
    # of a sweep disables the rest)
    nf = (int(np.asarray(params["cap"])) if cfg.kind == SSD_CACHE
          else frames.size)
    valid = frames[:nf] >= 0
    filled = int(valid.sum())
    where = np.full(cfg.num_pages, -1, np.int32)
    links = np.full((frames.size, 2), -1, np.int32)
    idx = np.flatnonzero(valid)
    where[(frames[idx] & stack.PAGE_FIELD) >> 1] = idx
    order = idx[np.argsort(frames[idx] >> stack.STAMP_SHIFT, kind="stable")]
    if not _has_links(cfg, params):
        fill = filled if filled < nf else nf + int(order[0])
        return fill, -1, -1, where, links
    if order.size:
        links[order[1:], 0] = order[:-1]
        links[order[:-1], 1] = order[1:]
        return filled, int(order[0]), int(order[-1]), where, links
    return filled, -1, -1, where, links


def _pack_maps(cfg: StackConfig, params: Dict, parts) -> np.ndarray:
    """``maps`` bytes of the lanes' ``(where, links)``."""
    out = np.full(_maps_bytes(cfg, params, len(parts)), 255, np.uint8)
    if not fully_associative(cfg):
        return out
    where = np.concatenate([w for w, _ in parts]).view(np.uint8)
    out[:where.size] = where
    if _has_links(cfg, params):
        at = -(-where.size // 16) * 16
        links = np.concatenate([lk for _, lk in parts]).reshape(-1)
        out[at:at + 4 * links.size] = links.view(np.uint8)
    return out


def replay_scan(cfg: StackConfig, params: Dict, state: Dict,
                addrs: torch.Tensor, writes: torch.Tensor,
                routes: Optional[torch.Tensor] = None, *,
                start_tick: int = 0, retries: Optional[torch.Tensor] = None,
                carry: Optional[Carry] = None):
    """Replay ``addrs`` / ``writes`` (``(N,)`` int64 / bool) through the
    stack ``cfg`` / ``params`` from ``state``
    (:func:`repro_torch.core.replay.stack.init_state` on the trace's
    device), which ends as the final state.  ``routes`` is the per-access
    ECMP choice (int32) of a stack with ``num_routes > 1``.  A faulted
    stack (``cfg.fault_hops``) takes its path table in ``params``
    (``hop_port``, -1 on a hop the path does not have, ``hop_occ`` and
    ``hop_after``, paths x hops), the access's path id in ``routes`` and
    its CRC retries a hop in ``retries`` (``(N, num_hops)`` uint8): hop
    *h* then occupies its port for ``occ * (1 + retries[h])`` ticks, and a
    weighted port's virtual clock advances by ``occ``.

    ``carry`` (a :func:`new_carry`) makes the replay resumable: the
    accesses continue a replay of ``carry.seen`` accesses whose state and
    carry this call takes and updates, so a trace replayed chunk by chunk
    through one carry equals its one-call replay, output for output.

    Returns ``(issues, dones, flags, qacc, qthr)``: int64 issue and
    completion ticks and int32 flags per access (bit 0 hit, bit 1 dirty
    evict, then the kind's :data:`FLAG_EVENT_BITS`), and the int64
    queueing ticks and QoS throttle events of each port (since the
    carry's start).

    Raises ``ValueError`` on addresses below 0 or past the stack's
    ``num_pages``, on routes outside the route tables, on retry bytes of
    hops a path does not have, on more than ``MAX_ACCESSES`` accesses
    (the carry's included), and, without a carry to resume, on the frames
    of a page-register buffer or a fully associative cache that are not
    all free: the kernel's victim order starts from a fresh cache."""
    _check(cfg, state, addrs, writes, routes, retries, carry)
    if addrs.device.type == "cpu":
        _check_values(cfg, params, state, addrs, routes, retries,
                      resumed=carry is not None and carry.seen > 0)
        return replay_scan_plain(cfg, params, state, addrs, writes, routes,
                                 start_tick=start_tick, retries=retries,
                                 carry=carry)
    return _launch(cfg, params, state, addrs, writes, routes, retries,
                   start_tick, carry)


def host_params(params: Dict) -> Dict:
    """The params dict with numpy scalars as Python ints and arrays as
    nested lists of ints, for the plain twin's integer arithmetic."""
    out = {}
    for k, v in params.items():
        a = np.asarray(v)
        out[k] = a.tolist() if a.ndim else int(a)
    return out


def replay_scan_plain(cfg: StackConfig, params: Dict, state: Dict,
                      addrs: torch.Tensor, writes: torch.Tensor,
                      routes: Optional[torch.Tensor] = None, *,
                      start_tick: int = 0,
                      retries: Optional[torch.Tensor] = None,
                      carry: Optional[Carry] = None):
    """Plain version of :func:`replay_scan`: the JAX package's
    ``_scan_chunk`` step (LFB slot recycle, then ``_transport``,
    ``_transport_ecmp`` or the faulted ``_transport_cols`` with the qacc /
    qthr totals) one access per loop step over
    :func:`repro_torch.core.replay.stack.step`, from ``carry`` when it
    resumes one (the kernel's victim order, which the loop does not keep,
    comes from the final frames: :func:`victim_order`).  Runs on any
    device's tensors; the card's main path launches the kernel
    instead."""
    p = host_params(params)
    a, w = addrs.tolist(), writes.tolist()
    r = routes.tolist() if routes is not None else None
    rt = retries.tolist() if retries is not None else None
    routed = cfg.num_routes > 1 or cfg.fault_hops
    qos = set(cfg.qos_ports)
    bits = FLAG_EVENT_BITS[cfg.kind]
    K, P = cfg.outstanding, cfg.num_ports
    slots = [start_tick] * K                         # LFB slots
    pb = [0] * P                                     # port busy-until
    vft = [0] * P                                    # QoS virtual finish
    qacc = [0] * P
    qthr = [0] * P
    now = start_tick
    seen = carry.seen if carry is not None else 0
    if seen:
        words = carry.words.tolist()
        now = words[1]
        c = words[len(CARRY):]
        slots, pb, qacc, qthr, vft = (c[:K], c[K:K + P], c[K + P:K + 2 * P],
                                      c[K + 2 * P:K + 3 * P],
                                      c[K + 3 * P:K + 4 * P])
    issues, dones, flags = [], [], []
    for i in range(len(a)):
        k = min(range(len(slots)), key=slots.__getitem__)   # lowest on ties
        issue = max(now, slots[k])
        t = issue
        for h in range(cfg.num_hops):
            if routed:
                pi = p["hop_port"][r[i]][h]
                occ, after = p["hop_occ"][r[i]][h], p["hop_after"][r[i]][h]
            else:
                pi, occ, after = h, p["hop_occ"][h], p["hop_after"][h]
            if pi < 0:                   # a hop this path does not have
                continue
            if cfg.fault_hops:
                # retries stretch the serialization, never the origin's
                # entitlement: the virtual clock moves by the clean occ
                if pi in qos:
                    qthr[pi] += vft[pi] > t
                    vft[pi] = max(vft[pi], t) + occ
                occ *= 1 + rt[i][h]
            elif pi in qos and pb[pi] > t:
                qthr[pi] += 1
            start = max(t, pb[pi])
            qacc[pi] += start - t
            pb[pi] = start + occ
            t = pb[pi] + after
        t += p["rt_extra"]
        out = stack.step(cfg, p, state, dict(
            t=t, addr=a[i], write=w[i], posted=w[i] and cfg.posted_writes,
            ctr=seen + i + 1))
        f = int(out["hit"]) | int(out["evict"]) << 1
        for bit, key in bits:
            f |= int(out[key]) << bit
        issues.append(issue)
        dones.append(out["done"])
        flags.append(f)
        slots[k] = out["done"]
        now = issue + p["issue_ov"]
    dev = addrs.device

    def i64(x):
        return torch.tensor(x, dtype=torch.int64, device=dev)

    if carry is not None:
        frames = (state["media"]["frames"].cpu().numpy()
                  if "frames" in state["media"] else np.zeros(0, np.int64))
        fill, head, tail, where, links = victim_order(cfg, params, frames)
        carry.words.copy_(i64([seen + len(a), now, fill, head, tail] + slots
                              + pb + qacc + qthr + vft))
        carry.maps.copy_(torch.from_numpy(
            _pack_maps(cfg, params, [(where, links)])))
        carry.seen = seen + len(a)
    return (i64(issues), i64(dones),
            torch.tensor(flags, dtype=torch.int32, device=dev),
            i64(qacc), i64(qthr))


# ------------------------------------------------------------ the launch
def arg_block(cfg: StackConfig, params: Dict, n: int,
              start_tick: int) -> np.ndarray:
    """The kernel's argument block (:data:`ARGS`), int64."""
    from repro_torch.core.faults.plan import (SALT_NAND_ERASE,
                                              SALT_NAND_READ, folded_key)
    from repro_torch.core.u64 import const

    p = host_params(params)
    lat = p.get("lat", [[0, 0], [0, 0]])
    nand = {}
    if cfg.faults:
        # the NAND decision hashes' seed-side mixes, folded here: the
        # kernel xors the sequence number in and runs the last mix
        seed, rd_thresh, rd_max, er_thresh = cfg.faults
        nand = dict(nand=1, rd_key=const(folded_key(seed, SALT_NAND_READ)),
                    rd_thresh=rd_thresh, rd_max=rd_max,
                    er_key=const(folded_key(seed, SALT_NAND_ERASE)),
                    er_thresh=er_thresh)
    vals = dict(
        kind=KINDS.index(cfg.kind), n=n, start_tick=start_tick,
        fault_hops=int(cfg.fault_hops), paths=num_paths(cfg, params), **nand,
        **{f: int(getattr(cfg, f)) for f in (
            "outstanding", "posted_writes", "num_hops", "num_ports",
            "num_routes", "page_bytes", "cache_frames", "cache_assoc",
            "mshr_entries", "wb_slots", "channels", "dies_per_channel",
            "pages_per_block", "buf_entries", "gc", "num_blocks",
            "gc_watermark_blocks", "num_pages")},
        lat_read_miss=lat[0][0], lat_read_hit=lat[0][1],
        lat_write_miss=lat[1][0], lat_write_hit=lat[1][1])
    for k in ARGS:
        if k not in vals:
            vals[k] = int(p.get(k, 0))
    return np.asarray([vals[k] for k in ARGS], np.int64)


def route_tables(cfg: StackConfig, params: Dict) -> np.ndarray:
    """``hop_port``, ``hop_occ`` and ``hop_after`` (routes or paths x hops
    each; on a fixed route hop h is port h; on a path, port -1 is a hop it
    does not have), then the per-port QoS mask, as one int64 array."""
    H, K = cfg.num_hops, num_paths(cfg, params)
    if K > 1 or cfg.fault_hops:
        port = np.asarray(params["hop_port"], np.int64).reshape(K, H)
        occ = np.asarray(params["hop_occ"], np.int64).reshape(K, H)
        after = np.asarray(params["hop_after"], np.int64).reshape(K, H)
    else:
        port = np.arange(H, dtype=np.int64)
        occ = np.asarray(params["hop_occ"], np.int64).reshape(H)
        after = np.asarray(params["hop_after"], np.int64).reshape(H)
    qos = np.zeros(cfg.num_ports, np.int64)
    qos[list(cfg.qos_ports)] = 1
    return np.concatenate([port.ravel(), occ.ravel(), after.ravel(), qos])


@dataclass(frozen=True)
class Layout:
    """Where the kernel keeps what: ``words`` is its ``enum Lay`` (the
    chunk, the tree's leaves, then byte offsets into shared memory, < 0
    for a placed array in device memory), ``smem_bytes`` the dynamic
    shared memory of the block, ``scratch_bytes`` the device memory of the
    page map and links that shared memory does not hold, ``in_smem`` the
    placed arrays that it does."""

    words: tuple
    smem_bytes: int
    scratch_bytes: int
    in_smem: tuple


def _placed_bytes(cfg: StackConfig, params: Dict, lanes: int = 1,
                  flash_lanes: int = 1) -> Dict[str, int]:
    """Bytes of each placed array the stack has, in the order shared
    memory takes them: the frames' map, packed frames and links (the
    recency list of an LRU buffer or cache), then the flash's l2p, and
    the GC's valid counts, free mask, free queue and p2l, and the bitmap
    of blocks a failed erase retired; the media arrays for ``lanes``
    lanes, the flash arrays for ``flash_lanes``."""
    out = {}
    if fully_associative(cfg):
        frames = cfg.buf_entries if cfg.kind == SSD_BUF else cfg.cache_frames
        out["where"] = 4 * cfg.num_pages
        out["frames"] = 8 * frames
        if cfg.kind == SSD_BUF or bool(np.asarray(params["is_lru"])):
            out["links"] = 8 * frames
    elif cfg.kind == SSD_CACHE:
        out["frames"] = 8 * cfg.cache_frames
    if stack.has_flash(cfg):
        out["l2p"] = 4 * cfg.num_pages
    if cfg.gc:
        nb = cfg.num_blocks
        out.update(valid=4 * nb, free_mask=nb, free_q=4 * nb,
                   p2l=4 * nb * cfg.pages_per_block)
        if cfg.faults:
            out["retired"] = 4 * -(-nb // 32)
    media = ("where", "frames", "links")
    return {k: v * (lanes if k in media else flash_lanes)
            for k, v in out.items()}


def layout(cfg: StackConfig, params: Dict, budget: int, *,
           chunk: int = CHUNK, placed: bool = True) -> Layout:
    """The kernel's layout for ``cfg`` within ``budget`` bytes of shared
    memory: the staging buffers (two chunks of inputs, a faulted stack's
    retry bytes among them, and outputs), the LFB tree, the ports (with a
    faulted stack's QoS virtual clocks), route tables, MSHR and writeback
    tables (padded to blocks of 8 entries) and the die / channel
    busy-untils always; then
    each placed array, in the order of :func:`_placed_bytes`, while it
    fits (none when ``placed`` is False: the device-memory layout).  The
    kernel reads ``chunk`` accesses a staged chunk.  Raises ``ValueError``
    when the tables alone exceed ``budget``."""
    frames = cfg.buf_entries if cfg.kind == SSD_BUF else cfg.cache_frames
    if stack.has_flash(cfg) and frames < 1:
        raise ValueError("the kernel's buffer or cache needs >= 1 frame")
    leaves = 1 << (max(1, cfg.outstanding) - 1).bit_length()
    R, H, P = num_paths(cfg, params), cfg.num_hops, cfg.num_ports
    dies = cfg.channels * cfg.dies_per_channel
    words = {"chunk": chunk, "leaves": leaves}
    off = 0

    def take(nbytes: int) -> int:
        nonlocal off
        at, off = off, off + -(-nbytes // 16) * 16
        return at

    rt = H if cfg.fault_hops else 0
    for name, size in (("in_key", 8), ("in_aux", 4), ("in_set", 4),
                       ("in_rt", rt), ("out_issue", 8), ("out_done", 8),
                       ("out_flags", 4)):
        words[name] = take(2 * chunk * size)
    words["tree"] = take(2 * leaves * 16)
    for name in ("pb", "qacc", "qthr"):
        words[name] = take(8 * P)
    words["vft"] = take(8 * P if cfg.fault_hops else 0)
    words["tables"] = take(8 * (3 * R * H + P))
    nm8, nw8 = (-(-x // 8) * 8 for x in (cfg.mshr_entries, cfg.wb_slots))
    words["mpage"] = take(4 * nm8)              # int32 pages in the kernel
    for name, count in (("mready", nm8), ("wtick", nw8), ("die_busy", dies),
                        ("die_prog", dies), ("chan_busy", cfg.channels)):
        words[name] = take(8 * count)
    if off > budget:
        raise ValueError(f"the kernel's staging buffers and tables need {off} "
                         f"B of shared memory, more than the {budget} B a "
                         f"block may use")
    return _place(words, _placed_bytes(cfg, params), off, budget, placed,
                  LAYOUT)


def _place(words: Dict, sizes: Dict[str, int], off: int, budget: int,
           placed: bool, order: tuple) -> Layout:
    """Place the arrays of ``sizes`` after ``off`` bytes of shared memory,
    in :data:`PLACED` order, each while it fits (none unless ``placed``);
    the map, links and retired bitmap that do not fit go to the scratch
    tensor, the rest stay in their state tensors.  ``words`` gets each
    one's offset; returns the :class:`Layout` of ``order``."""
    scratch, in_smem = 0, []
    for name in PLACED:
        size = -(-sizes.get(name, 0) // 16) * 16
        if name not in sizes:
            words[name] = -1
        elif placed and off + size <= budget:
            words[name], off = off, off + size
            in_smem.append(name)
        elif name in SCRATCH:
            words[name] = -1 - scratch
            scratch += size
        else:
            words[name] = -1
    return Layout(tuple(words[k] for k in order), off, scratch,
                  tuple(in_smem))


_SMEM_OPTIN: dict[int, int] = {}


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.replay_scan_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def _smem_optin(lib, index: int) -> int:
    if index not in _SMEM_OPTIN:
        out = ctypes.c_int(0)
        _raise_on(lib, lib.replay_scan_smem_optin(index, ctypes.byref(out)),
                  "cudaDeviceGetAttribute")
        _SMEM_OPTIN[index] = out.value
    return _SMEM_OPTIN[index]


def _launch(cfg, params, state, addrs, writes, routes, retries, start_tick,
            carry=None):
    """Launch the kernel on the tensors' card, on PyTorch's current
    stream."""
    from repro_torch.kernels import _build

    dev = addrs.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if cfg.outstanding > MAX_OUTSTANDING:
        raise ValueError(f"outstanding={cfg.outstanding} exceeds the "
                         f"kernel's {MAX_OUTSTANDING} LFB slots")
    _check_values(cfg, params, state, addrs, routes, retries,
                  resumed=carry is not None and carry.seen > 0)
    lib = _build.library("replay_scan")
    if (lib.replay_scan_num_args(), lib.replay_scan_layout_words()) != (
            len(ARGS), len(LAYOUT)):
        raise RuntimeError(
            f"the kernel takes {lib.replay_scan_num_args()} arguments and "
            f"{lib.replay_scan_layout_words()} layout words, the wrapper "
            f"packs {len(ARGS)} and {len(LAYOUT)}")
    with torch.cuda.device(dev):
        optin = _smem_optin(lib, torch.cuda.current_device())
        lay = layout(cfg, params, optin)
        err, out = call_launch(lib, cfg, params, state, addrs, writes, routes,
                               start_tick, lay,
                               torch.cuda.current_stream(dev).cuda_stream,
                               retries=retries, carry=carry)
        _raise_on(lib, err, "replay_scan kernel launch")
        LAUNCHES["replay_scan"] += 1
    return out


def _scalars_in(md: Dict, fl: Dict, lead: tuple, device) -> torch.Tensor:
    """The state's :data:`SCALARS` as the kernel takes them: int64, the
    last axis, after the ``lead`` axes of a sweep's lanes (``()`` for one
    replay)."""
    cols = []
    for k in SCALARS:
        x = md.get(k, fl.get(k))
        cols.append(torch.zeros(lead, dtype=torch.int64, device=device)
                    if x is None else x.to(torch.int64).reshape(lead))
    return torch.stack(cols, -1).contiguous()


def _scalars_out(md: Dict, fl: Dict, scal: torch.Tensor) -> None:
    """Copy the kernel's scalars back into the state tensors."""
    for i, k in enumerate(SCALARS):
        part = md if k in md else fl
        if k in part:
            part[k].copy_(scal[..., i].reshape(part[k].shape))


def call_launch(lib, cfg, params, state, addrs, writes, routes, start_tick,
                lay: Layout, stream, retries=None, carry=None):
    """Pack one replay's arguments and layout, call
    ``lib.replay_scan_launch`` on them and its tensors' device (resuming
    and updating ``carry`` when given), and copy the state's scalars
    back.  Returns the call's return code and
    ``(issues, dones, flags, qacc, qthr)``.  :func:`_launch` calls it with
    the CUDA library; a host build of the same source
    (``REPLAY_SCAN_EMULATE``) takes CPU tensors."""
    dev = addrs.device
    n = addrs.shape[0]
    P = cfg.num_ports
    md, fl = state["media"], state["flash"] or {}
    args = arg_block(cfg, params, n, start_tick)
    words = np.asarray(lay.words, np.int64)
    tables = torch.from_numpy(route_tables(cfg, params)).to(dev)
    issues = torch.empty(n, dtype=torch.int64, device=dev)
    dones = torch.empty(n, dtype=torch.int64, device=dev)
    flags = torch.empty(n, dtype=torch.int32, device=dev)
    totals = torch.empty(2 * P, dtype=torch.int64, device=dev)
    scratch = torch.empty(max(16, lay.scratch_bytes), dtype=torch.uint8,
                          device=dev)
    scal = _scalars_in(md, fl, (), dev)
    w8 = writes.view(torch.uint8)
    addrs = addrs.contiguous()
    if retries is not None:
        retries = retries.contiguous()

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = lib.replay_scan_launch(
        args.ctypes.data, words.ctypes.data, tables.data_ptr(),
        addrs.data_ptr(), w8.data_ptr(), ptr(routes), ptr(retries),
        issues.data_ptr(),
        dones.data_ptr(), flags.data_ptr(), totals.data_ptr(),
        scal.data_ptr(), *(ptr(md.get(k)) for k in MEDIA_ARRAYS),
        *(ptr(fl.get(k)) for k in FLASH_ARRAYS), scratch.data_ptr(),
        *((None, None) if carry is None
          else (carry.words.data_ptr(), carry.maps.data_ptr())),
        lay.smem_bytes, stream)
    if err == 0:
        _scalars_out(md, fl, scal)
        if carry is not None:
            carry.seen += n
    return err, (issues, dones, flags, totals[:P], totals[P:])


# ------------------------------------------------------ the multi-host replay
def multi_tables(cfg, params: Dict) -> Dict[str, np.ndarray]:
    """The multi-host replay's route rows: ``port`` (-1 on a hop the row
    does not have), ``occ``, ``after`` (rows x ``cfg.max_hops``, int64)
    and ``dev`` (each row's media lane).  The rows are the ``(host,
    device, route)`` hops that the columns use: a pool's every pair,
    flattened (row ``(i * NDEV + d) * K + r``), a mount's own device
    only (row ``i * K + r``); a faulted replay's are its path table."""
    if cfg.fault_hops:
        return {"port": np.asarray(params["path_port"], np.int64),
                "occ": np.asarray(params["path_occ"], np.int64),
                "after": np.asarray(params["path_after"], np.int64),
                "dev": np.asarray(params["path_dev"], np.int64)}
    on = np.asarray(params["hop_on"], bool)
    H, D, K, FH = on.shape
    port = np.where(on, params["hop_port"], -1).astype(np.int64)
    occ = np.where(on, params["hop_occ"], 0)
    after = np.where(on, params["hop_after"], 0)
    dev = np.broadcast_to(np.arange(D)[None, :, None], (H, D, K))
    if cfg.mounts:
        diag = np.arange(H)
        port, occ, after, dev = (x[diag, diag] for x in (port, occ, after,
                                                         dev))
    return {"port": port.reshape(-1, FH), "occ": occ.reshape(-1, FH),
            "after": after.reshape(-1, FH),
            "dev": dev.reshape(-1).astype(np.int64)}


def multi_rows(cfg, devs: torch.Tensor,
               routes: Optional[torch.Tensor]) -> torch.Tensor:
    """Each access's row of :func:`multi_tables` (``(H, L)`` int32): the
    path id of a faulted replay, else ``(i * NDEV + dev) * K + route`` (a
    mount's ``i * K + route``)."""
    if cfg.fault_hops:
        return routes.to(torch.int32)
    host = torch.arange(cfg.num_hosts, device=devs.device)[:, None]
    if cfg.mounts:
        rows = host * cfg.max_routes + torch.zeros_like(devs, dtype=torch.long)
    else:
        rows = (host * cfg.num_devs + devs.long()) * cfg.max_routes
    if routes is not None:
        rows = rows + routes.long()
    return rows.to(torch.int32)


def multi_carry_words(cfg) -> int:
    """Words of the multi-host carry (``struct MultiCarry``): the steps
    replayed, a host each its clock and cursor, its LFB slots, a port each
    busy-until, queueing and throttle totals, the QoS tables (ports x
    hosts, virtual finish and last arrival) and a media lane each its
    fill pointer, recency head and tail."""
    H, K, P, D = cfg.num_hosts, cfg.outstanding, cfg.num_ports, cfg.num_devs
    return 1 + 2 * H + H * K + 3 * P + 2 * P * H + 3 * D


def _multi_carry_parts(cfg, words: list) -> Dict[str, list]:
    H, K, P, D = cfg.num_hosts, cfg.outstanding, cfg.num_ports, cfg.num_devs
    out, at = {}, 1
    for name, size in (("now", H), ("idx", H), ("slots", H * K), ("pb", P),
                       ("qacc", P), ("qthr", P), ("vft", P * H),
                       ("last", P * H), ("lanes", 3 * D)):
        out[name], at = words[at:at + size], at + size
    return out


def new_multi_carry(cfg, params: Dict, device, start_tick: int = 0) -> Carry:
    """A fresh carry of a multi-host replay from ``start_tick`` on
    ``device``."""
    from repro_torch.core.replay.multihost import NEVER

    H, K, P, D = cfg.num_hosts, cfg.outstanding, cfg.num_ports, cfg.num_devs
    w = ([0] + [start_tick] * H + [0] * H + [start_tick] * (H * K)
         + [0] * (3 * P + P * H) + [NEVER] * (P * H) + [0, -1, -1] * D)
    return Carry(torch.tensor(w, dtype=torch.int64, device=device),
                 torch.full((_maps_bytes(cfg.stack, params, D),), 255,
                            dtype=torch.uint8, device=device))


def cursors(carry: Carry, num_hosts: int) -> np.ndarray:
    """The hosts' cursors of a multi-host carry (one read from its
    device): where each host's next window starts."""
    return np.array(carry.words[1 + num_hosts:1 + 2 * num_hosts].tolist(),
                    np.int64)


def _check_multi(cfg, params: Dict, state: Dict, addrs, writes, lens, devs,
                 routes, retries, carry: Optional[Carry] = None,
                 base=None) -> int:
    """The shape, type and value checks of :func:`replay_multi`; returns
    the number of steps: ``sum(lens)``, or with a carry the steps left
    up to the windows' width."""
    H = cfg.num_hosts
    if addrs.dtype != torch.int64 or addrs.dim() != 2 or addrs.shape[0] != H:
        raise ValueError(f"addrs must be an ({H}, L) int64 tensor, got "
                         f"{addrs.dtype} {tuple(addrs.shape)}")
    shape = tuple(addrs.shape)
    if writes.dtype != torch.bool or tuple(writes.shape) != shape:
        raise ValueError(f"writes must be a {shape} bool tensor")
    if devs.dtype != torch.int32 or tuple(devs.shape) != shape:
        raise ValueError(f"devs must be a {shape} int32 tensor")
    if lens.dtype != torch.int64 or tuple(lens.shape) != (H,):
        raise ValueError(f"lens must be an ({H},) int64 tensor")
    if (cfg.max_routes > 1 or cfg.fault_hops) != (routes is not None):
        raise ValueError("a per-access route column goes with ECMP "
                         "(max_routes > 1) or transport faults (fault_hops),"
                         " and only with them")
    if routes is not None and (routes.dtype != torch.int32
                               or tuple(routes.shape) != shape):
        raise ValueError(f"routes must be a {shape} int32 tensor")
    if cfg.fault_hops != (retries is not None):
        raise ValueError("retry bytes go with transport faults (fault_hops)"
                         " and only with them")
    if retries is not None and (retries.dtype != torch.uint8 or tuple(
            retries.shape) != shape + (cfg.max_hops,)):
        raise ValueError(f"retries must be a {shape + (cfg.max_hops,)} "
                         "uint8 tensor")
    tensors = [writes, lens, devs] + [x for x in (routes, retries)
                                      if x is not None]
    for part in ("media", "flash"):
        tensors += list((state[part] or {}).values())
    for x in tensors:
        if x.device != addrs.device:
            raise ValueError(f"tensors on {x.device} and {addrs.device}")
    lens_ = lens.tolist()
    seen = 0 if carry is None else carry.seen
    n = int(sum(lens_)) - seen
    if carry is None:
        if min(lens_) < 0 or max(lens_) > shape[1] or n < 1:
            raise ValueError(f"lens must lie in [0, {shape[1]}] and sum to "
                             f">= 1, got {lens_}")
        base = np.zeros(cfg.num_hosts, np.int64)
    else:
        if (tuple(carry.words.shape) != (multi_carry_words(cfg),)
                or carry.words.device != addrs.device):
            raise ValueError("the carry is not this replay's "
                             "(new_multi_carry) or lies on another device")
        if min(lens_) < 0 or n < 1 or base is None or len(base) != len(
                lens_):
            raise ValueError(f"a resumed replay needs steps left and the "
                             f"hosts' cursors, got lens {lens_} after "
                             f"{seen} steps")
        n = min(n, shape[1])
    if stack.has_flash(cfg.stack) and seen + n > MAX_ACCESSES:
        raise ValueError(f"{seen} + {n} accesses exceed the packed stamp's "
                         f"{MAX_ACCESSES}")
    tab = multi_tables(cfg, params)
    rows = multi_rows(cfg, devs, routes)
    live = (torch.arange(shape[1], device=addrs.device)[None, :]
            + torch.as_tensor(np.asarray(base, np.int64),
                              device=addrs.device)[:, None]) < lens[:, None]
    top = (cfg.stack.num_pages * cfg.stack.page_bytes
           if stack.has_flash(cfg.stack) else None)
    checks = {"addresses": ((addrs < 0) & live).any(),
              "rows": (((rows < 0) | (rows >= tab["port"].shape[0]))
                       & live).any(),
              "devs": (((devs < 0) | (devs >= cfg.num_devs)) & live).any()}
    if top is not None:
        checks["addresses"] |= ((addrs >= top) & live).any()
    if retries is not None:
        off = torch.from_numpy(tab["port"] < 0).to(addrs.device)[
            rows.clamp(0, tab["port"].shape[0] - 1).long()]
        checks["retries"] = (off & (retries != 0) & live[..., None]).any()
    if fully_associative(cfg.stack) and not seen:
        checks["frames"] = (state["media"]["frames"] != stack.FREE).any()
    failed = dict(zip(checks, torch.stack(list(checks.values())).tolist()))
    if failed["addresses"]:
        raise ValueError("addresses must be >= 0" + (
            "" if top is None else f" and below {top}"))
    if failed["rows"] or failed["devs"]:
        raise ValueError("devices and routes must lie inside the route "
                         "tables")
    if failed.get("retries"):
        raise ValueError("retry bytes must be 0 on the hops an access's "
                         "path does not have (port -1)")
    if failed.get("frames"):
        raise ValueError(
            "replay_multi starts from fresh caches: every frame free (-1), "
            "as stack.init_lanes makes them")
    return n


def replay_multi(cfg, params: Dict, state: Dict, addrs: torch.Tensor,
                 writes: torch.Tensor, lens: torch.Tensor,
                 devs: torch.Tensor, routes: Optional[torch.Tensor] = None,
                 *, start_tick: int = 0,
                 retries: Optional[torch.Tensor] = None,
                 carry: Optional[Carry] = None, base=None):
    """Replay ``H`` hosts' traces, interleaved as the JAX package's
    ``MultiHostReplay`` interleaves them, through the multi-host stack
    ``cfg`` (a :class:`~repro_torch.core.replay.multihost.MultiCfg`) /
    ``params`` from the lane-stacked ``state``
    (:func:`repro_torch.core.replay.stack.init_lanes` on the traces'
    device), which ends as the final state.

    ``addrs`` / ``writes`` / ``devs`` are ``(H, L)`` (device-local int64
    addresses, bool, int32 media lanes), ``lens`` the ``(H,)`` int64
    trace lengths.  ``routes`` (``(H, L)`` int32) is the ECMP route of an
    ``max_routes > 1`` replay or, under transport faults
    (``cfg.fault_hops``), the access's path id into the path table in
    ``params`` (``path_port``, -1 on a hop the path does not have,
    ``path_occ``, ``path_after``, ``path_dev``), with ``retries``
    (``(H, L, max_hops)`` uint8) its CRC retries a hop.

    With ``carry`` (a :func:`new_multi_carry`) the replay resumes one of
    ``carry.seen`` steps: the columns are then each host's window of
    ``W`` accesses from its cursor ``base[i]`` (:func:`cursors`), ``lens``
    the whole traces' lengths, and the call replays ``min(W, sum(lens) -
    carry.seen)`` steps (a step takes one access, so no host outruns its
    window), updating the state and the carry.

    Returns ``(who, issues, dones, flags, qacc, qthr)`` in step order,
    ``sum(lens)`` steps (or the call's steps): the host of each step
    (int32), its issue and completion ticks (int64), its flags (int32: bit
    0 hit, bit 1 dirty evict, then the kind's :data:`FLAG_EVENT_BITS`),
    and the int64 queueing ticks and QoS throttle events of each port
    (since the carry's start).

    Raises ``ValueError`` on addresses below 0 or past the stack's pages,
    on devices or routes outside the tables, on retry bytes of hops a
    path does not have, and, without a carry to resume, on caches that
    are not all free."""
    n = _check_multi(cfg, params, state, addrs, writes, lens, devs, routes,
                     retries, carry, base)
    if addrs.device.type == "cpu":
        return replay_multi_plain(cfg, params, state, addrs, writes, lens,
                                  devs, routes, start_tick=start_tick,
                                  retries=retries, carry=carry, base=base)
    return _launch_multi(cfg, params, state, addrs, writes, lens, devs,
                         routes, retries, start_tick, n, carry)


def replay_multi_plain(cfg, params: Dict, state: Dict, addrs: torch.Tensor,
                       writes: torch.Tensor, lens: torch.Tensor,
                       devs: torch.Tensor,
                       routes: Optional[torch.Tensor] = None, *,
                       start_tick: int = 0,
                       retries: Optional[torch.Tensor] = None,
                       carry: Optional[Carry] = None, base=None):
    """Plain version of :func:`replay_multi`: the JAX package's
    ``_make_multi_step`` (the host race, LFB slot recycle, the route walk
    over the shared ports with the QoS mirror, the media step of the
    target lane and its flash lane, the acknowledgment floor) one step
    per loop iteration over :func:`repro_torch.core.replay.stack.
    media_step`, for ``sum(lens)`` steps (the reference's padded steps
    after that change nothing its results read), or from ``carry`` over
    windows as :func:`replay_multi` says.  Runs on any device's tensors;
    the card's main path launches the kernel instead."""
    return _multi_plain(cfg, params, state, addrs, writes, lens, devs,
                        routes, start_tick, retries, carry, base, None)


def replay_sharded_plain(cfg, shards: int, params: Dict, state: Dict,
                         addrs: torch.Tensor, writes: torch.Tensor,
                         lens: torch.Tensor, devs: torch.Tensor,
                         routes: Optional[torch.Tensor] = None, *,
                         start_tick: int = 0,
                         retries: Optional[torch.Tensor] = None):
    """Plain version of :func:`replay_sharded`: :func:`replay_multi_plain`
    with the JAX package's ``shard.py`` election over ``shards`` blocks of
    hosts: each shard's least candidate (its lowest host on ties), their
    gather, the least over the shards (the lowest shard on ties), the
    winner's row from its shard's own table (:func:`shard_rows`), and the
    media step of the owner's lane alone.  Runs on any device's tensors;
    the card's main path launches the kernel instead."""
    return _multi_plain(cfg, params, state, addrs, writes, lens, devs,
                        routes, start_tick, retries, None, None, shards)


def _multi_plain(cfg, params, state, addrs, writes, lens, devs, routes,
                 start_tick, retries, carry, base, shards):
    """The loop of :func:`replay_multi_plain`, or with ``shards`` of
    :func:`replay_sharded_plain`."""
    from repro_torch.core.fabric.switch import ACTIVE_WINDOW_OCC
    from repro_torch.core.replay.multihost import BIG, NEVER

    p = host_params({k: v for k, v in params.items()
                     if not k.startswith(("hop_", "path_"))})
    tab = {k: v.tolist() for k, v in multi_tables(cfg, params).items()}
    if shards:
        Hl = cfg.num_hosts // shards
        per_shard, local, _ = shard_rows(cfg, params, shards)
        local = local.tolist()
        per_shard = [{k: v.tolist() for k, v in t.items()}
                     for t in per_shard]
    a, w = addrs.tolist(), writes.tolist()
    rows = multi_rows(cfg, devs, routes).tolist()
    rt = retries.tolist() if retries is not None else None
    n_of = lens.tolist()
    H, P, K = cfg.num_hosts, cfg.num_ports, cfg.outstanding
    kind = cfg.stack.kind
    bits = FLAG_EVENT_BITS[kind]
    slots = [[start_tick] * K for _ in range(H)]
    now = [start_tick] * H
    idx = [0] * H
    pb, qacc, qthr = [0] * P, [0] * P, [0] * P
    vft = [[0] * H for _ in range(P)]
    last = [[NEVER] * H for _ in range(P)]
    seen = carry.seen if carry is not None else 0
    steps = sum(n_of) - seen
    b = [0] * H
    if carry is not None:
        steps = min(steps, addrs.shape[1])
        b = [int(x) for x in base]
    if seen:
        c = _multi_carry_parts(cfg, carry.words.tolist())
        now, idx, pb, qacc, qthr = (c["now"], c["idx"], c["pb"], c["qacc"],
                                    c["qthr"])
        slots = [c["slots"][i * K:(i + 1) * K] for i in range(H)]
        vft = [c["vft"][i * H:(i + 1) * H] for i in range(P)]
        last = [c["last"][i * H:(i + 1) * H] for i in range(P)]
    flash_of = p["flash_of"]
    who, issues, dones, flags = [], [], [], []
    for s in range(seen, seen + steps):
        cand = [max(now[i], min(slots[i])) if idx[i] < n_of[i] else BIG
                for i in range(H)]
        t_rows = tab
        if shards:
            # each shard's least candidate, gathered; the least of them
            best = [min(range(q * Hl, (q + 1) * Hl), key=cand.__getitem__)
                    for q in range(shards)]
            owner = min(range(shards), key=lambda q: cand[best[q]])
            i = best[owner]
            t_rows = per_shard[owner]                # the owner's table
        else:
            i = cand.index(min(cand))                # ties -> lowest host
        k = slots[i].index(min(slots[i]))            # ties -> lowest slot
        issue = max(now[i], slots[i][k])
        j = idx[i] - b[i]                            # in the host's window
        r = rows[i][j] if not shards else local[rows[i][j]]
        t, floor = issue, 0
        for h in range(cfg.max_hops):
            pi = t_rows["port"][r][h]
            if pi < 0:                   # a hop this row does not have
                continue
            occ_c, after_h = t_rows["occ"][r][h], t_rows["after"][r][h]
            occ_h = occ_c * (1 + rt[i][j][h]) if rt is not None else occ_c
            if cfg.qos and p["qos_on"][pi]:
                # SwitchPort.qos_update at arrival tick t: the weight sum in
                # sorted-host order, int(occ * (W / w)) truncation
                prev = vft[pi][i]
                win = occ_c * ACTIVE_WINDOW_OCC
                w_active = 0.0
                for o in cfg.host_order:
                    if o == i or last[pi][o] + win > t:
                        w_active = w_active + p["qos_w"][pi][o]
                pace = int(occ_c * (w_active / p["qos_w"][pi][i]))
                if prev > t:
                    floor = max(floor, prev + pace)
                    qthr[pi] += 1
                vft[pi][i] = max(prev, t) + pace
                last[pi][i] = t
            start = max(t, pb[pi])
            qacc[pi] += start - t
            pb[pi] = start + occ_h
            t = pb[pi] + after_h
        t += p["rt_extra"]
        d = t_rows["dev"][r] + (owner * Hl if shards else 0)
        p_med = p
        if kind == DRAM:
            p_med = {"occ": p["dev_occ"][d], "load": p["dev_load"][d],
                     "pack": p["dev_pack"][d]}
        done, ex = stack.media_step(
            cfg.stack, p_med, stack.lane(state["media"], d),
            stack.lane(state["flash"], flash_of[d]), t, a[i][j], w[i][j],
            w[i][j] and cfg.posted_writes, s + 1)
        if cfg.qos:
            done = max(done, floor)      # ack floor, data path untouched
        f = int(ex.get("hit", False)) | int(ex.get("evict", False)) << 1
        for bit, key in bits:
            f |= int(ex[key]) << bit
        who.append(i)
        issues.append(issue)
        dones.append(done)
        flags.append(f)
        slots[i][k] = done
        now[i] = issue + p["issue_ov"]
        idx[i] += 1
    dev = addrs.device

    def i64(x):
        return torch.tensor(x, dtype=torch.int64, device=dev)

    if carry is not None:
        lanes, maps = [], []
        for d in range(cfg.num_devs):
            frames = (state["media"]["frames"][d].cpu().numpy()
                      if "frames" in state["media"] else np.zeros(0, np.int64))
            fill, head, tail, where, links = victim_order(cfg.stack, params,
                                                          frames)
            lanes += [fill, head, tail]
            maps.append((where, links))
        carry.words.copy_(i64(
            [seen + steps] + now + idx + sum(slots, []) + pb + qacc + qthr
            + sum(vft, []) + sum(last, []) + lanes))
        carry.maps.copy_(torch.from_numpy(_pack_maps(cfg.stack, params,
                                                     maps)))
        carry.seen = seen + steps

    return (torch.tensor(who, dtype=torch.int32, device=dev), i64(issues),
            i64(dones), torch.tensor(flags, dtype=torch.int32, device=dev),
            i64(qacc), i64(qthr))


def multi_arg_blocks(cfg, params: Dict, n: int, start_tick: int,
                     stride: int, shards: Optional[int] = None):
    """The multi-host instance's argument block (:data:`ARGS`: the media
    statics, ``n`` steps, the row tables' hops and the ports) and its own
    (:data:`MARGS`), int64 each; a sharded replay's (``shards``) hosts,
    lanes and rows are a shard's."""
    from repro_torch.core.fabric.switch import ACTIVE_WINDOW_OCC

    tab = multi_tables(cfg, params)
    S = shards or 1
    rows = (tab["port"].shape[0] if shards is None
            else shard_rows(cfg, params, shards)[2])
    scfg = dataclasses.replace(cfg.stack, num_hops=cfg.max_hops,
                               num_ports=cfg.num_ports, num_routes=1,
                               fault_hops=False, qos_ports=())
    args = arg_block(scfg, {k: v for k, v in params.items()
                            if not k.startswith(("hop_", "path_"))},
                     n, start_tick)
    args[ARGS.index("fault_hops")] = int(cfg.fault_hops)
    args[ARGS.index("paths")] = rows
    margs = dict(hosts=cfg.num_hosts // S, lanes=cfg.num_devs // S,
                 flash_lanes=cfg.n_flash // S, stride=stride,
                 qos=int(cfg.qos), rows=rows, window=ACTIVE_WINDOW_OCC)
    return args, np.asarray([margs[k] for k in MARGS], np.int64)


def kernel_table(cfg, params: Dict, lens) -> np.ndarray:
    """The kernel's table (int64, copied to shared memory): trace lengths,
    hosts in sorted-name order, the lanes' flash lanes and DRAM timing
    (occupancy, load, posted ack), each row's lane, the rows' port, occ
    and after, the per-port QoS mask and the float64 QoS weights (ports x
    hosts, as their bits; a mask of 0 and weights of 1 without QoS: a
    length that depends on QoS reschedules the one-block instance's
    compiled walk, 2.5% slower on the card, while a shard's table,
    :func:`shard_tables`, drops them)."""
    return _table_words(cfg, params, np.asarray(lens, np.int64),
                        np.asarray(params["flash_of"], np.int64),
                        np.arange(cfg.num_devs), multi_tables(cfg, params),
                        qos_words=True)


def _table_words(cfg, params: Dict, lens, flash_of, lanes, tab,
                 qos_words: bool) -> np.ndarray:
    """:func:`kernel_table`'s words of the hosts of ``lens``, the media
    lanes ``lanes`` (their flash lanes ``flash_of``) and the rows ``tab``,
    with the QoS mask and weights under QoS or with ``qos_words``."""
    H, P = cfg.num_hosts, cfg.num_ports
    order = list(cfg.host_order) if cfg.qos else list(range(H))
    parts = [lens, np.asarray(order, np.int64), flash_of]
    zeros = np.zeros(cfg.num_devs, np.int64)
    parts += [np.asarray(params.get(k, zeros), np.int64)[lanes]
              for k in ("dev_occ", "dev_load", "dev_pack")]
    parts += [tab["dev"], tab["port"].ravel(), tab["occ"].ravel(),
              tab["after"].ravel()]
    if cfg.qos:
        parts += [np.asarray(params["qos_on"], np.int64),
                  np.asarray(params["qos_w"], np.float64).ravel().view(
                      np.int64)]
    elif qos_words:
        parts += [np.zeros(P, np.int64),
                  np.ones(P * H, np.float64).view(np.int64)]
    return np.concatenate(parts)


def layout_multi(cfg, params: Dict, budget: int, *, placed: bool = True,
                 shards: Optional[int] = None) -> Layout:
    """The multi-host instance's layout within ``budget`` bytes of shared
    memory (:data:`LAYOUT_MULTI`): the hosts' LFB trees, clocks, cursors,
    candidates and cursors as the launch began, and their prefetched next
    accesses, the ports (with the QoS tables, ports x hosts), the kernel's
    table, every lane's scalars, MSHR and writeback tables and die /
    channel busy-untils always; then each placed array kind, every lane's
    at once, in the order of :func:`_placed_bytes`, while it fits (none
    when ``placed`` is False).  With ``shards`` it is one CTA's layout of
    the sharded instance: a shard's hosts, lanes and table, the replicated
    ports and QoS tables, and the election slots.  Raises ``ValueError``
    when the rest alone exceeds ``budget``."""
    scfg = cfg.stack
    frames = scfg.buf_entries if scfg.kind == SSD_BUF else scfg.cache_frames
    if stack.has_flash(scfg) and frames < 1:
        raise ValueError("the kernel's buffer or cache needs >= 1 frame")
    S = shards or 1
    H, D, F, P = (cfg.num_hosts // S, cfg.num_devs // S, cfg.n_flash // S,
                  cfg.num_ports)
    leaves = 1 << (max(1, cfg.outstanding) - 1).bit_length()
    dies = scfg.channels * scfg.dies_per_channel
    words = {"leaves": leaves}
    off = 0

    def take(nbytes: int) -> int:
        nonlocal off
        at, off = off, off + -(-nbytes // 16) * 16
        return at

    words["tree"] = take(H * 2 * leaves * 16)
    words["host"] = take(4 * 8 * H + (
        8 * (2 * ELECT_WORDS + 3 * MAX_SHARD_HOPS) if shards else 0))
    words["next"] = take(3 * 8 * H)
    for name in ("pb", "qacc", "qthr"):
        words[name] = take(8 * P)
    for name in ("vft", "last"):
        words[name] = take(8 * P * cfg.num_hosts if cfg.qos else 0)
    words["mtab"] = take(8 * (
        kernel_table(cfg, params, np.zeros(H)).size if shards is None
        else shard_tables(cfg, params, np.zeros(cfg.num_hosts),
                          shards).shape[1]))
    words["mscal"] = take(8 * MEDIA_SCALARS * D)
    words["fscal"] = take(8 * len(SCALARS) * F)
    nm8, nw8 = (-(-x // 8) * 8 for x in (scfg.mshr_entries, scfg.wb_slots))
    words["mpage"] = take(4 * nm8 * D)
    for name, count in (("mready", nm8 * D), ("wtick", nw8 * D),
                        ("die_busy", dies * F), ("die_prog", dies * F),
                        ("chan_busy", scfg.channels * F)):
        words[name] = take(8 * count)
    if off > budget:
        what = ("the multi-host replay's tables need" if shards is None
                else f"a shard of the sharded replay ({S} shards) needs")
        raise ValueError(f"{what} {off} B of shared memory, more than the "
                         f"{budget} B a block may use")
    return _place(words, _placed_bytes(scfg, params, lanes=D,
                                       flash_lanes=max(F, 1)),
                  off, budget, placed, LAYOUT_MULTI)


def _launch_multi(cfg, params, state, addrs, writes, lens, devs, routes,
                  retries, start_tick, n, carry=None):
    """Launch the multi-host instance on the tensors' card, on PyTorch's
    current stream."""
    from repro_torch.kernels import _build

    dev = addrs.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if cfg.outstanding > MAX_OUTSTANDING:
        raise ValueError(f"outstanding={cfg.outstanding} exceeds the "
                         f"kernel's {MAX_OUTSTANDING} LFB slots")
    lib = _build.library("replay_scan")
    if (lib.replay_scan_num_margs(), lib.replay_scan_layout_multi_words()) \
            != (len(MARGS), len(LAYOUT_MULTI)):
        raise RuntimeError("the kernel's multi-host argument block or layout"
                           " differs from the wrapper's")
    with torch.cuda.device(dev):
        lay = layout_multi(cfg, params,
                           _smem_optin(lib, torch.cuda.current_device()))
        err, out = call_launch_multi(
            lib, cfg, params, state, addrs, writes, lens, devs, routes,
            start_tick, lay, torch.cuda.current_stream(dev).cuda_stream,
            retries=retries, n=n, carry=carry)
        _raise_on(lib, err, "replay_scan (multi-host) kernel launch")
        LAUNCHES["replay_scan"] += 1
    return out


def _multi_aux(cfg, devs: torch.Tensor, routes: Optional[torch.Tensor],
               writes: torch.Tensor) -> torch.Tensor:
    """Each access's ``aux`` word: its row of :func:`multi_tables` << 1,
    or its write flag (int32)."""
    return ((multi_rows(cfg, devs, routes).long() << 1)
            | writes.long()).to(torch.int32).contiguous()


def _packed_retries(cfg, retries: torch.Tensor) -> torch.Tensor:
    """Each access's retry bytes packed into one int64, byte h for hop
    h."""
    shifts = 8 * torch.arange(cfg.max_hops, device=retries.device,
                              dtype=torch.int64)
    return (retries.long() << shifts).sum(-1).contiguous()


def _multi_scalars_in(md: Dict, fl: Dict, lead: tuple, D: int, F: int,
                      device) -> torch.Tensor:
    """The lanes' scalars as the kernel takes them: after the ``lead``
    axes of a sweep's lanes, a row of :data:`SCALARS` a media lane, then a
    row a flash lane."""
    scal = torch.zeros(lead + (D + F, len(SCALARS)), dtype=torch.int64,
                       device=device)
    for c, k in enumerate(SCALARS):
        if k in md:
            scal[..., :D, c] = md[k]
        elif k in fl:
            scal[..., D:, c] = fl[k].to(torch.int64)
    return scal


def _multi_scalars_out(md: Dict, fl: Dict, scal: torch.Tensor,
                       D: int) -> None:
    for c, k in enumerate(SCALARS):
        if k in md:
            md[k].copy_(scal[..., :D, c])
        elif k in fl:
            fl[k].copy_(scal[..., D:, c])


def call_launch_multi(lib, cfg, params, state, addrs, writes, lens, devs,
                      routes, start_tick, lay: Layout, stream, retries=None,
                      n=None, carry=None):
    """Pack one multi-host replay's arguments, layout and table, call
    ``lib.replay_scan_launch_multi`` on them and its tensors' device
    (``n`` steps, resuming and updating ``carry`` when given), and copy
    the lanes' scalars back.  Returns the call's return code and
    ``(who, issues, dones, flags, qacc, qthr)``.  :func:`_launch_multi`
    calls it with the CUDA library; a host build of the same source
    (``REPLAY_SCAN_EMULATE``) takes CPU tensors."""
    dev = addrs.device
    H, L = addrs.shape
    if n is None:
        n = (int(lens.sum()) if carry is None
             else min(L, int(lens.sum()) - carry.seen))
    P, D, F = cfg.num_ports, cfg.num_devs, cfg.n_flash
    md, fl = state["media"], state["flash"] or {}
    lens_np = lens.cpu().numpy()
    args, margs = multi_arg_blocks(cfg, params, n, start_tick, L)
    words = np.asarray(lay.words, np.int64)
    mtab = torch.from_numpy(kernel_table(cfg, params, lens_np)).to(dev)
    aux = _multi_aux(cfg, devs, routes, writes)
    rt = None if retries is None else _packed_retries(cfg, retries)
    who = torch.empty(n, dtype=torch.int32, device=dev)
    issues = torch.empty(n, dtype=torch.int64, device=dev)
    dones = torch.empty(n, dtype=torch.int64, device=dev)
    flags = torch.empty(n, dtype=torch.int32, device=dev)
    totals = torch.empty(2 * P, dtype=torch.int64, device=dev)
    scratch = torch.empty(max(16, lay.scratch_bytes), dtype=torch.uint8,
                          device=dev)
    scal = _multi_scalars_in(md, fl, (), D, F, dev)
    addrs = addrs.contiguous()

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = lib.replay_scan_launch_multi(
        args.ctypes.data, margs.ctypes.data, words.ctypes.data,
        mtab.data_ptr(), addrs.data_ptr(), aux.data_ptr(), ptr(rt),
        who.data_ptr(), issues.data_ptr(), dones.data_ptr(),
        flags.data_ptr(), totals.data_ptr(), scal.data_ptr(),
        *(ptr(md.get(k)) for k in MEDIA_ARRAYS),
        *(ptr(fl.get(k)) for k in FLASH_ARRAYS), scratch.data_ptr(),
        *((None, None) if carry is None
          else (carry.words.data_ptr(), carry.maps.data_ptr())),
        lay.smem_bytes, stream)
    if err == 0:
        _multi_scalars_out(md, fl, scal, D)
        if carry is not None:
            carry.seen += n
    return err, (who, issues, dones, flags, totals[:P], totals[P:])


# ----------------------------------------------------- the sharded replay
def shard_rows(cfg, params: Dict, shards: int):
    """Each shard's route rows: ``(per_shard, local, width)``, where
    ``per_shard[q]`` holds shard ``q``'s rows of :func:`multi_tables`
    (``port``, ``occ``, ``after``, rows x hops, and ``dev``, its own media
    lane of the row), in their order, padded to ``width`` rows with rows
    of no hop; ``local`` maps a row of :func:`multi_tables` to its index
    in its shard's table.  A row belongs to the shard of its lane (a
    mount's host)."""
    tab = multi_tables(cfg, params)
    Hl = cfg.num_hosts // shards
    owner = tab["dev"] // Hl
    local = np.zeros(owner.size, np.int64)
    picks = [np.flatnonzero(owner == q) for q in range(shards)]
    width = max(1, max(x.size for x in picks))
    FH = tab["port"].shape[1]
    per_shard = []
    for q, rows in enumerate(picks):
        local[rows] = np.arange(rows.size)
        t = {"port": np.full((width, FH), -1, np.int64),
             "occ": np.zeros((width, FH), np.int64),
             "after": np.zeros((width, FH), np.int64),
             "dev": np.zeros(width, np.int64)}
        for k in ("port", "occ", "after"):
            t[k][:rows.size] = tab[k][rows]
        t["dev"][:rows.size] = tab["dev"][rows] - q * Hl
        per_shard.append(t)
    return per_shard, local, width


def shard_tables(cfg, params: Dict, lens, shards: int) -> np.ndarray:
    """The sharded instance's tables, a row a shard (``(shards, words)``
    int64): shard ``q``'s :func:`kernel_table` over its hosts, lanes and
    rows (:func:`shard_rows`), with the host order and QoS weights of
    every host."""
    Hl = cfg.num_hosts // shards
    per_shard, _, _ = shard_rows(cfg, params, shards)
    lens = np.asarray(lens, np.int64)
    flash_of = np.asarray(params["flash_of"], np.int64)
    return np.stack([
        _table_words(cfg, params, lens[q * Hl:(q + 1) * Hl],
                     flash_of[q * Hl:(q + 1) * Hl]
                     - (q * Hl if cfg.n_flash else 0),
                     np.arange(q * Hl, (q + 1) * Hl), per_shard[q],
                     qos_words=False)
        for q in range(shards)])


def check_shardable(cfg, params: Dict, shards: int) -> None:
    """The shapes the sharded instance takes: ``shards`` in [1,
    :data:`MAX_SHARDS`] dividing the hosts, a mounted device a host (a
    lane each), a private flash lane a host in host order when there is
    flash, and rows of at most :data:`MAX_SHARD_HOPS` hops.  Raises
    ``ValueError`` otherwise."""
    H = cfg.num_hosts
    if not 1 <= shards <= MAX_SHARDS or H % shards:
        raise ValueError(f"shards must divide the {H} hosts and lie in [1, "
                         f"{MAX_SHARDS}], got {shards}")
    if not cfg.mounts or cfg.num_devs != H:
        raise ValueError("a sharded replay takes per-host fabric mounts, "
                         "one device a host")
    if cfg.n_flash and not np.array_equal(
            np.asarray(params["flash_of"]), np.arange(H)):
        raise ValueError("a sharded replay takes a private flash lane a "
                         "host, in host order")
    if cfg.max_hops > MAX_SHARD_HOPS:
        raise ValueError(f"a sharded replay's rows take at most "
                         f"{MAX_SHARD_HOPS} hops, got {cfg.max_hops}")


def replay_sharded(cfg, shards: int, params: Dict, state: Dict,
                   addrs: torch.Tensor, writes: torch.Tensor,
                   lens: torch.Tensor, devs: torch.Tensor,
                   routes: Optional[torch.Tensor] = None, *,
                   start_tick: int = 0,
                   retries: Optional[torch.Tensor] = None):
    """:func:`replay_multi` with the hosts split over ``shards`` blocks of
    ``H / shards`` hosts (host ``i`` in block ``i // (H / shards)``), as
    the JAX package's ``ShardedMultiHostReplay`` splits them over its
    devices: on the card one launch of the kernel's sharded instance, a
    thread-block cluster of ``shards`` CTAs, a shard each; on the CPU
    :func:`replay_sharded_plain`.  Takes and returns what
    :func:`replay_multi` does (no carry: a sharded replay is one shot) and
    equals it step for step.  Raises ``ValueError`` where it does and on
    shapes :func:`check_shardable` refuses, and ``ReplayUnsupported`` when
    the card cannot hold a cluster of ``shards`` CTAs of the layout."""
    check_shardable(cfg, params, shards)
    n = _check_multi(cfg, params, state, addrs, writes, lens, devs, routes,
                     retries)
    if addrs.device.type == "cpu":
        return replay_sharded_plain(cfg, shards, params, state, addrs,
                                    writes, lens, devs, routes,
                                    start_tick=start_tick, retries=retries)
    return _launch_sharded(cfg, shards, params, state, addrs, writes, lens,
                           devs, routes, retries, start_tick, n)


def sharded_fit(lib, cfg, params: Dict, shards: int, smem_bytes: int):
    """``(active, largest)`` on the current card: the clusters of
    ``shards`` CTAs of ``smem_bytes`` each of the sharded instance that
    can be resident at once, and its largest launchable cluster."""
    args, _ = multi_arg_blocks(cfg, params, 1, 0, 1, shards=shards)
    active, largest = ctypes.c_int(0), ctypes.c_int(0)
    _raise_on(lib, lib.replay_scan_sharded_fit(
        shards, args.ctypes.data, smem_bytes, ctypes.byref(active),
        ctypes.byref(largest)), "cudaOccupancyMaxActiveClusters")
    return active.value, largest.value


def _launch_sharded(cfg, shards, params, state, addrs, writes, lens, devs,
                    routes, retries, start_tick, n):
    """Launch the sharded instance on the tensors' card, on PyTorch's
    current stream, after checking that its cluster can be resident."""
    from repro_torch.core.replay.spec import ReplayUnsupported
    from repro_torch.kernels import _build

    dev = addrs.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if cfg.outstanding > MAX_OUTSTANDING:
        raise ValueError(f"outstanding={cfg.outstanding} exceeds the "
                         f"kernel's {MAX_OUTSTANDING} LFB slots")
    lib = _build.library("replay_scan")
    _check_lib(lib)
    with torch.cuda.device(dev):
        lay = layout_multi(cfg, params,
                           _smem_optin(lib, torch.cuda.current_device()),
                           shards=shards)
        active, largest = sharded_fit(lib, cfg, params, shards,
                                      lay.smem_bytes)
        if active < 1 or shards > largest:
            raise ReplayUnsupported(
                f"a cluster of {shards} CTAs of {lay.smem_bytes} B of shared"
                f" memory each cannot be resident on this card (its largest"
                f" is {largest} CTAs); use fewer shards")
        err, out = call_launch_sharded(
            lib, cfg, shards, params, state, addrs, writes, lens, devs,
            routes, start_tick, lay,
            torch.cuda.current_stream(dev).cuda_stream, retries=retries, n=n)
        _raise_on(lib, err, "replay_scan (sharded) kernel launch")
        LAUNCHES["replay_scan"] += 1
    return out


def call_launch_sharded(lib, cfg, shards, params, state, addrs, writes,
                        lens, devs, routes, start_tick, lay: Layout, stream,
                        retries=None, n=None):
    """Pack a sharded replay's argument blocks, its tables (a row a
    shard), its trace columns (each access's row in its shard's table),
    layout and shard strides, call ``lib.replay_scan_launch_sharded`` on
    them and the tensors' device, and copy the lanes' scalars back.
    Returns the call's return code and ``(who, issues, dones, flags, qacc,
    qthr)``.  :func:`_launch_sharded` calls it with the CUDA library; a
    host build of the same source (``REPLAY_SCAN_EMULATE``) takes CPU
    tensors."""
    dev = addrs.device
    H, L = addrs.shape
    S = shards
    if n is None:
        n = int(lens.sum())
    P, D, F = cfg.num_ports, cfg.num_devs, cfg.n_flash
    Hl, Fl = H // S, F // S
    md, fl = state["media"], state["flash"] or {}
    lens_np = lens.cpu().numpy()
    args, margs = multi_arg_blocks(cfg, params, n, start_tick, L, shards=S)
    words = np.asarray(lay.words, np.int64)
    _, local, _ = shard_rows(cfg, params, S)
    rows = torch.from_numpy(local).to(dev)[
        multi_rows(cfg, devs, routes).long()]
    t = {"addrs": addrs.contiguous(),
         "aux": ((rows << 1) | writes.long()).to(torch.int32).contiguous(),
         "rt": None if retries is None else _packed_retries(cfg, retries),
         "mtab": torch.from_numpy(shard_tables(cfg, params, lens_np,
                                               S)).to(dev),
         "scratch": torch.empty((S, max(16, lay.scratch_bytes)),
                                dtype=torch.uint8, device=dev)}
    # the lanes' scalars a shard: its media lanes' rows, then its flash
    # lanes'
    NS = len(SCALARS)
    flat = _multi_scalars_in(md, fl, (), D, F, dev)
    scal = t["scal"] = torch.cat(
        [flat[:D].reshape(S, Hl, NS), flat[D:].reshape(S, Fl, NS)], 1
    ).contiguous()
    t.update({k: md.get(k) for k in MEDIA_ARRAYS})
    t.update({k: fl.get(k) for k in FLASH_ARRAYS})
    strides = _lane_strides(MULTI_SWEEP_PTRS, t, S)
    who = torch.empty(n, dtype=torch.int32, device=dev)
    issues = torch.empty(n, dtype=torch.int64, device=dev)
    dones = torch.empty(n, dtype=torch.int64, device=dev)
    flags = torch.empty(n, dtype=torch.int32, device=dev)
    totals = torch.empty(2 * P, dtype=torch.int64, device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = lib.replay_scan_launch_sharded(
        S, args.ctypes.data, margs.ctypes.data, words.ctypes.data,
        strides.ctypes.data, t["mtab"].data_ptr(), t["addrs"].data_ptr(),
        t["aux"].data_ptr(), ptr(t["rt"]), who.data_ptr(), issues.data_ptr(),
        dones.data_ptr(), flags.data_ptr(), totals.data_ptr(),
        scal.data_ptr(), *(ptr(md.get(k)) for k in MEDIA_ARRAYS),
        *(ptr(fl.get(k)) for k in FLASH_ARRAYS), t["scratch"].data_ptr(),
        lay.smem_bytes, stream)
    if err == 0:
        _multi_scalars_out(md, fl, torch.cat(
            [scal[:, :Hl].reshape(D, NS), scal[:, Hl:].reshape(F, NS)]), D)
    return err, (who, issues, dones, flags, totals[:P], totals[P:])


# ------------------------------------------------------------- the sweeps
# the pointers a sweep lane moves by its lane stride (`Ptrs` and
# `MultiPtrs` in csrc/replay_scan.cu, field for field)
SWEEP_PTRS = (("addrs", "writes", "routes", "retries", "tables", "issues",
               "dones", "flags", "totals", "scal") + MEDIA_ARRAYS
              + FLASH_ARRAYS + ("scratch", "carry", "maps"))
MULTI_SWEEP_PTRS = (("addrs", "aux", "rt", "mtab", "who", "issues", "dones",
                     "flags", "totals", "scal") + MEDIA_ARRAYS
                    + FLASH_ARRAYS + ("scratch", "carry", "maps"))


def lane_state(state: Dict, k: int) -> Dict:
    """Lane ``k`` of a sweep's lane-stacked state, as views (a replay of
    the lane writes through to the stack)."""
    return {"media": stack.lane(state["media"], k),
            "flash": stack.lane(state["flash"], k)}


def _lane_strides(names, tensors: Dict, lanes: int) -> np.ndarray:
    """Each pointer's lane stride in elements: ``numel / lanes`` of a
    tensor with a leading lane axis, 0 for a shared or absent one."""
    out = []
    for name in names:
        x = tensors.get(name)
        out.append(0 if x is None else x.numel() // lanes)
    return np.asarray(out, np.int64)


def _check_sweep(cfg: StackConfig, lanes, state: Dict, addrs: torch.Tensor,
                 writes: torch.Tensor) -> None:
    """The shape, type and value checks of :func:`replay_sweep` (one read
    from the tensors' device)."""
    B = len(lanes)
    if cfg.kind != SSD_CACHE or not cfg.cache_assoc:
        raise ValueError("replay_sweep sweeps a fully associative (lru / "
                         "fifo) cached CXL-SSD")
    if cfg.num_routes > 1 or cfg.fault_hops:
        raise ValueError("a sweep lane takes no route column: no ECMP and "
                         "no transport faults")
    if B < 1:
        raise ValueError("a sweep needs >= 1 lane")
    shared = addrs.dim() == 1
    if addrs.dtype != torch.int64 or addrs.dim() not in (1, 2) or (
            not shared and addrs.shape[0] != B) or addrs.shape[-1] < 1:
        raise ValueError(f"addrs must be a non-empty (N,) or ({B}, N) int64 "
                         f"tensor, got {addrs.dtype} {tuple(addrs.shape)}")
    n = addrs.shape[-1]
    if n > MAX_ACCESSES:
        raise ValueError(f"{n} accesses exceed the packed stamp's "
                         f"{MAX_ACCESSES}")
    if writes.dtype != torch.bool or writes.shape != addrs.shape:
        raise ValueError(f"writes must be a {tuple(addrs.shape)} bool "
                         "tensor")
    caps = [int(np.asarray(p["cap"])) for p in lanes]
    if not all(1 <= c <= cfg.cache_frames for c in caps):
        raise ValueError(f"each lane's cap must lie in [1, "
                         f"{cfg.cache_frames}], got {caps}")
    for part in ("media", "flash"):
        for k, x in (state[part] or {}).items():
            if x.device != addrs.device or x.shape[0] != B:
                raise ValueError(f"state {part}.{k} must be on "
                                 f"{addrs.device} with a leading axis of "
                                 f"{B} lanes")
    top = cfg.num_pages * cfg.page_bytes
    want = torch.stack([stack.capacity_frames(cfg, c, addrs.device)
                        for c in caps])
    bad = torch.stack([(addrs < 0).any() | (addrs >= top).any(),
                       (state["media"]["frames"] != want).any()]).tolist()
    if bad[0]:
        raise ValueError(f"addresses must be >= 0 and below {top} "
                         f"({cfg.num_pages} pages, as build_stack sizes "
                         "l2p)")
    if bad[1]:
        raise ValueError(
            "a sweep lane starts from a fresh cache of its capacity: its "
            "first cap frames free (-1) and the rest DISABLED, as "
            "stack.init_sweep makes them")


def replay_sweep(cfg: StackConfig, lanes, state: Dict, addrs: torch.Tensor,
                 writes: torch.Tensor):
    """Replay ``B = len(lanes)`` configurations of one cached stack in one
    launch, one block a lane.  ``lanes`` holds each lane's params dict
    (its cache capacity ``cap``, ``is_lru`` and any tick constant may
    differ; the statics ``cfg`` are shared); ``state`` is the lanes'
    state with a leading lane axis (:func:`repro_torch.core.replay.stack.
    init_sweep`), which ends as their final states; ``addrs`` / ``writes``
    are ``(N,)``, shared by every lane, or ``(B, N)``, a trace a lane.

    Lane *k* equals :func:`replay_scan` of its configuration alone.
    Returns ``(issues, dones, flags, qacc, qthr)``, each with the lane
    axis first (``(B, N)``, ``(B, ports)``).  Raises ``ValueError`` on a
    stack other than a fully associative cached CXL-SSD on a fixed route,
    on addresses outside the stack's pages, and on frames that are not a
    fresh cache of the lane's capacity."""
    _check_sweep(cfg, lanes, state, addrs, writes)
    if addrs.device.type == "cpu":
        return replay_sweep_plain(cfg, lanes, state, addrs, writes)
    return _launch_sweep(cfg, lanes, state, addrs, writes)


def replay_sweep_plain(cfg: StackConfig, lanes, state: Dict,
                       addrs: torch.Tensor, writes: torch.Tensor):
    """Plain version of :func:`replay_sweep`: :func:`replay_scan_plain`
    on each lane in turn, over the lane's views of ``state``."""
    outs = []
    for k, p in enumerate(lanes):
        a = addrs if addrs.dim() == 1 else addrs[k]
        w = writes if writes.dim() == 1 else writes[k]
        outs.append(replay_scan_plain(cfg, p, lane_state(state, k), a, w))
    return tuple(torch.stack([o[j] for o in outs]) for j in range(5))


def sweep_layout(cfg: StackConfig, lanes, budget: int, *,
                 placed: bool = True) -> Layout:
    """One layout for every lane of a sweep: :func:`layout` over their
    union (the recency links placed when any lane is LRU)."""
    union = {**lanes[0],
             "is_lru": any(bool(np.asarray(p["is_lru"])) for p in lanes)}
    return layout(cfg, union, budget, placed=placed)


def _check_lib(lib) -> None:
    if (lib.replay_scan_num_args(), lib.replay_scan_layout_words(),
            lib.replay_scan_num_margs(), lib.replay_scan_layout_multi_words(),
            lib.replay_scan_num_ptrs()) != (
            len(ARGS), len(LAYOUT), len(MARGS), len(LAYOUT_MULTI),
            len(SWEEP_PTRS)):
        raise RuntimeError("the kernel's argument blocks, layouts or sweep "
                           "pointers differ from the wrapper's")


def _launch_sweep(cfg, lanes, state, addrs, writes):
    """Launch the sweep instance on the tensors' card, on PyTorch's
    current stream."""
    from repro_torch.kernels import _build

    dev = addrs.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if cfg.outstanding > MAX_OUTSTANDING:
        raise ValueError(f"outstanding={cfg.outstanding} exceeds the "
                         f"kernel's {MAX_OUTSTANDING} LFB slots")
    lib = _build.library("replay_scan")
    _check_lib(lib)
    with torch.cuda.device(dev):
        lay = sweep_layout(cfg, lanes,
                           _smem_optin(lib, torch.cuda.current_device()))
        err, out = call_launch_sweep(
            lib, cfg, lanes, state, addrs, writes, lay,
            torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(lib, err, "replay_scan (sweep) kernel launch")
        LAUNCHES["replay_scan"] += 1
    return out


def call_launch_sweep(lib, cfg, lanes, state, addrs, writes, lay: Layout,
                      stream):
    """Pack a sweep's argument blocks (a row a lane), route tables, layout
    and lane strides, call ``lib.replay_scan_launch_sweep`` on them and
    the tensors' device, and copy the lanes' scalars back.  Returns the
    call's return code and ``(issues, dones, flags, qacc, qthr)`` with the
    lane axis first.  :func:`_launch_sweep` calls it with the CUDA
    library; a host build of the same source (``REPLAY_SCAN_EMULATE``)
    takes CPU tensors."""
    dev = addrs.device
    B, n, P = len(lanes), addrs.shape[-1], cfg.num_ports
    md, fl = state["media"], state["flash"] or {}
    blocks = np.stack([arg_block(cfg, p, n, 0) for p in lanes])
    head = blocks[0]
    args = torch.from_numpy(blocks).to(dev)
    words = np.asarray(lay.words, np.int64)
    t = {"addrs": None if addrs.dim() == 1 else addrs.contiguous(),
         "writes": None if writes.dim() == 1 else writes,
         "tables": torch.from_numpy(np.stack([route_tables(cfg, p)
                                              for p in lanes])).to(dev),
         "issues": torch.empty((B, n), dtype=torch.int64, device=dev),
         "dones": torch.empty((B, n), dtype=torch.int64, device=dev),
         "flags": torch.empty((B, n), dtype=torch.int32, device=dev),
         "totals": torch.empty((B, 2 * P), dtype=torch.int64, device=dev),
         "scal": _scalars_in(md, fl, (B,), dev),
         "scratch": torch.empty((B, max(16, lay.scratch_bytes)),
                                dtype=torch.uint8, device=dev)}
    t.update({k: md.get(k) for k in MEDIA_ARRAYS})
    t.update({k: fl.get(k) for k in FLASH_ARRAYS})
    strides = _lane_strides(SWEEP_PTRS, t, B)
    addrs = addrs.contiguous()

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = lib.replay_scan_launch_sweep(
        B, head.ctypes.data, args.data_ptr(), words.ctypes.data,
        strides.ctypes.data, t["tables"].data_ptr(), addrs.data_ptr(),
        writes.view(torch.uint8).data_ptr(),
        *(t[k].data_ptr() for k in ("issues", "dones", "flags", "totals",
                                    "scal")),
        *(ptr(md.get(k)) for k in MEDIA_ARRAYS),
        *(ptr(fl.get(k)) for k in FLASH_ARRAYS), t["scratch"].data_ptr(),
        lay.smem_bytes, stream)
    if err == 0:
        _scalars_out(md, fl, t["scal"])
    totals = t["totals"]
    return err, (t["issues"], t["dones"], t["flags"], totals[:, :P],
                 totals[:, P:])


# ------------------------------------------------- the multi-host sweeps
def _lane_cols(x: Optional[torch.Tensor], k: int, dims: int):
    """Lane ``k``'s column of ``x``: ``x`` itself when it is shared (of
    ``dims`` dimensions), else its row ``k``."""
    if x is None or x.dim() == dims:
        return x
    return x[k]


def _check_multi_sweep(cfg, params: Dict, state: Dict, addrs, writes, lens,
                       devs, routes, retries) -> list:
    """The checks of :func:`replay_multi_sweep`; returns each lane's
    steps."""
    if lens.dtype != torch.int64 or lens.dim() != 2 or lens.shape[1] != \
            cfg.num_hosts or lens.shape[0] < 1:
        raise ValueError(f"lens must be a (lanes, {cfg.num_hosts}) int64 "
                         "tensor")
    B = lens.shape[0]
    for name, x, dims in (("routes", routes, 2), ("retries", retries, 3)):
        if x is not None and x.dim() == dims + 1 and x.shape[0] != B:
            raise ValueError(f"{name} must be shared or have a row a lane")
    for part in ("media", "flash"):
        for k, x in (state[part] or {}).items():
            if x.device != addrs.device or x.shape[0] != B:
                raise ValueError(f"state {part}.{k} must be on "
                                 f"{addrs.device} with a leading axis of "
                                 f"{B} lanes")
    steps = []
    for k, n in enumerate(lens.sum(1).tolist()):
        if n == 0 and int(lens[k].min()) == 0:
            steps.append(0)         # an empty lane replays nothing
            continue
        steps.append(_check_multi(
            cfg, params, lane_state(state, k), addrs, writes, lens[k], devs,
            _lane_cols(routes, k, 2), _lane_cols(retries, k, 3)))
    return steps


def replay_multi_sweep(cfg, params: Dict, state: Dict, addrs: torch.Tensor,
                       writes: torch.Tensor, lens: torch.Tensor,
                       devs: torch.Tensor,
                       routes: Optional[torch.Tensor] = None, *,
                       retries: Optional[torch.Tensor] = None):
    """Replay ``B`` lanes of one multi-host stack in one launch, one
    block a lane: lane *k* is :func:`replay_multi` of the hosts' trace
    lengths ``lens[k]`` (``lens`` ``(B, H)`` int64; a host of length 0
    issues nothing), with ``routes`` / ``retries`` shared (``(H, L)``,
    ``(H, L, hops)``) or a row a lane (``(B, H, L)``, ...: a path id and
    retry bytes a lane, into the one path table of ``params``).
    ``addrs``, ``writes`` and ``devs`` are shared; ``state`` is every
    lane's lane-stacked state (:func:`repro_torch.core.replay.stack.
    init_multi_sweep`), which ends as their final states.

    Returns ``(who, issues, dones, flags, qacc, qthr)`` with the lane axis
    first: the step columns ``(B, S)``, ``S`` the most steps of a lane
    (lane *k* fills its first ``sum(lens[k])``, zeros after), and the
    ports' totals ``(B, ports)``.  Raises ``ValueError`` where
    :func:`replay_multi` does, lane by lane."""
    steps = _check_multi_sweep(cfg, params, state, addrs, writes, lens, devs,
                               routes, retries)
    if addrs.device.type == "cpu":
        return replay_multi_sweep_plain(cfg, params, state, addrs, writes,
                                        lens, devs, routes, retries=retries)
    return _launch_multi_sweep(cfg, params, state, addrs, writes, lens, devs,
                               routes, retries, steps)


def replay_multi_sweep_plain(cfg, params: Dict, state: Dict,
                             addrs: torch.Tensor, writes: torch.Tensor,
                             lens: torch.Tensor, devs: torch.Tensor,
                             routes: Optional[torch.Tensor] = None, *,
                             retries: Optional[torch.Tensor] = None):
    """Plain version of :func:`replay_multi_sweep`:
    :func:`replay_multi_plain` on each lane in turn, its step columns
    padded with zeros to the longest lane's."""
    outs = [replay_multi_plain(cfg, params, lane_state(state, k), addrs,
                               writes, lens[k], devs,
                               _lane_cols(routes, k, 2),
                               retries=_lane_cols(retries, k, 3))
            for k in range(lens.shape[0])]
    S = max(o[0].numel() for o in outs)

    def pad(x):
        return torch.cat([x, x.new_zeros(S - x.numel())])

    return tuple(torch.stack([pad(o[j]) if j < 4 else o[j] for o in outs])
                 for j in range(6))


def _launch_multi_sweep(cfg, params, state, addrs, writes, lens, devs,
                        routes, retries, steps):
    """Launch the multi-host sweep instance on the tensors' card, on
    PyTorch's current stream."""
    from repro_torch.kernels import _build

    dev = addrs.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if cfg.outstanding > MAX_OUTSTANDING:
        raise ValueError(f"outstanding={cfg.outstanding} exceeds the "
                         f"kernel's {MAX_OUTSTANDING} LFB slots")
    lib = _build.library("replay_scan")
    _check_lib(lib)
    with torch.cuda.device(dev):
        lay = layout_multi(cfg, params,
                           _smem_optin(lib, torch.cuda.current_device()))
        err, out = call_launch_multi_sweep(
            lib, cfg, params, state, addrs, writes, lens, devs, routes, lay,
            torch.cuda.current_stream(dev).cuda_stream, retries=retries,
            steps=steps)
        _raise_on(lib, err, "replay_scan (multi-host sweep) kernel launch")
        LAUNCHES["replay_scan"] += 1
    return out


def call_launch_multi_sweep(lib, cfg, params, state, addrs, writes, lens,
                            devs, routes, lay: Layout, stream, retries=None,
                            steps=None):
    """Pack a multi-host sweep's argument blocks and tables (a row a
    lane), its trace columns (shared, or a row a lane), layout and lane
    strides, call ``lib.replay_scan_launch_multi_sweep`` on them and the
    tensors' device, and copy the lanes' scalars back.  Returns the
    call's return code and ``(who, issues, dones, flags, qacc, qthr)``
    with the lane axis first.  :func:`_launch_multi_sweep` calls it with
    the CUDA library; a host build of the same source takes CPU
    tensors."""
    dev = addrs.device
    H, L = addrs.shape
    B = lens.shape[0]
    lens_np = lens.cpu().numpy()
    if steps is None:
        steps = [int(x) for x in lens_np.sum(1)]
    S = max(steps)
    P, D, F = cfg.num_ports, cfg.num_devs, cfg.n_flash
    md, fl = state["media"], state["flash"] or {}
    blocks = [multi_arg_blocks(cfg, params, steps[k], 0, L)
              for k in range(B)]
    head, margs = blocks[0]
    args = torch.from_numpy(np.stack([b[0] for b in blocks])).to(dev)
    words = np.asarray(lay.words, np.int64)

    per_lane_routes = routes is not None and routes.dim() == 3
    aux = (torch.stack([_multi_aux(cfg, devs, routes[k], writes)
                        for k in range(B)])
           if per_lane_routes else _multi_aux(cfg, devs, routes, writes))
    rt = None if retries is None else _packed_retries(cfg, retries)
    t = {"aux": aux if aux.dim() == 3 else None,
         "rt": rt if rt is not None and rt.dim() == 3 else None,
         "mtab": torch.from_numpy(np.stack([
             kernel_table(cfg, params, lens_np[k]) for k in range(B)])).to(
                 dev),
         "who": torch.zeros((B, S), dtype=torch.int32, device=dev),
         "issues": torch.zeros((B, S), dtype=torch.int64, device=dev),
         "dones": torch.zeros((B, S), dtype=torch.int64, device=dev),
         "flags": torch.zeros((B, S), dtype=torch.int32, device=dev),
         "totals": torch.empty((B, 2 * P), dtype=torch.int64, device=dev),
         "scratch": torch.empty((B, max(16, lay.scratch_bytes)),
                                dtype=torch.uint8, device=dev)}
    scal = t["scal"] = _multi_scalars_in(md, fl, (B,), D, F, dev)
    t.update({k: md.get(k) for k in MEDIA_ARRAYS})
    t.update({k: fl.get(k) for k in FLASH_ARRAYS})
    strides = _lane_strides(MULTI_SWEEP_PTRS, t, B)
    addrs = addrs.contiguous()

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = lib.replay_scan_launch_multi_sweep(
        B, head.ctypes.data, args.data_ptr(), margs.ctypes.data,
        words.ctypes.data, strides.ctypes.data, t["mtab"].data_ptr(),
        addrs.data_ptr(), aux.data_ptr(), ptr(rt),
        *(t[k].data_ptr() for k in ("who", "issues", "dones", "flags",
                                    "totals")),
        scal.data_ptr(), *(ptr(md.get(k)) for k in MEDIA_ARRAYS),
        *(ptr(fl.get(k)) for k in FLASH_ARRAYS), t["scratch"].data_ptr(),
        lay.smem_bytes, stream)
    if err == 0:
        _multi_scalars_out(md, fl, scal, D)
    totals = t["totals"]
    return err, (t["who"], t["issues"], t["dones"], t["flags"],
                 totals[:, :P], totals[:, P:])
