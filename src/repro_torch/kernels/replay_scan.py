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

The ``LAUNCHES`` counter counts kernel launches only, so a run can show
that it went through the kernel.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.replay import stack
from repro_torch.core.replay.metrics import FLAG_EVENT_BITS
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
           retries: Optional[torch.Tensor]) -> None:
    n = addrs.shape[0] if addrs.dim() == 1 else -1
    if addrs.dtype != torch.int64 or addrs.dim() != 1 or n < 1:
        raise ValueError(f"addrs must be a non-empty (N,) int64 tensor, got "
                         f"{addrs.dtype} {tuple(addrs.shape)}")
    if n > MAX_ACCESSES:
        raise ValueError(f"{n} accesses exceed the packed stamp's "
                         f"{MAX_ACCESSES}")
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
                  retries: Optional[torch.Tensor]) -> None:
    """The checks that read the tensors (one read from their device): the
    kernel indexes its page map and l2p by the page, and its route tables
    by the route or path, unchecked, charges the retry bytes of a path's
    hops only, and takes a fresh cache only."""
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
    if fully_associative(cfg):
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
            "as stack.init_state makes it; its stamp counter restarts at 1, "
            "so the kernel's victim order equals the reference's only then")


def fully_associative(cfg: StackConfig) -> bool:
    """Whether the stack's frames are fully associative (the CXL-SSD's
    page registers, an LRU or FIFO cache): the kernel keeps a page map and
    a victim order beside them."""
    return cfg.kind == SSD_BUF or (cfg.kind == SSD_CACHE and cfg.cache_assoc)


def replay_scan(cfg: StackConfig, params: Dict, state: Dict,
                addrs: torch.Tensor, writes: torch.Tensor,
                routes: Optional[torch.Tensor] = None, *,
                start_tick: int = 0, retries: Optional[torch.Tensor] = None):
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

    Returns ``(issues, dones, flags, qacc, qthr)``: int64 issue and
    completion ticks and int32 flags per access (bit 0 hit, bit 1 dirty
    evict, then the kind's :data:`FLAG_EVENT_BITS`), and the int64
    queueing ticks and QoS throttle events of each port.

    Raises ``ValueError`` on addresses below 0 or past the stack's
    ``num_pages``, on routes outside the route tables, on retry bytes of
    hops a path does not have, and on the frames of a page-register
    buffer or a fully associative cache that are not all free: the
    kernel's victim order starts from a fresh cache."""
    _check(cfg, state, addrs, writes, routes, retries)
    if addrs.device.type == "cpu":
        _check_values(cfg, params, state, addrs, routes, retries)
        return replay_scan_plain(cfg, params, state, addrs, writes, routes,
                                 start_tick=start_tick, retries=retries)
    return _launch(cfg, params, state, addrs, writes, routes, retries,
                   start_tick)


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
                      retries: Optional[torch.Tensor] = None):
    """Plain version of :func:`replay_scan`: the JAX package's
    ``_scan_chunk`` step (LFB slot recycle, then ``_transport``,
    ``_transport_ecmp`` or the faulted ``_transport_cols`` with the qacc /
    qthr totals) one access per loop step over
    :func:`repro_torch.core.replay.stack.step`.  Runs on any device's
    tensors; the card's main path launches the kernel instead."""
    p = host_params(params)
    a, w = addrs.tolist(), writes.tolist()
    r = routes.tolist() if routes is not None else None
    rt = retries.tolist() if retries is not None else None
    routed = cfg.num_routes > 1 or cfg.fault_hops
    qos = set(cfg.qos_ports)
    bits = FLAG_EVENT_BITS[cfg.kind]
    slots = [start_tick] * cfg.outstanding          # LFB slots
    pb = [0] * cfg.num_ports                         # port busy-until
    vft = [0] * cfg.num_ports                        # QoS virtual finish
    qacc = [0] * cfg.num_ports
    qthr = [0] * cfg.num_ports
    now = start_tick
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
            ctr=i + 1))
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


def _placed_bytes(cfg: StackConfig, params: Dict) -> Dict[str, int]:
    """Bytes of each placed array the stack has, in the order shared
    memory takes them: the frames' map, packed frames and links (the
    recency list of an LRU buffer or cache), then the flash's l2p, and
    the GC's valid counts, free mask, free queue and p2l, and the bitmap
    of blocks a failed erase retired."""
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
    return out


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
    scratch, in_smem = 0, []
    sizes = _placed_bytes(cfg, params)
    for name in PLACED:
        if name not in sizes:
            words[name] = -1
        elif placed and off + -(-sizes[name] // 16) * 16 <= budget:
            words[name] = take(sizes[name])
            in_smem.append(name)
        elif name in SCRATCH:
            words[name] = -1 - scratch
            scratch += -(-sizes[name] // 16) * 16
        else:
            words[name] = -1
    return Layout(tuple(words[k] for k in LAYOUT), off, scratch,
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


def _launch(cfg, params, state, addrs, writes, routes, retries, start_tick):
    """Launch the kernel on the tensors' card, on PyTorch's current
    stream."""
    from repro_torch.kernels import _build

    dev = addrs.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if cfg.outstanding > MAX_OUTSTANDING:
        raise ValueError(f"outstanding={cfg.outstanding} exceeds the "
                         f"kernel's {MAX_OUTSTANDING} LFB slots")
    _check_values(cfg, params, state, addrs, routes, retries)
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
                               retries=retries)
        _raise_on(lib, err, "replay_scan kernel launch")
        LAUNCHES["replay_scan"] += 1
    return out


def call_launch(lib, cfg, params, state, addrs, writes, routes, start_tick,
                lay: Layout, stream, retries=None):
    """Pack one replay's arguments and layout, call
    ``lib.replay_scan_launch`` on them and its tensors' device, and copy
    the state's scalars back.  Returns the call's return code and
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
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    scal = torch.stack([
        (md.get(k) if k in md else fl.get(k, zero)).to(torch.int64)
        for k in SCALARS])
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
        lay.smem_bytes, stream)
    if err == 0:
        for i, k in enumerate(SCALARS):
            part = md if k in md else fl
            if k in part:
                part[k].copy_(scal[i])
    return err, (issues, dones, flags, totals[:P], totals[P:])
