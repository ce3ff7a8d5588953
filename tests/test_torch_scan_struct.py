"""The ``replay_scan`` kernel's frame structures and layout, on the CPU.

The kernel finds a page's frame through a page-indexed map and its victim
through a fill pointer and a doubly linked recency list (LRU) or a
round-robin pointer (FIFO), where the reference takes the first match and
the ``argmin`` over packed ``stamp << 39 | page << 1 | dirty`` words
(``stack.py``'s ``_buf_step`` / ``_cache_step``).  :class:`FrameModel`
replays the kernel's ``victim`` / ``insert`` / ``to_tail`` step by step
(``csrc/replay_scan.cu``, ``struct Chain``); under hypothesis it must
agree with the packed words' first match and ``argmin``, ties included,
from a fresh cache.  The wrapper refuses any other start, and the layout
it computes for the kernel is checked here too.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core.cache.dram_cache import DRAMCacheConfig
from repro_torch.core.devices import make_device
from repro_torch.core.fabric import Fabric
from repro_torch.core.replay import stack
from repro_torch.core.replay.spec import build_stack
from repro_torch.kernels import replay_scan as rs
from test_torch_scan_emulate import H100_SMEM_OPTIN

SHIFT = stack.STAMP_SHIFT
PAGE_FIELD = stack.PAGE_FIELD
STAMP_FIELD = stack.STAMP_FIELD


class FrameModel:
    """The kernel's structures for ``n`` fully associative frames: the
    packed words, ``where[page]``, ``links[f] = [prev, next]``, ``head`` /
    ``tail`` and the fill pointer (LRU: frames taken so far; FIFO: in
    [n, 2n) once full, the victim being fill - n)."""

    def __init__(self, n: int, lru: bool):
        self.n, self.lru = n, lru
        self.frames = [-1] * n
        self.where: dict[int, int] = {}
        self.links = [[-1, -1] for _ in range(n)]
        self.head = self.tail = -1
        self.fill = 0

    def victim(self) -> int:
        if self.fill < self.n:
            return self.fill
        return self.head if self.lru else self.fill - self.n

    def to_tail(self, f: int) -> None:
        if f == self.tail:
            return
        prev, nxt = self.links[f]
        if prev >= 0:
            self.links[prev][1] = nxt
        else:
            self.head = nxt
        self.links[nxt][0] = prev
        self.links[f] = [self.tail, -1]
        self.links[self.tail][1] = f
        self.tail = f

    def insert(self, v: int, vval: int, page: int) -> None:
        if vval >= 0:
            del self.where[(vval & PAGE_FIELD) >> 1]
        self.where[page] = v
        if self.lru:
            if self.fill < self.n:
                self.links[v] = [self.tail, -1]
                if self.tail >= 0:
                    self.links[self.tail][1] = v
                else:
                    self.head = v
                self.tail = v
                self.fill += 1
            else:
                self.to_tail(v)
        else:
            self.fill = self.n if self.fill + 1 == 2 * self.n else self.fill + 1

    def touch(self, f: int, page: int, wr: bool, ctr: int) -> None:
        old = self.frames[f]
        stamp = ctr << SHIFT if self.lru else old & STAMP_FIELD
        self.frames[f] = stamp | page << 1 | (old & 1) | int(wr)
        if self.lru:
            self.to_tail(f)

    def miss(self, page: int, wr: bool, ctr: int) -> int:
        v = self.victim()
        vval = self.frames[v]
        self.frames[v] = ctr << SHIFT | page << 1 | int(wr)
        self.insert(v, vval, page)
        return v


def reference_victim(frames: list) -> int:
    """``argmin`` over the packed words, the lowest index on ties."""
    return int(np.argmin(np.asarray(frames, np.int64)))


def reference_match(frames: list, page: int) -> int:
    """The first valid frame holding ``page``, or -1."""
    for i, x in enumerate(frames):
        if x >= 0 and (x & PAGE_FIELD) == page << 1:
            return i
    return -1


@settings(max_examples=300, deadline=None)
@given(n=st.integers(1, 8), lru=st.booleans(), pages=st.integers(1, 20),
       steps=st.lists(st.tuples(st.integers(0, 10**6), st.booleans(),
                                st.booleans()), min_size=1, max_size=120))
def test_map_list_and_fill_pointer_equal_the_packed_argmin(n, lru, pages,
                                                          steps):
    """Hit: the map's frame is the first match and the touch (LRU restamp,
    FIFO keeps the stamp) leaves the same words; miss: the victim is the
    packed ``argmin``; a coalesced access touches only a resident page on
    a store, as ``_cache_step`` does."""
    model = FrameModel(n, lru)
    want = [-1] * n
    for i, (draw, wr, coalesced) in enumerate(steps):
        page, ctr = draw % pages, i + 1
        f = model.where.get(page, -1)
        assert f == reference_match(want, page)
        if coalesced:
            if f >= 0 and wr:
                model.touch(f, page, wr, ctr)
                old = want[f]
                stamp = ctr << SHIFT if lru else old & STAMP_FIELD
                want[f] = stamp | page << 1 | (old & 1) | int(wr)
        elif f >= 0:
            model.touch(f, page, wr, ctr)
            old = want[f]
            stamp = ctr << SHIFT if lru else old & STAMP_FIELD
            want[f] = stamp | page << 1 | (old & 1) | int(wr)
        else:
            v = reference_victim(want)
            assert model.victim() == v
            assert model.miss(page, wr, ctr) == v
            want[v] = ctr << SHIFT | page << 1 | int(wr)
        assert model.frames == want
        assert model.victim() == reference_victim(want)
        if lru and model.fill:
            # the list runs from the least to the most recent stamp
            order, f = [], model.head
            while f >= 0:
                order.append(f)
                f = model.links[f][1]
            assert len(order) == model.fill
            assert [want[g] >> SHIFT for g in order] == sorted(
                want[g] >> SHIFT for g in order)


def _table1(device="cxl-ssd-cache", **kw):
    return build_stack(make_device(device, **kw), size=64, outstanding=32,
                       issue_overhead_ns=0.5, posted_writes=True,
                       n_accesses=1 << 20, max_addr=16384 * 4096 - 64)


@pytest.mark.parametrize("device", ["cxl-ssd", "cxl-ssd-cache"])
def test_wrapper_refuses_a_cache_that_is_not_fresh(device):
    cfg, params = _table1(device)
    state = stack.init_state(cfg, "cpu")
    state["media"]["frames"][1] = (5 << SHIFT) | (7 << 1)
    addrs = torch.tensor([4096, 8192], dtype=torch.int64)
    writes = torch.tensor([True, False])
    with pytest.raises(ValueError, match="fresh cache"):
        rs.replay_scan(cfg, params, state, addrs, writes)
    # a direct-mapped cache keeps no victim order: any state replays
    cfg, params = _table1(cache_cfg=DRAMCacheConfig(policy="direct"))
    state = stack.init_state(cfg, "cpu")
    state["media"]["frames"][1] = (5 << SHIFT) | (7 << 1)
    rs.replay_scan(cfg, params, state, addrs, writes)


def test_wrapper_refuses_addresses_and_routes_out_of_range():
    cfg, params = _table1()
    writes = torch.tensor([False])
    for addr in (-64, cfg.num_pages * cfg.page_bytes):
        with pytest.raises(ValueError, match="addresses"):
            rs.replay_scan(cfg, params, stack.init_state(cfg, "cpu"),
                           torch.tensor([addr], dtype=torch.int64), writes)
    fab = Fabric.build("spine_leaf", num_hosts=2, num_devices=2,
                       num_leaves=2, num_spines=2, ecmp=True)
    cfg, params = build_stack(fab.mount("h0", "d0", make_device("dram")),
                              size=64, outstanding=4, issue_overhead_ns=0.5,
                              posted_writes=True, n_accesses=1, max_addr=0)
    assert cfg.num_routes > 1
    for route in (-1, cfg.num_routes):
        with pytest.raises(ValueError, match="routes"):
            rs.replay_scan(cfg, params, stack.init_state(cfg, "cpu"),
                           torch.tensor([0], dtype=torch.int64), writes,
                           torch.tensor([route], dtype=torch.int32))


def test_table1_layout_keeps_every_access_in_shared_memory():
    """Table I's cached CXL-SSD over chip_smoke.py's 16,384 pages: the map,
    frames, links and l2p all in shared memory, 216,976 bytes, as the
    kernel's header says; the device-memory layout puts the map and links
    in the scratch tensor and leaves the rest in the state."""
    cfg, params = _table1()
    lay = rs.layout(cfg, params, H100_SMEM_OPTIN)
    assert lay.in_smem == ("where", "frames", "links", "l2p")
    assert lay.smem_bytes == 216_976 and lay.scratch_bytes == 0
    words = dict(zip(rs.LAYOUT, lay.words))
    assert words["chunk"] == rs.CHUNK and words["leaves"] == 32
    assert all(words[k] >= 0 and words[k] % 16 == 0
               for k in rs.LAYOUT[2:rs.LAYOUT.index("valid")])
    glob = dict(zip(rs.LAYOUT, rs.layout(cfg, params, H100_SMEM_OPTIN,
                                         placed=False).words))
    assert (glob["where"], glob["links"]) == (-1, -1 - 4 * cfg.num_pages)
    assert glob["frames"] == glob["l2p"] == -1
    assert glob["valid"] == glob["p2l"] == -1       # no GC on this stack


def test_layout_leaves_what_does_not_fit_in_device_memory():
    cfg, params = _table1(cache_cfg=DRAMCacheConfig(
        capacity_bytes=32768 * 4096))                  # 256 KB of frames
    lay = rs.layout(cfg, params, H100_SMEM_OPTIN)
    assert "frames" not in lay.in_smem and lay.smem_bytes <= H100_SMEM_OPTIN
    # a FIFO cache keeps no recency list
    cfg, params = _table1(cache_cfg=DRAMCacheConfig(policy="fifo"))
    assert "links" not in rs.layout(cfg, params, H100_SMEM_OPTIN).in_smem
    cfg, params = build_stack(make_device("dram"), size=64, outstanding=4096,
                              issue_overhead_ns=0.5, posted_writes=True,
                              n_accesses=8, max_addr=0)
    with pytest.raises(ValueError, match="more than the"):
        rs.layout(cfg, params, 100_000)


def magic(d: int) -> tuple[int, int]:
    """``Div::set`` of ``csrc/replay_scan.cu``: ``(m, l)`` for divisor d."""
    l = (d - 1).bit_length()
    return ((1 << 32) * ((1 << l) - d)) // d + 1, l


@settings(max_examples=2000, deadline=None)
@given(d=st.one_of(st.integers(1, 64), st.integers(1, (1 << 31) - 1)),
       x=st.one_of(st.integers(0, 4096), st.integers(0, (1 << 31) - 1)))
def test_division_by_multiply_high_is_exact(d, x):
    """The kernel's die, channel and block arithmetic: ``x / d`` as
    ``(umulhi(m, x) + x) >> l`` for every x below 2^31, m within 32 bits
    and the sum too."""
    m, l = magic(d)
    assert 0 < m < 1 << 32
    t = (m * x) >> 32
    assert t + x < 1 << 32
    q = (t + x) >> l
    assert (q, x - q * d) == divmod(x, d)
