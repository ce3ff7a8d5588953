"""The port's cache-replay kernels against the JAX package.

On the CPU the wrappers run their plain PyTorch versions, so this file holds
those versions against the Pallas kernels (in interpret mode) and their jnp
oracles, on the same numpy inputs.  Every output is an integer or a flag:
the comparisons are exact, with no tolerance.  The CUDA kernels themselves
are held against the same plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro.core.cache import trace_sim as ref_trace_sim
from repro.kernels import cache_sim as ref_kernels
from repro.kernels import ref
from repro_torch.core.cache import trace_sim
from repro_torch.kernels import cache_sim as ks

# (policy, num_sets, ways): fully associative, set associative, direct
SHAPES = [(p, s, w) for p in ("lru", "fifo") for s, w in
          [(1, 16), (1, 64), (16, 4), (64, 1)]] + [("direct", 64, 1)]
TIMING = dict(issue_ns=1, hit_ns=50, miss_ns=5000, miss_occ_ns=213)


def _trace(seed, n, frames, write_frac=0.3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 3 * frames, n).astype(np.int32),
            rng.random(n) < write_frac)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("n", [1500, 777])
@pytest.mark.parametrize("policy,num_sets,ways", SHAPES)
def test_cache_sim_plain_equals_pallas_and_oracle(policy, num_sets, ways, n):
    pages, writes = _trace(11, n, num_sets * ways)
    geo = dict(num_sets=num_sets, ways=ways, policy=policy)
    hits, evicts = ks.cache_sim(torch.from_numpy(pages),
                                torch.from_numpy(writes), **geo)
    kh, ke = ref_kernels.cache_sim(pages, writes, chunk=256, **geo)
    oh, oe = ref.cache_sim_ref(pages, writes, **geo)
    for got, want in [(hits, kh), (evicts, ke), (hits, oh), (evicts, oe)]:
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert hits.dtype == torch.bool and evicts.dtype == torch.bool


@pytest.mark.parametrize("wb_ns", [0, 97])
@pytest.mark.parametrize("outstanding", [1, 8, 32])
@pytest.mark.parametrize("policy,num_sets,ways", SHAPES)
def test_cache_sim_fused_plain_equals_pallas_and_oracle(policy, num_sets,
                                                        ways, outstanding,
                                                        wb_ns):
    pages, writes = _trace(3, 1500, num_sets * ways)
    kw = dict(num_sets=num_sets, ways=ways, policy=policy,
              outstanding=outstanding, wb_ns=wb_ns, **TIMING)
    got = ks.cache_sim_fused(torch.from_numpy(pages),
                             torch.from_numpy(writes), **kw)
    want = ref_kernels.cache_sim_fused(pages, writes, **kw)
    oracle = ref.cache_sim_fused_ref(pages, writes, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    for g, w in zip(got, oracle):              # hits, evicts, latency
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert got[2].dtype == torch.int32 and got[3].dtype == torch.int32


def test_cache_sim_fused_plain_ragged_trace():
    pages, writes = _trace(5, 777, 16)
    kw = dict(num_sets=4, ways=4, policy="lru", outstanding=8, wb_ns=31,
              **TIMING)
    got = ks.cache_sim_fused(torch.from_numpy(pages),
                             torch.from_numpy(writes), **kw)
    want = ref_kernels.cache_sim_fused(pages, writes, chunk=256, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("fn", [ks.cache_sim, ks.cache_sim_fused])
def test_rejects_what_the_reference_rejects(fn):
    pages = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        fn(pages, pages.bool(), num_sets=4, ways=2, policy="2q")
    with pytest.raises(ValueError):
        fn(pages, pages.bool(), num_sets=4, ways=2, policy="direct")
    for bad in (torch.tensor([-1]), torch.tensor([2**31])):
        with pytest.raises(ValueError, match="int32 tag range"):
            fn(bad, torch.zeros(1, dtype=torch.bool), num_sets=1, ways=4)
    no_lanes = torch.zeros((0, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="lanes >= 1"):
        fn(no_lanes, no_lanes.bool(), num_sets=1, ways=4)


@pytest.mark.parametrize("policy,num_sets,ways,outstanding,wb_ns",
                         [("lru", 1, 64, 32, 0), ("fifo", 1, 16, 8, 400),
                          ("direct", 64, 1, 1, 97), ("lru", 16, 4, 4, 5)])
def test_fill_latency_assoc_equals_fused_latency(policy, num_sets, ways,
                                                 outstanding, wb_ns):
    pages, writes = _trace(9, 1500, num_sets * ways, write_frac=0.5)
    kw = dict(TIMING, wb_ns=wb_ns)
    hits, evicts, lat, arr = ks.cache_sim_fused(
        torch.from_numpy(pages), torch.from_numpy(writes), num_sets=num_sets,
        ways=ways, policy=policy, outstanding=outstanding, **kw)
    lat2 = ks.fill_latency_assoc(hits, evicts, arr, hit_ns=kw["hit_ns"],
                                 miss_ns=kw["miss_ns"],
                                 miss_occ_ns=kw["miss_occ_ns"], wb_ns=wb_ns)
    assert lat2.dtype == lat.dtype
    assert torch.equal(lat2, lat)


def test_fill_latency_assoc_without_misses():
    hits = torch.ones(5, dtype=torch.bool)
    lat = ks.fill_latency_assoc(hits, ~hits, torch.arange(5, dtype=torch.int32),
                                hit_ns=50, miss_ns=9, miss_occ_ns=3, wb_ns=1)
    assert lat.tolist() == [50] * 5


@pytest.mark.parametrize("policy,num_sets,ways",
                         [("lru", 8, 4), ("fifo", 8, 4), ("direct", 32, 1)])
def test_trace_cache_sim_state_equals_reference(policy, num_sets, ways):
    pages, writes = _trace(17, 900, num_sets * ways)
    hits, evicts, state = trace_sim.TraceCacheSim(
        num_sets, ways, policy, torch_device="cpu").run(pages, writes)
    rh, re_, rstate = ref_trace_sim.TraceCacheSim(
        num_sets, ways, policy).run(pages, writes)
    np.testing.assert_array_equal(_np(hits), np.asarray(rh))
    np.testing.assert_array_equal(_np(evicts), np.asarray(re_))
    for got, want in zip(state, rstate):          # tags, meta, dirty
        assert tuple(got.shape) == (num_sets, ways)
        assert got.dtype == {np.int32: torch.int32,
                             np.bool_: torch.bool}[np.asarray(want).dtype.type]
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_init_state_matches_reference():
    got = trace_sim.TraceCacheSim(4, 2, torch_device="cpu").init_state()
    want = ref_trace_sim.TraceCacheSim(4, 2).init_state()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("policy,num_sets,ways",
                         [("lru", 1, 32), ("fifo", 4, 8), ("direct", 16, 1)])
def test_simulate_trace_equals_reference(policy, num_sets, ways):
    pages, writes = _trace(23, 1000, num_sets * ways)
    geo = dict(num_sets=num_sets, ways=ways, policy=policy)
    got = trace_sim.simulate_trace(pages, writes, torch_device="cpu", **geo)
    want = ref_trace_sim.simulate_trace(pages, writes, **geo)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_lanes_replay_independently():
    pages, writes = _trace(29, 2 * 400, 16)
    p = torch.from_numpy(pages).view(2, 400)
    w = torch.from_numpy(writes).view(2, 400)
    kw = dict(num_sets=2, ways=8, policy="lru", outstanding=4, **TIMING)
    both = ks.cache_sim_fused(p, w, **kw)
    for lane in range(2):
        one = ks.cache_sim_fused(p[lane], w[lane], **kw)
        for b, o in zip(both, one):
            assert torch.equal(b[lane], o)
    _, _, state = ks.cache_sim(p, w, num_sets=2, ways=8, return_state=True)
    assert tuple(state[0].shape) == (2, 2, 8)


def test_main_path_state_fits_shared_memory_with_raised_limit():
    # 1 set x 4096 ways: the staged chunk, the 32-slot ring, an 8192-slot
    # table, 20 B per frame and 16 B for the set (table and frames with one
    # spare entry), padded to 16 B; above the 48 KB default, within the
    # 227 KB a Hopper block may opt in to
    assert ks.table_bits(4096) == 13
    assert ks.layout(1, 4096, 32).lane_words == 2 * 8194 + 5 * 4097 + 4 + 3
    where = ks.placement(1, 4096, 32, 232_448)
    assert where == (True, 13 * 1024 + 128 + 147_520, 0)
    assert 48 * 1024 < where.smem_bytes == 160_960


def test_large_state_goes_to_global_scratch():
    words = 2 * 65538 + 5 * 32769 + 4 * 4096 + 3
    assert ks.placement(4096, 8, 32, 232_448) == (False, 13 * 1024 + 128,
                                                  4 * words)


def test_ring_that_does_not_fit_shared_memory_is_refused():
    limit = 232_448
    k = (limit - ks.STAGING_BYTES) // 4          # a multiple of 4: no padding
    where = ks.placement(1, 1, k, limit)
    assert not where.state_in_smem and where.smem_bytes == limit
    with pytest.raises(ValueError, match="outstanding"):
        ks.placement(1, 1, k + 1, limit)          # padded to k + 4 words


def test_direct_mapped_main_path_shape_just_fits_shared_memory():
    # 4096 sets x 1 way: 16 B of set fields per frame on top
    assert (ks.layout(4096, 1, 32).lane_words
            == 2 * 8194 + 5 * 4097 + 4 * 4096 + 3)
    where = ks.placement(4096, 1, 32, 232_448)
    assert where == (True, 226_480, 0)
    assert not ks.placement(4096, 1, 32, 226_479).state_in_smem
    with pytest.raises(ValueError, match="frames"):
        ks.placement(2**14, 2**14, 32, 232_448)


@pytest.mark.parametrize("num_sets,ways,outstanding",
                         [(1, 4096, 32), (4096, 1, 1), (3, 40, 7), (1, 1, 1)])
def test_layout_regions_are_disjoint_and_aligned(num_sets, ways,
                                                 outstanding):
    lay = ks.layout(num_sets, ways, outstanding)
    frames, table = num_sets * ways, 1 << lay.table_bits
    assert len(lay) == 11
    # shared memory: inputs, latencies, arrivals (int32), outcome bytes,
    # the ring, the lane; the ring and the lane start on 16 bytes
    c = lay.chunk
    assert (lay.lat, lay.arr, lay.out) == (c, 2 * c, 3 * c)
    assert lay.ring == 3 * c + c // 4 == ks.STAGING_BYTES // 4
    assert lay.lane >= lay.ring + outstanding
    # the lane: table (2 spare slots), frames and stamps (a spare each),
    # sets; the int4 arrays start on 16 bytes
    assert lay.frames == 2 * (table + 2)
    assert lay.sets == lay.frames + 4 * (frames + 1)
    assert lay.meta == lay.sets + 4 * num_sets
    assert lay.meta + frames + 1 <= lay.lane_words
    for words in (lay.ring, lay.lane, lay.frames, lay.sets, lay.lane_words):
        assert words % 4 == 0
    assert table >= max(4, 2 * frames) and ks.HASH_MUL % 2 == 1


def test_home_slots():
    # congruent pages share a home slot; distinct residues do not collide
    bits = 7
    assert {ks.home(5 + 128 * k, bits) for k in range(50)} == {ks.home(5, 7)}
    assert len({ks.home(p, bits) for p in range(128)}) == 128


@pytest.mark.parametrize("kind", ks.STRESS_TRACES)
@pytest.mark.parametrize("num_sets,ways,policy",
                         [(1, 64, "lru"), (3, 40, "fifo"), (16, 1, "direct")])
def test_stress_traces_do_what_they_say(kind, num_sets, ways, policy):
    shape = (2, 700)
    pages, writes = ks.stress_trace(kind, num_sets, ways, shape, seed=5)
    again = ks.stress_trace(kind, num_sets, ways, shape, seed=5)
    assert torch.equal(pages, again[0]) and torch.equal(writes, again[1])
    assert pages.shape == writes.shape == shape and pages.dtype == torch.int32
    frames = num_sets * ways
    hits, _ = ks.cache_sim(pages, writes, num_sets=num_sets, ways=ways,
                           policy=policy)
    first = torch.tensor([len(set(row.tolist())) for row in pages])
    if kind == "all_hit":
        assert torch.equal((~hits).sum(1), first)
    elif kind == "all_miss":
        assert not hits.any()
    elif kind == "collide":
        bits = ks.table_bits(frames)
        assert {ks.home(p, bits) for p in pages.flatten().tolist()} == {0}
    if kind != "all_miss":
        assert hits.any() and not hits.all()
    with pytest.raises(ValueError, match="kind"):
        ks.stress_trace("zipf", num_sets, ways, shape, seed=5)


# ------------------------------------------------ model of the kernel
class KernelModel:
    """One lane of ``csrc/cache_sim.cu``, step by step, in plain Python.

    The same structures as the kernel: a ``(page, frame)`` hash table of
    ``2 ** bits`` slots with linear probing from :func:`ks.home` and
    backward-shift deletion, a per-set ``fill`` count (FIFO keeps it in
    ``[ways, 2 * ways)`` once full), and under LRU a doubly linked recency
    list per set.  ``bits`` can be forced below the kernel's
    :func:`ks.table_bits` (it needs ``2 ** bits >= frames + 2``).  It counts
    the longest probe and the entries moved by deletions, and
    :meth:`check` holds the structures against the frames after a step."""

    def __init__(self, num_sets, ways, policy, bits=None):
        frames = num_sets * ways
        self.S, self.W, self.lru = num_sets, ways, policy == "lru"
        self.bits = ks.table_bits(frames) if bits is None else bits
        assert (1 << self.bits) >= frames + 2
        self.mask = (1 << self.bits) - 1
        self.table = [(-1, -1)] * (1 << self.bits)
        self.tags, self.meta, self.dirty = [-1] * frames, [0] * frames, [0] * frames
        self.prev, self.next = [-1] * frames, [-1] * frames
        self.fill = [0] * num_sets
        self.head, self.tail = [-1] * num_sets, [-1] * num_sets
        self.longest_probe = self.moved = 0

    def probe(self, page):
        h, length = ks.home(page, self.bits), 1
        while self.table[h][0] not in (page, -1):
            h, length = (h + 1) & self.mask, length + 1
        self.longest_probe = max(self.longest_probe, length)
        return h

    def erase(self, i):
        j = (i + 1) & self.mask
        while self.table[j][0] != -1:
            if (((j - ks.home(self.table[j][0], self.bits)) & self.mask)
                    >= ((j - i) & self.mask)):
                self.table[i], i = self.table[j], j
                self.moved += 1
            j = (j + 1) & self.mask
        self.table[i] = (-1, -1)

    def to_head(self, s, x, full):
        """Move frame x (a touched frame, the tail, or a new frame) to the
        head of set s's list."""
        hd = self.head[s]
        if x == hd:
            return
        if self.tags[x] >= 0 or full:          # linked: unlink it
            pv, nx = self.prev[x], self.next[x]
            self.next[pv] = nx
            if nx == -1:
                self.tail[s] = pv
            else:
                self.prev[nx] = pv
        elif hd == -1:
            self.tail[s] = x
        self.prev[x], self.next[x] = -1, hd
        if hd != -1:
            self.prev[hd] = x
        self.head[s] = x

    def access(self, t, page, wr):
        s = page % self.S
        row, f = s * self.W, self.fill[s]
        full = f >= self.W
        v = row + f if not full else self.tail[s] if self.lru else row + f - self.W
        h = self.probe(page)
        if self.table[h][0] == page:
            x = self.table[h][1]
            if self.lru:
                self.meta[x] = t
                self.to_head(s, x, False)
            self.dirty[x] |= wr
            return True, False
        evict = full and self.dirty[v] == 1
        self.table[h] = (page, v)              # insert, then erase the victim
        if full:
            self.erase(self.probe(self.tags[v]))
        self.fill[s] = self.W if f + 1 == 2 * self.W else (
            f if self.lru and full else f + 1)
        if self.lru:
            self.to_head(s, v, full)
        self.tags[v], self.meta[v], self.dirty[v] = page, t, int(wr)
        return False, evict

    def check(self):
        entries = {p: x for p, x in self.table if p != -1}
        valid = [x for x, tag in enumerate(self.tags) if tag >= 0]
        assert entries == {self.tags[x]: x for x in valid}
        for page, x in entries.items():
            assert self.table[self.probe(page)] == (page, x)
        for s in range(self.S):
            n = min(self.fill[s], self.W)
            assert all(self.tags[s * self.W + w] >= 0 for w in range(n))
            assert all(self.tags[s * self.W + w] < 0
                       for w in range(n, self.W))
            if not self.lru:
                continue
            order, x = [], self.head[s]       # head to tail: newest first
            while x != -1:
                order.append(x)
                x = self.next[x]
            assert len(order) == n and (not order or order[-1] == self.tail[s])
            stamps = [self.meta[x] for x in order]
            assert stamps == sorted(stamps, reverse=True)

    def run(self, pages, writes, check_every=1):
        hits, evicts = [], []
        for i, (p, w) in enumerate(zip(pages.tolist(), writes.tolist())):
            hit, ev = self.access(i + 1, p, w)
            hits.append(hit)
            evicts.append(ev)
            if check_every and i % check_every == 0:
                self.check()
        self.check()
        shape = (self.S, self.W)
        return (np.array(hits), np.array(evicts),
                tuple(np.array(a, np.int32).reshape(shape)
                      for a in (self.tags, self.meta, self.dirty)))


def _hold_model_against_plain(model, pages, writes, policy):
    hits, evicts, state = model.run(pages, writes)
    want = ks.cache_sim_plain(torch.from_numpy(pages), torch.from_numpy(writes),
                              num_sets=model.S, ways=model.W, policy=policy)
    np.testing.assert_array_equal(hits, _np(want[0]))
    np.testing.assert_array_equal(evicts, _np(want[1]))
    for got, w in zip(state, want[2]):
        np.testing.assert_array_equal(got, _np(w).astype(np.int32))
    return hits


MODEL_SHAPES = [(p, s, w) for p in ("lru", "fifo")
                for s, w in [(1, 64), (16, 4), (64, 1), (4, 8)]
                ] + [("direct", 64, 1)]


@pytest.mark.parametrize("policy,num_sets,ways", MODEL_SHAPES)
def test_kernel_model_equals_plain(policy, num_sets, ways):
    pages, writes = _trace(31, 1200, num_sets * ways, write_frac=0.4)
    model = KernelModel(num_sets, ways, policy)
    hits = _hold_model_against_plain(model, pages, writes, policy)
    assert 0 < hits.sum() < len(hits)


# (policy, num_sets, ways, forced bits or None for the kernel's): every page
# is congruent to one residue modulo the table, so all share a home slot and
# the resident pages form one cluster of up to frames + 1 entries
COLLIDE = [("lru", 1, 64, None), ("fifo", 4, 8, None),
           ("direct", 64, 1, None), ("lru", 3, 7, 5), ("fifo", 2, 5, 4)]


@pytest.mark.parametrize("last_slot", [False, True])
@pytest.mark.parametrize("policy,num_sets,ways,bits", COLLIDE)
def test_kernel_model_long_probe_chains(policy, num_sets, ways, bits,
                                        last_slot):
    frames = num_sets * ways
    model = KernelModel(num_sets, ways, policy, bits)
    size = 1 << model.bits
    assert bits is None or size < 2 ** ks.table_bits(frames)
    # residue 0 homes at slot 0; the other at the last slot, so the
    # cluster wraps around the end of the table
    r = (size - 1) * pow(ks.HASH_MUL, -1, size) % size if last_slot else 0
    rng = np.random.default_rng(41)
    pages = (r + size * rng.integers(0, 3 * frames, 900)).astype(np.int32)
    assert {ks.home(int(p), model.bits) for p in pages} == {
        size - 1 if last_slot else 0}
    _hold_model_against_plain(model, pages, rng.random(900) < 0.4, policy)
    # a miss walks the whole cluster (where the sets divide the table, the
    # congruent pages all fall in one set); each eviction shifts entries back
    resident = sum(tag >= 0 for tag in model.tags)
    assert model.longest_probe > resident >= ways
    assert model.moved > 900 // 2
