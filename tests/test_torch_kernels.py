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
    # 1 set x 4096 ways: 49,152 B of state + ring + reduction, above the
    # 48 KB default, within the 227 KB a Hopper block may opt in to
    state_in, smem = ks.placement(1, 4096, 32, 232_448)
    assert state_in
    assert smem == 4096 * 12 + 32 * 4 + ks.RED_BYTES > 48 * 1024
    assert ks.threads_for(4096) == 1024 and ks.threads_for(1) == 32
    assert ks.threads_for(33) == 64


def test_large_state_goes_to_global_scratch():
    assert ks.placement(4096, 8, 32, 232_448) == (False,
                                                  32 * 4 + ks.RED_BYTES)


def test_ring_that_does_not_fit_shared_memory_is_refused():
    limit = 232_448
    k = (limit - ks.RED_BYTES) // 4
    assert ks.placement(1, 1, k, limit) == (False, limit)
    with pytest.raises(ValueError, match="outstanding"):
        ks.placement(1, 1, k + 1, limit)
