"""The CUDA kernels on the card, against their plain PyTorch versions.

These tests need an NVIDIA GPU and nvcc; without them they skip.  Run them
on the card with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Outputs are integers and flags: the comparisons are exact.  This file
imports no JAX, so it also runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.cache.dram_cache import DRAMCacheConfig
from repro_torch.core.devices import make_device
from repro_torch.core.replay.cuda_engine import run_cuda
from repro_torch.kernels import cache_sim as ks

pytestmark = pytest.mark.cuda
TIMING = dict(issue_ns=1, hit_ns=50, miss_ns=5000, miss_occ_ns=213, wb_ns=97)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _trace(card, seed, shape, frames):
    rng = np.random.default_rng(seed)
    pages = torch.from_numpy(rng.integers(0, 3 * frames, shape).astype(np.int32))
    writes = torch.from_numpy(rng.random(shape) < 0.3)
    return pages.to(card), writes.to(card)


def _equal(got, want):
    for g, w in zip(got, want):
        if isinstance(g, tuple):
            _equal(g, w)
        else:
            assert g.device.type == "cuda" and torch.equal(g, w)


@pytest.mark.parametrize("policy,num_sets,ways,outstanding,shape", [
    ("lru", 1, 64, 32, (600,)),
    ("fifo", 16, 4, 8, (777,)),
    ("direct", 64, 1, 1, (600,)),
    ("lru", 4096, 8, 32, (300,)),           # state in global scratch
    ("lru", 4, 8, 4, (2, 300)),             # two lanes, two blocks
    ("fifo", 1, 33, 2, (0,)),               # empty trace
])
def test_kernels_equal_plain_versions(card, policy, num_sets, ways,
                                      outstanding, shape):
    pages, writes = _trace(card, 7, shape, num_sets * ways)
    geo = dict(num_sets=num_sets, ways=ways, policy=policy)
    before = dict(ks.LAUNCHES)
    got = ks.cache_sim(pages, writes, return_state=True, **geo)
    got_f = ks.cache_sim_fused(pages, writes, outstanding=outstanding,
                               **TIMING, **geo)
    torch.cuda.synchronize()
    assert ks.LAUNCHES["cache_sim"] == before["cache_sim"] + 1
    assert ks.LAUNCHES["cache_sim_fused"] == before["cache_sim_fused"] + 1
    _equal(got, ks.cache_sim_plain(pages, writes, **geo))
    _equal(got_f, ks.cache_sim_fused_plain(pages, writes,
                                           outstanding=outstanding,
                                           **TIMING, **geo))


def test_run_cuda_on_the_card_equals_the_cpu(card):
    rng = np.random.default_rng(3)
    addrs = rng.integers(0, 256, 3000) * 4096 + rng.integers(0, 64, 3000) * 64
    writes = rng.random(3000) < 0.3
    for policy in ("lru", "fifo", "direct"):
        def run(where):
            dev = make_device("cxl-ssd-cache", cache_cfg=DRAMCacheConfig(
                policy=policy, capacity_bytes=64 * 4096))
            return run_cuda(dev, addrs, writes, validate=True,
                            torch_device=where)
        gpu, cpu = run("cuda"), run("cpu")
        for f in ("latency_ticks", "hit_flags", "evict_flags"):
            np.testing.assert_array_equal(getattr(gpu, f), getattr(cpu, f))
        for f in ("elapsed_ticks", "sum_latency_ticks", "end_tick"):
            assert getattr(gpu, f) == getattr(cpu, f)
