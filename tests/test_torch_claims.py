"""The paper's claims (C1-C9) on the port's devices and workloads.

Every test of ``tests/test_devices_and_claims.py`` again, at the same
arguments and bands, on ``repro_torch``.  The bands are the paper's own
numbers; the assertions are on simulation output.
"""

import numpy as np
import pytest

from repro_torch.core.cache.dram_cache import DRAMCacheConfig
from repro_torch.core.devices import (DEVICE_NAMES, CachedCXLSSDDevice,
                                      make_device)
from repro_torch.core.workloads.membench import run_membench
from repro_torch.core.workloads.stream import run_stream
from repro_torch.core.workloads.viper import ViperConfig, run_viper


@pytest.fixture(scope="module")
def membench_results():
    return {n: run_membench(make_device(n), working_set_bytes=2 << 20,
                            accesses=3000) for n in DEVICE_NAMES}


@pytest.fixture(scope="module")
def stream_results():
    return {n: run_stream(make_device(n), dataset_bytes=4 << 20)
            for n in DEVICE_NAMES}


@pytest.fixture(scope="module")
def viper_216():
    return {n: run_viper(make_device(n), ViperConfig(kv_bytes=216))
            for n in DEVICE_NAMES}


@pytest.fixture(scope="module")
def viper_532():
    return {n: run_viper(make_device(n), ViperConfig(kv_bytes=532))
            for n in DEVICE_NAMES}


def _avg_bw(res):
    return float(np.mean([r.bandwidth_gbps for r in res.values()]))


# ------------------------------------------------------------------ C1: Fig 4
class TestLatencyClaims:
    def test_c1_latency_ordering(self, membench_results):
        lat = {n: r.avg_latency_ns for n, r in membench_results.items()}
        assert lat["dram"] < lat["cxl-dram"] < lat["pmem"] < lat["cxl-ssd"]
        assert lat["cxl-ssd-cache"] < lat["cxl-ssd"] / 5

    def test_c9_cxl_adds_about_50ns(self, membench_results):
        delta = (membench_results["cxl-dram"].avg_latency_ns
                 - membench_results["dram"].avg_latency_ns)
        assert 40 <= delta <= 80  # 50 ns network + link serialization

    def test_uncached_ssd_is_microseconds(self, membench_results):
        assert 1_000 <= membench_results["cxl-ssd"].avg_latency_ns <= 50_000


# ------------------------------------------------------------------ C2/C3: Fig 3
class TestBandwidthClaims:
    def test_c2_dram_highest(self, stream_results):
        dram = _avg_bw(stream_results["dram"])
        for other in ("cxl-dram", "pmem", "cxl-ssd", "cxl-ssd-cache"):
            assert dram >= _avg_bw(stream_results[other])

    def test_c2_cached_ssd_close_to_cxl_dram(self, stream_results):
        cached = _avg_bw(stream_results["cxl-ssd-cache"])
        cxl_dram = _avg_bw(stream_results["cxl-dram"])
        assert cached / cxl_dram > 0.85

    def test_c3_pmem_about_65pct_of_dram(self, stream_results):
        ratio = _avg_bw(stream_results["pmem"]) / _avg_bw(stream_results["dram"])
        assert 0.55 <= ratio <= 0.75

    def test_uncached_ssd_lowest(self, stream_results):
        ssd = _avg_bw(stream_results["cxl-ssd"])
        for other in ("dram", "cxl-dram", "pmem", "cxl-ssd-cache"):
            assert ssd <= _avg_bw(stream_results[other])


# ------------------------------------------------------------- C4-C7: Fig 5/6
class TestViperClaims:
    def test_c4_cxl_dram_14pct_loss(self, viper_216):
        ratio = viper_216["cxl-dram"]["avg"] / viper_216["dram"]["avg"]
        assert 0.80 <= ratio <= 0.92  # paper: ~14% loss

    def test_c5_pmem_20_50pct_behind_cxl_dram(self, viper_216):
        ratio = viper_216["pmem"]["avg"] / viper_216["cxl-dram"]["avg"]
        assert 0.50 <= ratio <= 0.80

    def test_c6_cache_7_to_10x(self, viper_216):
        ratio = viper_216["cxl-ssd-cache"]["avg"] / viper_216["cxl-ssd"]["avg"]
        assert 6.0 <= ratio <= 12.0  # paper: 7-10x on average

    def test_c7_532b_cached_20_30pct_below_pmem(self, viper_532):
        ratio = viper_532["cxl-ssd-cache"]["avg"] / viper_532["pmem"]["avg"]
        assert 0.65 <= ratio <= 0.85  # paper: 20-30% degradation

    def test_216b_cached_beats_pmem(self, viper_216):
        assert viper_216["cxl-ssd-cache"]["avg"] > viper_216["pmem"]["avg"]

    def test_qps_drops_with_value_size(self, viper_216, viper_532):
        for dev in ("dram", "cxl-dram", "pmem"):
            assert viper_532[dev]["avg"] <= viper_216[dev]["avg"] * 1.05

    def test_writes_generated_by_insert_update_delete(self):
        dev = make_device("pmem")
        run_viper(dev, ViperConfig(kv_bytes=216, ops_per_phase=500,
                                   keyspace=3000, seed_keys=2000))
        assert dev.stats["writes"] > 0 and dev.stats["reads"] > 0


# ------------------------------------------------------------------ C8: §III-C
class TestPolicyClaims:
    @pytest.fixture(scope="class")
    def policy_qps(self):
        out = {}
        for pol in ("lru", "fifo", "2q", "lfru", "direct"):
            dev = CachedCXLSSDDevice(cache_cfg=DRAMCacheConfig(policy=pol))
            out[pol] = run_viper(dev, ViperConfig(kv_bytes=532))["avg"]
        return out

    def test_c8_lru_best(self, policy_qps):
        assert policy_qps["lru"] == max(policy_qps.values())

    def test_c8_fifo_below_lru(self, policy_qps):
        assert policy_qps["fifo"] < policy_qps["lru"]


# ----------------------------------------------------------- posted semantics
def test_posted_vs_persistent_writes():
    dev = make_device("pmem")
    t_posted = dev.service(0, 0, 64, write=True, posted=True)
    dev2 = make_device("pmem")
    t_sync = dev2.service(0, 0, 64, write=True, posted=False)
    assert t_posted < t_sync


def test_rmw_on_uncached_write_miss():
    dev = make_device("cxl-ssd")
    t = dev.service(0, 0, 64, write=True)
    for pg in range(1, 9):
        t = dev.service(t, pg * 4096, 64, write=True)
    before = dev.stats["rmw_fills"]
    t = dev.service(t, 0, 64, write=True)
    assert dev.stats["rmw_fills"] > before
