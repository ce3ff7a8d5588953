"""The port's device models and python driver lane against the JAX package.

The device models carry no framework code, so the reference objects run
in-process.  The reference driver does not import under the installed JAX,
so the port's python lane is held against the golden ``python_scan`` pins
instead.  Ticks are integers: every comparison is exact.
"""

import dataclasses

import numpy as np
import pytest

from golden import scenarios as sc
from repro.core import devices as ref_devices
from repro.core.cache.dram_cache import DRAMCacheConfig as RefCacheConfig
from repro.core.ssd.hil import SSDConfig as RefSSDConfig
from repro.core.ssd.pal import NANDTiming as RefNANDTiming
from repro_torch.convert import device_from_config
from repro_torch.core import devices
from repro_torch.core.cache.dram_cache import DRAMCacheConfig
from repro_torch.core.workloads.driver import TraceDriver
from repro_torch.core.workloads.traces import hash_seed, make_trace
from test_torch_reference import golden

SMALL = {
    "dram": {"dram": dataclasses.asdict(ref_devices.DRAMTiming(load_ns=70.0,
                                                               bw_gbps=25.6))},
    "cxl-dram": {"dram": dataclasses.asdict(ref_devices.DRAMTiming()),
                 "link": {"bw_gbps": 32.0, "rt_extra_ns": 70.0}},
    "pmem": {"pmem": dataclasses.asdict(ref_devices.PMEMTiming(row_bytes=512))},
    "cxl-ssd": {"ssd": dataclasses.asdict(RefSSDConfig(
                    capacity_bytes=1 << 28, timing=RefNANDTiming.low_latency(),
                    hil_overhead_ns=1000.0)),
                "cxl_ssd": {"page_registers": 8}},
    "cxl-ssd-cache": {"cache": dataclasses.asdict(RefCacheConfig(
                          capacity_bytes=64 * 4096, mshr_entries=4,
                          writeback_buffer=2)),
                      "ssd": dataclasses.asdict(RefSSDConfig(
                          capacity_bytes=1 << 28,
                          timing=RefNANDTiming.low_latency(),
                          hil_overhead_ns=1000.0))},
}


def _ref_device(name, cfg):
    """The reference object for the same configuration dict."""
    kw = {}
    if "dram" in cfg:
        kw["timing"] = ref_devices.DRAMTiming(**cfg["dram"])
    if "pmem" in cfg:
        kw["timing"] = ref_devices.PMEMTiming(**cfg["pmem"])
    if "link" in cfg:
        kw["link"] = ref_devices.CXLLink(**cfg["link"])
    if "ssd" in cfg:
        ssd = dict(cfg["ssd"])
        ssd["timing"] = RefNANDTiming(**ssd["timing"])
        kw["ssd_cfg"] = RefSSDConfig(**ssd)
    if "cache" in cfg:
        kw["cache_cfg"] = RefCacheConfig(**cfg["cache"])
    kw.update(cfg.get("cxl_ssd", {}))
    return ref_devices.make_device(name, **kw)


def _service_ticks(dev, seed, n=2000):
    rng = np.random.default_rng(seed)
    gaps = rng.integers(0, 400_000, n)               # ticks between issues
    addrs = rng.integers(0, 96, n) * 4096 + rng.integers(0, 64, n) * 64
    writes = rng.random(n) < 0.3
    posted = rng.random(n) < 0.5
    now, out = 0, []
    for g, a, w, p in zip(gaps.tolist(), addrs.tolist(), writes.tolist(),
                          posted.tolist()):
        now += g
        out.append(dev.service(now, a, 64, w, posted=w and p))
    return out


def test_device_tables_match():
    assert devices.DEVICE_NAMES == ref_devices.DEVICE_NAMES


@pytest.mark.parametrize("name", ref_devices.DEVICE_NAMES)
def test_table1_service_ticks_equal_reference(name):
    got = _service_ticks(devices.make_device(name), seed=1)
    want = _service_ticks(ref_devices.make_device(name), seed=1)
    assert got == want


@pytest.mark.parametrize("name", ref_devices.DEVICE_NAMES)
def test_converted_service_ticks_equal_reference(name):
    cfg = SMALL[name]
    port, ref = device_from_config(name, cfg), _ref_device(name, cfg)
    assert _service_ticks(port, seed=2) == _service_ticks(ref, seed=2)
    if name == "cxl-ssd-cache":
        assert port.cache.stats == ref.cache.stats
        assert port.hil.stats == ref.hil.stats


def test_device_from_config_refuses_foreign_sections():
    with pytest.raises(ValueError, match="takes sections"):
        device_from_config("dram", {"cache": {}})
    with pytest.raises(ValueError, match="unknown device"):
        device_from_config("hbm", {})


@pytest.mark.parametrize("device", sc.DEVICES)
def test_python_lane_equals_golden_pin(device):
    name = f"{device}@direct"
    dev = (devices.make_device(device, cache_cfg=DRAMCacheConfig(
               policy="lru", **sc.CACHE_KW))
           if device == "cxl-ssd-cache" else devices.make_device(device))
    lat = []

    class Tap:                                    # records each latency
        def service(self, now, addr, size, write, posted=False):
            done = dev.service(now, addr, size, write, posted)
            lat.append(done - now)
            return done

    res = TraceDriver(Tap(), outstanding=sc.OUTSTANDING).run(
        make_trace(hash_seed(name)))
    pin = golden(name)["python_scan"]
    assert lat == pin["latency_ticks"]
    assert (res.elapsed_ticks, res.sum_latency_ticks, res.end_tick) == (
        pin["elapsed_ticks"], pin["sum_latency_ticks"], pin["end_tick"])
    assert res.accesses == len(lat) == sc.N_ACCESSES
