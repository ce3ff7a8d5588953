"""The paper's Viper experiments (Figs. 5-6) and replacement-policy study
on the port, at the full arguments of ``examples/cxl_experiments.py`` (its
full run made ``results/paper/*.csv``; ``--fast`` does not reproduce the
Viper files).  Rows are compared as the formatted strings the CSVs hold.
"""

import pytest

from repro_torch.core.cache.dram_cache import DRAMCacheConfig
from repro_torch.core.devices import (DEVICE_NAMES, CachedCXLSSDDevice,
                                      make_device)
from repro_torch.core.workloads import ViperConfig, run_viper
from test_torch_workloads import csv_rows

# examples/cxl_experiments.py without --fast
FULL = dict(ops_per_phase=10_000, keyspace=28_000, seed_keys=18_000)
POLICIES = ("lru", "fifo", "2q", "lfru", "direct")


@pytest.mark.parametrize("device", DEVICE_NAMES)
@pytest.mark.parametrize("kv,tag", [(216, "fig5"), (532, "fig6")])
def test_viper_rows(kv, tag, device):
    qps = run_viper(make_device(device), ViperConfig(kv_bytes=kv, **FULL))
    rows = [[device, phase, f"{v:.0f}"] for phase, v in qps.items()]
    assert rows == csv_rows(f"{tag}_viper_{kv}B.csv", device)
    assert [r[1] for r in rows] == ["insert", "write", "query", "update",
                                    "delete", "avg"]


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_study_rows(policy):
    dev = CachedCXLSSDDevice(cache_cfg=DRAMCacheConfig(policy=policy))
    qps = run_viper(dev, ViperConfig(kv_bytes=532, **FULL))
    assert [[policy, f"{qps['avg']:.0f}", f"{dev.cache.hit_rate:.4f}"]] == \
        csv_rows("policy_study.csv", policy)

