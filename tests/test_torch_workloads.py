"""The paper's bandwidth and latency experiments (Figs. 3-4) on the port.

``examples/cxl_experiments.py`` of the JAX package wrote
``results/paper/*.csv``; its full run (no ``--fast``) reproduces them byte
for byte.  The port's ``run_stream`` and ``run_membench`` at that run's
arguments give the same rows, compared as the formatted strings the CSVs
hold.  The CSVs are read, never written.  Figs. 5-6 and the policy study
are in ``test_torch_workloads_viper.py``.
"""

import csv

import pytest

from repro_torch.core.devices import DEVICE_NAMES, DRAMDevice, make_device
from repro_torch.core.replay.metrics import MetricsSpec
from repro_torch.core.replay.spec import ReplayUnsupported
from repro_torch.core.workloads import (MultiHostDriver, run_membench,
                                        run_stream)
from test_torch_reference import REPO

PAPER = REPO / "results" / "paper"


def csv_rows(name: str, key: str) -> list:
    """Rows of ``results/paper/<name>`` whose first column is ``key``."""
    with open(PAPER / name, newline="") as fh:
        return [row for row in list(csv.reader(fh))[1:] if row[0] == key]


@pytest.mark.parametrize("device", DEVICE_NAMES)
def test_fig3_bandwidth_rows(device):
    rows = [[device, kernel, f"{r.bandwidth_gbps:.3f}"]
            for kernel, r in run_stream(make_device(device),
                                        dataset_bytes=4 << 20).items()]
    assert rows == csv_rows("fig3_bandwidth.csv", device)
    assert len(rows) == 4


@pytest.mark.parametrize("device", DEVICE_NAMES)
def test_fig4_latency_rows(device):
    r = run_membench(make_device(device), working_set_bytes=4 << 20,
                     accesses=5000)
    assert [[device, f"{r.avg_latency_ns:.1f}"]] == \
        csv_rows("fig4_latency.csv", device)


def test_membench_is_one_dependent_chain():
    r = run_membench(make_device("dram"), working_set_bytes=1 << 16,
                     accesses=200, iterations=1)
    assert r.accesses == 200
    # one access in flight: the span is the sum of the latencies
    assert r.elapsed_ticks == r.sum_latency_ticks


def test_multihost_driver_takes_the_reference_keywords():
    drv = MultiHostDriver([DRAMDevice()], block_size=1, metrics=None)
    assert drv.block_size == 1 and drv.metrics is None
    with pytest.raises(ValueError, match="block_size"):
        MultiHostDriver([DRAMDevice()], block_size=4)
    with pytest.raises(ValueError, match="block_size must be >= 1"):
        MultiHostDriver([DRAMDevice()], block_size=0)
    res = MultiHostDriver([DRAMDevice()], metrics=MetricsSpec()).run(
        [[(0, 64, False), (64, 64, True)]])
    assert res.metrics.media == [{"accesses": 2, "reads": 1, "writes": 1}]
    assert res.per_host[0].metrics is res.metrics
    # the scan lane takes the keywords too, and refuses a bare device with
    # the JAX package's words
    drv = MultiHostDriver([DRAMDevice()], engine="scan", torch_device="cpu")
    with pytest.raises(ReplayUnsupported,
                       match="supports FabricAttachedDevice / HostPortView "
                             "targets, got DRAMDevice"):
        drv.run([[(0, 64, False)]])
