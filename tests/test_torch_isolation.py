"""The port stands alone: it imports nothing of JAX or of the JAX package,
the reference alias never runs in the test process, and the card is never
silently replaced by the CPU."""

import ast
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.cache.dram_cache import DRAMCacheConfig
from repro_torch.core.cache.trace_sim import simulate_trace
from repro_torch.core.devices import make_device
from repro_torch.core.replay.cuda_engine import run_cuda
from repro_torch.core.workloads.driver import TraceDriver
from repro_torch.distributed.step import make_prefill_step
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.ops import page_gather_op, page_scatter_op
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import transformer as T
from repro_torch.serving.scheduler import BatchScheduler, SchedulerConfig
from repro_torch.tiered.store import TieredStore, TieredStoreConfig
from test_torch_reference import REPO

# chip_smoke.py and the one module of tests/ that it loads
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "torch_scenarios.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


def test_port_package_has_the_reference_layout():
    for sub in ("core", "core/cache", "core/ssd", "core/cxl", "core/replay",
                "core/workloads", "core/fabric", "core/faults", "kernels",
                "configs", "models", "tiered", "serving", "launch",
                "distributed", "data", "checkpoint"):
        assert (REPO / "src" / "repro_torch" / sub / "__init__.py").exists()
        assert (REPO / "src" / "repro" / sub / "__init__.py").exists()
    for name in ("cache_sim", "flash_attention", "flash_decode",
                 "page_gather", "replay_scan"):
        assert (REPO / "src" / "repro_torch" / "kernels" / "csrc"
                / f"{name}.cu").exists()
    for mod in ("core/fabric/topology.py", "core/fabric/switch.py",
                "core/fabric/routing.py", "core/fabric/fabric.py",
                "core/fabric/pool.py", "core/fabric/link_sim.py",
                "core/faults/plan.py", "core/workloads/membench.py",
                "core/replay/metrics.py", "core/replay/stack.py",
                "core/replay/engine.py", "core/replay/spec.py",
                "core/replay/stream.py", "data/trace_store.py",
                "data/pipeline.py", "checkpoint/manager.py",
                "obs/__init__.py", "obs/export.py",
                "core/workloads/stream.py", "core/workloads/viper.py",
                "models/layers.py", "models/transformer.py",
                "kernels/flash_attention.py", "kernels/flash_decode.py",
                "kernels/page_gather.py",
                "kernels/ops.py", "tiered/store.py", "serving/scheduler.py",
                "launch/serve.py", "distributed/step.py", "configs/base.py"):
        assert (REPO / "src" / "repro_torch" / mod).exists(), mod
        assert (REPO / "src" / "repro" / mod).exists(), mod


def test_reference_alias_only_in_the_child_runner():
    for path in sorted((REPO / "tests").glob("test_torch_*.py")):
        if path.name == "test_torch_reference.py":
            continue
        assert not re.search(r"\.enable_x64\s*=[^=]", path.read_text()), path
    import jax.experimental
    assert "enable_x64" not in vars(jax.experimental)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_run_cuda_defaults_to_the_card_and_refuses_without_one(no_card):
    dev = make_device("cxl-ssd-cache",
                      cache_cfg=DRAMCacheConfig(capacity_bytes=16 * 4096))
    addrs, writes = np.arange(0, 4096 * 4, 64), np.zeros(256, bool)
    with pytest.raises(RuntimeError, match="torch_device='cpu'"):
        run_cuda(dev, addrs, writes)
    with pytest.raises(RuntimeError, match="torch_device='cpu'"):
        TraceDriver(dev, engine="cuda").run([(0, 64, False)])
    with pytest.raises(RuntimeError, match="torch_device='cpu'"):
        simulate_trace(np.zeros(4, np.int32), np.zeros(4, bool), num_sets=1,
                       ways=4)
    # the CPU is used when asked for
    assert run_cuda(dev, addrs, writes, torch_device="cpu").accesses == 256


def test_serving_entry_points_default_to_the_card_and_refuse_without_one(
        no_card, capsys):
    cfg = get_arch("h2o-danube-3-4b").reduced()
    store_cfg = TieredStoreConfig(n_logical_pages=4, page_shape=(2, 3),
                                  hbm_pages=2)
    refusals = [
        lambda: T.init_params(cfg, 0),
        lambda: TieredStore(store_cfg),
        lambda: BatchScheduler(None, None, SchedulerConfig(), cfg.vocab),
        lambda: serve_main(["--arch", "h2o-danube-3-4b", "--reduced"]),
        lambda: make_prefill_step(cfg),
    ]
    for call in refusals:
        with pytest.raises(RuntimeError, match="torch_device='cpu'"):
            call()
    # the CPU is used when asked for
    params = T.init_params(cfg, 0, torch_device="cpu")
    assert params["embed"].device.type == "cpu"
    assert TieredStore(store_cfg, torch_device="cpu").pool.device.type == "cpu"
    logits = make_prefill_step(cfg, torch_device="cpu")(
        params, {"tokens": np.zeros((1, 3), np.int32)})
    assert logits.device.type == "cpu"
    serve_main(["--arch", "h2o-danube-3-4b", "--reduced", "--device", "cpu",
                "--prompt-len", "2", "--gen", "2"])
    assert capsys.readouterr().out.startswith("[serve] arch=")


def test_kernel_wrappers_launch_or_raise_off_the_cpu(no_card):
    """Only CPU tensors take the plain versions; any other device goes to
    the kernel launch, which refuses what is not a CUDA tensor."""
    q = torch.zeros(1, 4, 8, device="meta")
    kv = torch.zeros(1, 16, 2, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_decode(q, kv, kv, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(q[:, None], kv[:, :1], kv[:, :1])
    pool = torch.zeros(4, 2, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        page_gather_op(pool, torch.tensor([1]))
    with pytest.raises(ValueError, match="CUDA tensors"):
        page_scatter_op(pool, torch.tensor([1]),
                        torch.zeros(1, 2, 3, device="meta"))
    cpu = torch.ones(4, 2, 3)
    assert page_gather_op(cpu, torch.tensor([1, 1])).shape == (2, 2, 3)


def test_scan_lane_defaults_to_the_card_and_refuses_without_one(no_card):
    from repro_torch.core.replay.engine import ReplayEngine

    with pytest.raises(RuntimeError, match="torch_device='cpu'"):
        TraceDriver(make_device("dram"), engine="scan").run([(0, 64, False)])
    with pytest.raises(RuntimeError, match="torch_device='cpu'"):
        ReplayEngine(make_device("dram")).run([(0, 64, False)])
    # the CPU is used when asked for
    assert TraceDriver(make_device("dram"), engine="scan",
                       torch_device="cpu").run([(0, 64, False)]).accesses == 1


def test_streaming_entry_points_default_to_the_card(no_card, tmp_path):
    from repro_torch.core.replay import replay_stream
    from repro_torch.core.replay.engine import ReplayEngine
    from repro_torch.core.replay.multihost import MultiHostReplay
    from repro_torch.data import TraceStore

    store = TraceStore.write(tmp_path / "t.store", [0, 64], [False, True])
    trace = [(0, 64, False), (64, 64, True)]
    with pytest.raises(RuntimeError, match="torch_device='cpu'"):
        replay_stream(store, make_device("dram"), chunk_size=1)
    with pytest.raises(RuntimeError, match="torch_device='cpu'"):
        ReplayEngine(make_device("dram")).run(trace, chunk_size=1)
    with pytest.raises(RuntimeError, match="torch_device='cpu'"):
        ReplayEngine(make_device("dram")).run(trace, return_latencies=False)
    from repro_torch.core.fabric import Fabric

    fab = Fabric.build("two_level", num_hosts=2, num_devices=2, num_leaves=2)
    fab_targets = [fab.mount(f"h{i}", f"d{i}", make_device("dram"))
                   for i in range(2)]
    with pytest.raises(RuntimeError, match="torch_device='cpu'"):
        MultiHostReplay(fab_targets).run([trace, trace], chunk_size=1)
    # the CPU is used when asked for
    assert replay_stream(store, make_device("dram"), chunk_size=1,
                         torch_device="cpu").accesses == 2


def test_streaming_input_layers_load_no_torch(tmp_path):
    code = ("import sys\n"
            "from repro_torch.checkpoint import CheckpointManager\n"
            "from repro_torch.data import Prefetcher, TraceStore\n"
            f"st = TraceStore.write({str(tmp_path / 's')!r}, [0, 64], "
            "[True, False])\n"
            "assert len(list(Prefetcher(st.chunks(1)))) == 2\n"
            "assert 'torch' not in sys.modules, 'torch was loaded'\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_replay_scan_launches_or_raises_off_the_cpu(no_card):
    from repro_torch.core.replay.spec import build_stack
    from repro_torch.kernels.replay_scan import replay_scan

    cfg, params = build_stack(make_device("dram"), size=64, outstanding=1,
                              issue_overhead_ns=0.5, posted_writes=True,
                              n_accesses=1, max_addr=0)
    meta = dict(device="meta")
    state = {"media": {"busy": torch.zeros((), dtype=torch.int64, **meta)},
             "flash": None}
    with pytest.raises(ValueError, match="CUDA tensors"):
        replay_scan(cfg, params, state,
                    torch.zeros(1, dtype=torch.int64, **meta),
                    torch.zeros(1, dtype=torch.bool, **meta))


def test_python_lane_needs_no_card(no_card):
    res = TraceDriver(make_device("dram")).run([(0, 64, False)] * 4)
    assert res.accesses == 4


def _smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    proc = _smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_fabric_tensor_entry_points_default_to_the_card(no_card):
    from repro_torch.core.fabric import Fabric
    from repro_torch.core.fabric.link_sim import LinkCongestionSim
    from repro_torch.core.fabric.routing import flow_choices_torch

    fab = Fabric.build("two_level", num_hosts=2, num_devices=1, num_leaves=2)
    args = (fab, fab.topology.hosts, fab.topology.devices)
    with pytest.raises(RuntimeError, match="torch_device='cpu'"):
        LinkCongestionSim(*args)
    with pytest.raises(RuntimeError, match="torch_device='cpu'"):
        flow_choices_torch("h0", "d0", np.arange(4), 2)
    # the CPU is used when asked for, and tensors are hashed where they lie
    assert LinkCongestionSim(*args, torch_device="cpu").routes.device.type \
        == "cpu"
    assert flow_choices_torch("h0", "d0", torch.arange(4), 2).shape == (4,)


def test_python_lane_metrics_load_no_torch():
    code = ("import sys\n"
            "from repro_torch.core.devices import make_device\n"
            "from repro_torch.core.replay.metrics import MetricsSpec\n"
            "from repro_torch.core.workloads.driver import TraceDriver\n"
            "from repro_torch.obs import to_perfetto\n"
            "res = TraceDriver(make_device('cxl-ssd-cache'), "
            "metrics=MetricsSpec()).run([(i * 64, 64, i % 3 == 0) "
            "for i in range(256)])\n"
            "assert res.p99_ns and to_perfetto(res)['traceEvents']\n"
            "assert 'torch' not in sys.modules, 'torch was loaded'\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_fabric_python_lane_loads_no_torch():
    code = ("import sys\n"
            "from repro_torch.core.fabric import Fabric\n"
            "from repro_torch.core.faults import FaultConfig, FaultPlan, "
            "install\n"
            "from repro_torch.core.workloads import MultiHostDriver, "
            "run_membench, run_stream, run_viper\n"
            "from repro_torch.core.devices import make_device\n"
            "fab = Fabric.build('spine_leaf', num_hosts=2, num_devices=2, "
            "ecmp=True)\n"
            "t = fab.mount('h0', 'd0', make_device('dram'))\n"
            "install(FaultPlan(FaultConfig(link_retry_rate=0.5)), [t])\n"
            "MultiHostDriver([t]).run([[(i * 64, 64, False) "
            "for i in range(64)]])\n"
            "assert fab.fault_stats['link_retries'] > 0\n"
            "assert 'torch' not in sys.modules, 'torch was loaded'\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_loads_of_tests_only_the_scenario_builders():
    tests = {p.stem for p in (REPO / "tests").glob("*.py")} | {"golden"}
    for path in (REPO / "chip_smoke.py", REPO / "tests" / "torch_scenarios.py"):
        loaded = {m.split(".")[0] for m in _imported_modules(path)}
        assert loaded & tests <= {"torch_scenarios"}, path
        assert "pytest" not in loaded, path


def test_scenario_builders_load_neither_pytest_nor_the_golden_fixture():
    code = ("import sys\n"
            "from torch_scenarios import (make_target, scenario_outstanding,"
            " scenario_trace, DEVICES)\n"
            "names = [f'{d}@{a}' for d in DEVICES for a in "
            "('direct', 'fabric')] + ['dram@stream', 'pmem@stream', "
            "'dram-qos@fabric', 'ssd-gc@direct']\n"
            "for n in names:\n"
            "    make_target(n), scenario_trace(n), scenario_outstanding(n)\n"
            "bad = {'pytest', 'golden', 'repro', 'jax'} & {m.split('.')[0] "
            "for m in sys.modules}\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests")]))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
