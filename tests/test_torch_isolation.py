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

from repro_torch.core.cache.dram_cache import DRAMCacheConfig
from repro_torch.core.cache.trace_sim import simulate_trace
from repro_torch.core.devices import make_device
from repro_torch.core.replay.cuda_engine import run_cuda
from repro_torch.core.workloads.driver import TraceDriver
from test_torch_reference import REPO

PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


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
                "core/workloads", "kernels"):
        assert (REPO / "src" / "repro_torch" / sub / "__init__.py").exists()
    assert (REPO / "src" / "repro_torch" / "kernels" / "csrc"
            / "cache_sim.cu").exists()


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
