"""Reference helpers for the PyTorch port's tests, and their own checks.

The JAX package is the reference the port is held against.  Parts of it
import cleanly here and are called in-process by the port's tests
(``repro.kernels.cache_sim`` in interpret mode, ``repro.kernels.ref``,
``repro.core.cache.trace_sim``, ``repro.core.devices``).  The replay lanes
(``TraceDriver``, ``run_pallas``, ``pallas_params``) need
``jax.experimental.enable_x64``, which the installed JAX no longer has; a
one-line alias makes them import.  That alias is applied only in a child
process (:func:`run_reference`), never in the pytest process, so the other
test files see the JAX package exactly as it is.

Other test files import :func:`run_reference`, :func:`golden` and
:data:`REPO` from here (``tests/`` is on ``sys.path``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from golden import scenarios as sc
from repro_torch.core.workloads import traces

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
GOLDEN_FIXTURE = REPO / "tests" / "golden" / "golden_traces.json"
# the alias the replay lanes of the JAX package need under the installed JAX
SHIM = ("import jax, jax.experimental\n"
        "jax.experimental.enable_x64 = jax.enable_x64\n")


def run_reference(code: str, workdir: Path, inputs: dict | None = None,
                  timeout: float = 600, env: dict | None = None) -> dict:
    """Run ``code`` against the JAX package in a child Python process.

    The child gets ``JAX_PLATFORMS=cpu``, ``PYTHONPATH`` set to the repo's
    ``src`` and the alias above before anything else.  ``code`` reads its
    inputs from the dict ``IN`` (numpy arrays) and leaves its results in the
    dict ``OUT`` (numpy-convertible values, no objects); both travel through
    ``.npz`` files in ``workdir``.  ``env`` adds variables to the child's
    environment only (``XLA_FLAGS`` must be set before JAX starts, as a
    forced host device count is)."""
    workdir = Path(workdir)
    inp, out = workdir / "reference_in.npz", workdir / "reference_out.npz"
    np.savez(inp, **(inputs or {}))
    script = (SHIM + "import numpy as np\n"
              f"IN = dict(np.load({str(inp)!r}))\nOUT = {{}}\n"
              + code + f"\nnp.savez({str(out)!r}, **OUT)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC),
               **(env or {}))
    proc = subprocess.run([sys.executable, "-c", script], cwd=workdir,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"reference child failed ({proc.returncode}):\n"
                             f"{proc.stderr[-4000:]}")
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def golden(name: str) -> dict:
    """The pinned scenario ``name`` of ``tests/golden/golden_traces.json``."""
    with open(GOLDEN_FIXTURE) as fh:
        return json.load(fh)["scenarios"][name]


# ------------------------------------------------------------------ checks
def test_golden_loader_reads_the_pins_the_port_uses():
    cached = golden("cxl-ssd-cache@direct")
    assert set(cached) >= {"pallas", "python_scan"}
    assert cached["pallas"]["latency_ticks"][0] == 7_677_000
    assert len(cached["pallas"]["latency_ticks"]) == sc.N_ACCESSES
    for device in sc.DEVICES:
        assert "python_scan" in golden(f"{device}@direct")


@pytest.mark.parametrize("name", [f"{d}@direct" for d in sc.DEVICES])
def test_port_trace_builder_matches_the_scenarios(name):
    # the port keeps its own numpy copy of the scenarios' trace generator
    assert traces.hash_seed(name) == sc.hash_seed(name)
    assert traces.make_trace(traces.hash_seed(name)) == sc.scenario_trace(name)


def test_port_trace_builder_matches_at_other_sizes():
    assert (traces.make_trace(5, n=300, pages=4096, write_frac=0.7)
            == sc.make_trace(5, n=300, pages=4096, write_frac=0.7))


def test_child_reference_runs_the_replay_lane(tmp_path):
    out = run_reference(
        "from repro.core.replay.spec import trace_to_arrays\n"
        "a, w, s = trace_to_arrays([(int(x), 64, False) for x in IN['a']])\n"
        "OUT['a'] = a\nOUT['size'] = s\n",
        tmp_path, {"a": np.arange(0, 640, 64)})
    np.testing.assert_array_equal(out["a"], np.arange(0, 640, 64))
    assert int(out["size"]) == 64


def test_child_reference_takes_its_own_environment(tmp_path):
    flags = "--xla_force_host_platform_device_count=4"
    out = run_reference("import jax\nOUT['n'] = len(jax.devices())\n",
                        tmp_path, env={"XLA_FLAGS": flags})
    assert int(out["n"]) == 4
    assert os.environ.get("XLA_FLAGS") != flags


def test_child_reference_reports_failures(tmp_path):
    with pytest.raises(AssertionError, match="ZeroDivisionError"):
        run_reference("1 / 0\n", tmp_path)
