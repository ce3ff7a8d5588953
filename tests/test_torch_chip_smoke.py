"""How ``chip_smoke.py`` takes device times from the profiler.

On the card's machine a profiler session now and then records no device
activity at all.  These tests drive the script's timing helpers with a
stand-in profiler on the CPU: a session that records nothing is retried,
a timing that the profiler never records falls back to CUDA events and
says so, and device events are split by kind.  The last tests hold the
script's correctness gates: the spill gate reads a ptxas report on every
run, and the tolerance check fails on any element outside it or NaN.
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
import torch.profiler
from torch.autograd import DeviceType

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _event(name, us, device=DeviceType.CUDA):
    return SimpleNamespace(name=name, device_time_total=us,
                           device_type=device)


# torch as the helpers see it: only the card's synchronize is called
_TORCH = SimpleNamespace(cuda=SimpleNamespace(synchronize=lambda: None))


@pytest.fixture
def sessions(monkeypatch):
    """A stand-in ``torch.profiler.profile`` that hands out the event lists
    of ``sessions.queue`` one per session, and counts the sessions."""
    state = SimpleNamespace(queue=[], opened=0)

    class Profile:
        def __init__(self, **kw):
            state.opened += 1
            self.acts = state.queue.pop(0) if state.queue else []

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return [_event("cpu_op", 5.0, DeviceType.CPU)] + self.acts

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    return state


def test_an_empty_profiler_session_is_tried_again(smoke, sessions):
    kernel = _event("cache_sim_kernel", 40.0)
    sessions.queue = [[], [], [kernel]]
    calls = []
    acts = smoke.device_events(_TORCH, lambda: calls.append(1), bool)
    assert acts == [kernel]
    assert sessions.opened == 3 and len(calls) == 3


def test_device_events_give_up_after_the_set_number_of_sessions(
        smoke, sessions):
    sessions.queue = [[]] * 10
    assert smoke.device_events(_TORCH, lambda: None, bool) == []
    assert sessions.opened == smoke.PROFILE_TRIES


def test_a_timing_the_profiler_never_records_falls_back_to_cuda_events(
        smoke, sessions, monkeypatch, capsys):
    sessions.queue = [[_event("other_kernel", 9.0)]] * smoke.PROFILE_TRIES
    monkeypatch.setattr(smoke, "cuda_ms", lambda torch, fn, reps=1: 12.0)
    ms = smoke.device_ms(_TORCH, lambda i: None, reps=4,
                         match="flash_decode_kernel")
    assert ms == pytest.approx(3.0)
    assert smoke.EVENT_TIMED == ["flash_decode_kernel"]
    assert "CUDA events" in smoke.timing_note()
    assert "fallback=CUDA events" in capsys.readouterr().out


def test_device_ms_averages_a_named_kernel_over_its_recorded_launches(
        smoke, sessions):
    sessions.queue = [[_event("flash_decode_kernel<4>", 30.0),
                       _event("flash_decode_kernel<4>", 50.0),
                       _event("elementwise", 1000.0)]]
    names = []
    ms = smoke.device_ms(_TORCH, lambda i: None, reps=24,
                         match="flash_decode_kernel", names=names)
    assert ms == pytest.approx(0.040)          # 80 us over 2 launches
    assert names == ["flash_decode_kernel<4>"]
    assert smoke.EVENT_TIMED == []
    assert smoke.timing_note() == "device time per call by torch.profiler"


def test_device_ms_without_a_name_sums_every_device_event_per_call(
        smoke, sessions):
    sessions.queue = [[_event("a", 30.0), _event("Memcpy DtoD", 10.0)]]
    assert smoke.device_ms(_TORCH, lambda i: None, reps=2) == \
        pytest.approx(0.020)


def test_split_by_kind(smoke):
    acts = [_event("flash_attention_kernel", 3000.0),
            _event("sm90_xmma_gemm_f32f32", 2000.0),
            _event("Memset (Device)", 500.0),
            _event("vectorized_elementwise_kernel", 250.0)]
    kinds = smoke.split_by_kind(acts, ("flash_attention_kernel",),
                                "flash_attention")
    assert kinds == {"flash_attention": 3.0, "matmuls": 2.0,
                     "other_kernels": 0.25, "copies": 0.5}


PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122flash_attention_kernelILi15ELb1EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_122flash_attention_kernelILi15ELb1EEEvNS_6ParamsE
    0 bytes stack frame, {stores} bytes spill stores, {loads} bytes spill loads
ptxas info    : Used 232 registers, 560 bytes cmem[0]
ptxas info    : Function properties for _ZN12_GLOBAL__N_122flash_attention_kernelILi8ELb0EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
"""


@pytest.mark.parametrize("stores,loads", [(0, 0), (8, 0), (0, 4), (24, 16)])
def test_ptxas_spills_sums_every_kernel_of_the_report(smoke, stores, loads):
    log = PTXAS.format(stores=stores, loads=loads)
    assert smoke.ptxas_spills(log, "flash_attention_kernel") == stores + loads
    # no report, or one of another kernel, is refused, never read as 0
    for other in ("", log.replace("flash_attention", "flash_decode")):
        with pytest.raises(ValueError, match="names no"):
            smoke.ptxas_spills(other, "flash_attention_kernel")


def test_library_built_earlier_keeps_its_ptxas_report(tmp_path, monkeypatch):
    """A library found on disk brings the report of the build that made
    it, so the spill gate reads a report on every run."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(_build, "build_log", {})
    lib = _build.library_path("flash_attention")
    lib.write_bytes(b"")
    report = PTXAS.format(stores=0, loads=0)
    lib.with_suffix(".ptxas").write_text(report)
    assert _build.build("flash_attention") == lib     # no nvcc: it exists
    assert _build.build_log == {"flash_attention": report}


@pytest.mark.parametrize("case", ["within", "outside", "nan_got", "nan_want"])
def test_close_err_fails_on_any_element_outside_or_nan(smoke, case):
    tol = dict(atol=2e-5, rtol=2e-5)
    want = torch.linspace(-4, 4, 65)        # holds 0, where the share peaks
    got = want + 1e-5                       # share 1e-5 / (2e-5 + 2e-5|w|)
    if case == "outside":
        got[7] += 1e-3
    elif case == "nan_got":
        got[7] = float("nan")
    elif case == "nan_want":
        want = want.clone()
        want[7] = float("nan")
    err, share, ok = smoke.close_err(torch, got, want, tol)
    assert ok == (case == "within")
    if case == "within":
        assert err == pytest.approx(1e-5, rel=1e-2)
        assert share == pytest.approx(0.5, rel=1e-2)
    elif case == "outside":
        assert err > 1e-3 and share > 1
    else:                                   # a NaN reads as inf, not lost
        assert err == float("inf") and share == float("inf")


# ------------------------------------------------------- the fabric phase
def test_golden_pin_reads_the_fabric_scenario(smoke):
    from test_torch_reference import golden

    pin = smoke.golden_pin(smoke.FABRIC_GOLDEN, "pallas")
    assert pin == golden("cxl-ssd-cache@fabric")["pallas"]
    assert pin["latency_ticks"][0] == 7_677_000
    assert smoke.golden_pin(smoke.GOLDEN, "pallas") == \
        golden("cxl-ssd-cache@direct")["pallas"]


def test_refuses_catches_only_the_named_exception(smoke):
    from repro_torch.core.replay.spec import ReplayUnsupported

    def raise_(exc):
        raise exc

    assert smoke.refuses(lambda: raise_(ReplayUnsupported("x")),
                         ReplayUnsupported)
    assert not smoke.refuses(lambda: None, ReplayUnsupported)
    with pytest.raises(KeyError):
        smoke.refuses(lambda: raise_(KeyError("x")), ReplayUnsupported)


def test_the_phase_plan_is_refused_on_its_mount(smoke):
    import numpy as np

    from repro_torch.core.devices import make_device
    from repro_torch.core.fabric import Fabric
    from repro_torch.core.faults import FaultConfig, FaultPlan, install
    from repro_torch.core.replay.cuda_engine import run_cuda
    from repro_torch.core.replay.spec import ReplayUnsupported

    mount = Fabric.build("two_level", **smoke.FABRIC).mount(
        "h0", "d0", make_device("cxl-ssd-cache"))
    addrs, writes = np.arange(0, 64 * 8, 64), np.zeros(8, bool)
    assert run_cuda(mount, addrs, writes, torch_device="cpu").accesses == 8
    install(FaultPlan(FaultConfig(**smoke.FABRIC_PLAN)), [mount])
    assert smoke.refuses(lambda: run_cuda(mount, addrs, writes,
                                          torch_device="cpu"),
                         ReplayUnsupported)


def test_twin_mismatches_are_zero_and_catch_a_broken_twin(smoke,
                                                          monkeypatch):
    from repro_torch.core.fabric import routing

    values = smoke.twin_values(3, 4096)
    assert values[2] == 2**63 and values[3] == 2**64 - 1
    cpu = torch.device("cpu")
    assert smoke.twin_mismatches(torch, cpu, values, 3) == {
        "flow_choices_torch": 0, "nand_read_retries_torch": 0,
        "erase_fails_torch": 0}
    monkeypatch.setattr(routing, "flow_choices_torch",
                        lambda src, dst, x, n: torch.zeros(
                            x.shape, dtype=torch.int32))
    assert smoke.twin_mismatches(torch, cpu, values, 3)[
        "flow_choices_torch"] > 0


def test_nand_plain_equals_the_scalar_plan(smoke):
    import numpy as np

    from repro_torch.core.faults import FaultConfig, FaultPlan

    plan = FaultPlan(FaultConfig(**smoke.TWIN_NAND), seed=5)
    retries, fails = smoke.nand_plain(plan.nand_statics(),
                                      np.arange(400, dtype=np.uint64))
    assert retries.tolist() == [plan.nand_read_retries(i) for i in range(400)]
    assert fails.tolist() == [plan.erase_fails(i) for i in range(400)]
