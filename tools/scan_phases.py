#!/usr/bin/env python3
"""Where the ``replay_scan`` kernel's time goes, phase by phase, on the card.

    python tools/scan_phases.py [CHECKOUT] [--tag TAG]

Imports ``repro_torch`` from ``CHECKOUT/src`` (default: this checkout),
builds a copy of its ``src/repro_torch/kernels/csrc/replay_scan.cu`` with
``clock64()`` stamps at the phase boundaries (its ``SCAN_PHASE`` hooks
defined: the walking thread's ``Chain`` gains the counters) into
``build/repro_torch/scan_phases/``, binds it in place of the kernel's
library and replays the five devices of ``chip_smoke.py``'s ``[scan]``
phase (``make_device`` defaults, 32 outstanding, posted writes, 0.5 ns
issue overhead) over the same seeded trace of 2^20 accesses.

The walking thread adds the cycles since its previous stamp to the phase
that a stamp closes.  Phases, in order: ``load`` (the access's trace
input), ``lfb`` (the LFB slot argmin and its tournament tree's update),
``hops`` (the transport hops), ``mshr`` (the cache's MSHR lookup),
``frames`` (residency and the victim), ``miss`` (the miss path outside
the flash: MSHR allocate and insert, the writeback queue, the frame and
map updates), ``flash`` (``hil_read`` / ``hil_write`` with allocation, GC
and the PAL) and ``commit`` (the DRAM / PMEM step, the hit's touch, the
outputs and the slot's store).  A stamp that closes a phase whose last
load is still in flight first stores the loaded value to a volatile
local, so the wait counts in that phase.  A checkout whose source has no
``SCAN_PHASE`` hooks is refused.

Prints one JSON line per device: cycles an access by phase and their sum,
the stamped launch's milliseconds, and the milliseconds of one launch of
the checkout's own, unstamped library (both by CUDA events) with the
cycles an access they give at the card's maximum SM clock.  The stamps
cost a few cycles each; the kernel's own time is the unstamped one.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("checkout", nargs="?",
                default=str(Path(__file__).resolve().parents[1]))
ap.add_argument("--tag", default="")
args = ap.parse_args()
sys.path.insert(0, str(Path(args.checkout).resolve() / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.devices import make_device  # noqa: E402
from repro_torch.core.replay import stack  # noqa: E402
from repro_torch.core.replay.spec import build_stack, trace_to_arrays  # noqa: E402
from repro_torch.core.workloads.traces import make_trace  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import replay_scan as rs  # noqa: E402

DEVICES = ("dram", "cxl-dram", "pmem", "cxl-ssd", "cxl-ssd-cache")
ACCESSES = 1 << 20                  # the [scan] phase's trace
PHASES = ("load", "lfb", "hops", "mshr", "frames", "miss", "flash", "commit")
HOOKS = r"""
#define SCAN_PHASES 1
__device__ unsigned long long g_scan_phase[8];
#define SCAN_PHASE_MEMBERS \
  unsigned long long ph_acc[8]; \
  long long ph_last; \
  __device__ __forceinline__ void ph_begin() { \
    for (int i_ = 0; i_ < 8; ++i_) ph_acc[i_] = 0; \
    ph_last = clock64(); \
  } \
  __device__ __forceinline__ void ph_stamp(int k_) { \
    const long long n_ = clock64(); \
    ph_acc[k_] += n_ - ph_last; \
    ph_last = n_; \
  } \
  __device__ __forceinline__ void ph_end() { \
    if (threadIdx.x == 0) \
      for (int i_ = 0; i_ < 8; ++i_) g_scan_phase[i_] = ph_acc[i_]; \
  }
#define SCAN_PHASE_BEGIN() c.ph_begin()
#define SCAN_PHASE_END() c.ph_end()
#define SCAN_PHASE(k) ph_stamp(k)
#define SCAN_PHASE_DEP(k, v) do { \
  volatile long long sink_ = static_cast<long long>(v); (void)sink_; \
  ph_stamp(k); } while (0)
"""
READER = r"""
extern "C" int scan_phases_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_scan_phase,
                                   sizeof(unsigned long long) * 8);
}
"""
def stamped_source(src: str) -> str:
    """The source with its ``SCAN_PHASE`` hooks defined."""
    if "SCAN_PHASE(" not in src:
        raise SystemExit("the source has no SCAN_PHASE hooks")
    return HOOKS + src + READER


def stamped_library() -> ctypes.CDLL:
    out = _build.build_dir() / "scan_phases"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "replay_scan_phases.cu", out / "libreplay_scan_phases.so"
    cu.write_text(stamped_source(_build.SOURCES["replay_scan"].read_text()))
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"build failed:\n{proc.stdout}{proc.stderr}")
    for ln in (proc.stdout + proc.stderr).splitlines():
        if "registers" in ln or "spill" in ln:
            print(args.tag, "phases ptxas", ln.strip(), flush=True)
    lib = ctypes.CDLL(str(so))
    for fn, (restype, argtypes) in _build.SIGNATURES["replay_scan"].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    lib.scan_phases_read.argtypes = [ctypes.c_void_p]
    return lib


def launch_ms(device, addrs, writes) -> float:
    """One replay through the bound library, by CUDA events."""
    cfg, params = build_stack(device, size=64, outstanding=32,
                              issue_overhead_ns=0.5, posted_writes=True,
                              n_accesses=addrs.numel(),
                              max_addr=int(addrs.max()))
    state = stack.init_state(cfg, "cuda")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    rs.replay_scan(cfg, params, state, addrs, writes)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("scan_phases: no CUDA device")
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    plain = _build.library("replay_scan")
    stamped = stamped_library()
    a, w, _ = trace_to_arrays(make_trace(0, n=ACCESSES, pages=16384))
    addrs, writes = torch.from_numpy(a).cuda(), torch.from_numpy(w).cuda()
    n = ACCESSES
    for d in DEVICES:
        _build._libs["replay_scan"] = stamped
        stamped_ms = launch_ms(make_device(d), addrs, writes)
        out = torch.zeros(8, dtype=torch.int64)
        if stamped.scan_phases_read(out.data_ptr()):
            raise SystemExit("reading the stamps failed")
        _build._libs["replay_scan"] = plain
        plain_ms = launch_ms(make_device(d), addrs, writes)
        per = (out.double() / n).tolist()
        print(json.dumps({
            "tag": args.tag, "device": d, "accesses": n,
            "cycles_per_access": dict(zip(PHASES, (round(x, 1)
                                                   for x in per))),
            "stamped_cycles_per_access": round(float(np.sum(per)), 1),
            "stamped_ms": round(stamped_ms, 3),
            "kernel_ms": round(plain_ms, 3),
            "kernel_cycles_per_access_at_max_clock":
                round(plain_ms * 1e3 * clock_mhz / n, 1),
            "sm_clock_max_mhz": clock_mhz}), flush=True)


if __name__ == "__main__":
    main()
