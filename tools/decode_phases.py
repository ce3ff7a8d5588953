#!/usr/bin/env python3
"""Where the ``flash_decode`` kernel's time goes, phase by phase, on the card.

    python tools/decode_phases.py

Builds a copy of ``src/repro_torch/kernels/csrc/flash_decode.cu`` with
timestamps added (thread 0 of every CTA reads ``clock64()`` at each phase
boundary, and ``%globaltimer`` at its start and end) into
``build/repro_torch/decode_phases/``, binds it in place of the kernel's
library and runs ``split_plan``'s plan (and forced cluster sizes) at the
attention shapes of ``tools/time_decode.py``, on caches stacked 24 deep and
rotated call by call.  After 30 calls it prints one JSON line per plan: the
SM cycles of each phase of the last call, mean and max over its CTAs, the
spread of the CTAs' start times and the time from the first start to the
last end (ns).  Phases, in order: ``keys`` (start to the first chunk's keys
in shared memory: the device-memory time), ``scores``, ``softmax`` (with
the wait for the first chunk's values), ``pv`` (p . V of the first chunk
and every later chunk), ``push`` (row-split sums, the stores into the
owners' inboxes and the cluster barrier, which waits for the slowest CTA
of the cluster), ``merge``.  The added stamps cost a few cycles each; the
kernel's own time is ``tools/time_decode.py``'s.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402

PHASES = ("keys", "scores", "softmax", "pv", "push", "merge")
LAYERS, CALLS, B = 24, 30, 4
RUNS = [("h2o-danube-3-4b", 512, None), ("h2o-danube-3-4b", 512, 1),
        ("h2o-danube-3-4b", 512, 16), ("h2o-danube-3-4b", 4096, None),
        ("glm4-9b", 512, None), ("hymba-1_5b", 512, None)]
HEADER = r"""
__device__ unsigned long long g_clk[65536 * 8];
__device__ unsigned long long g_gt[65536 * 2];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(k) do { if (threadIdx.x == 0) \
  g_clk[blockIdx.x * 8 + (k)] = clock64(); } while (0)
"""
READER = r"""
extern "C" int decode_phases_read(unsigned long long* clk,
                                  unsigned long long* gt, int n) {
  cudaMemcpyFromSymbol(clk, g_clk, sizeof(unsigned long long) * n * 8);
  return (int)cudaMemcpyFromSymbol(gt, g_gt, sizeof(unsigned long long) * n * 2);
}
"""


def instrumented(src: str) -> str:
    """The kernel's source with a stamp at each phase boundary."""
    out, barriers = [], 0
    for ln in src.splitlines():
        if "if (splits > 1 && pair_of[0] >= 0) {" in ln:
            out.append("  STAMP(4);")
        out.append(ln)
        if ln.startswith("namespace cg = cooperative_groups;"):
            out.append(HEADER)
        elif ln.strip() == "flash_decode_kernel(const Params p) {":
            out += ["  if (threadIdx.x == 0) g_gt[blockIdx.x * 2] = gtime();",
                    "  STAMP(0);"]
        elif "// this chunk's keys (its values may still fly)" in ln:
            barriers = 1
        elif ln.strip() == "__syncthreads();" and 1 <= barriers <= 3:
            out.append(f"    if (t == 0) STAMP({barriers});")
            barriers += 1
        elif "cluster.sync();" in ln:
            out.append("  STAMP(5);")
    text = "\n".join(out)
    end = text.index("\n}\n\n// Clear a launch error")
    text = (text[:end] + "\n  STAMP(6);\n  if (threadIdx.x == 0) "
            "g_gt[blockIdx.x * 2 + 1] = gtime();" + text[end:])
    assert text.count("STAMP(") == 8, "a phase boundary was not found"
    return text + READER


def build() -> ctypes.CDLL:
    out = _build.build_dir() / "decode_phases"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "flash_decode_phases.cu", out / "libflash_decode_phases.so"
    cu.write_text(instrumented(_build.SOURCES["flash_decode"].read_text()))
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"build failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn, (restype, argtypes) in _build.SIGNATURES["flash_decode"].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    lib.decode_phases_read.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    return lib


def main():
    if not torch.cuda.is_available():
        raise SystemExit("decode_phases: no CUDA device")
    lib = build()
    _build._libs["flash_decode"] = lib       # the wrapper launches this copy
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for arch, n, cluster in RUNS:
        cfg = get_arch(arch)
        KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        G = cfg.n_heads // KV
        q = torch.randn(B, KV * G, hd, device=dev, generator=gen)
        kc, vc = (torch.randn(LAYERS, B, n, KV, hd, device=dev, generator=gen)
                  for _ in range(2))
        plan = fd.split_plan(n, hd, B * KV, cluster=cluster)
        for i in range(CALLS):
            fd._launch(q, kc[i % LAYERS], vc[i % LAYERS], n, plan)
        torch.cuda.synchronize()
        clk = torch.zeros(plan.ctas * 8, dtype=torch.int64)
        gt = torch.zeros(plan.ctas * 2, dtype=torch.int64)
        if lib.decode_phases_read(clk.data_ptr(), gt.data_ptr(), plan.ctas):
            raise SystemExit("reading the stamps failed")
        clk = clk.view(-1, 8)[:, :7].double()
        gt = gt.view(-1, 2).double()
        d = clk[:, 1:] - clk[:, :-1]
        print(json.dumps({
            "shape": arch, "G": G, "hd": hd, "n_valid": n,
            "plan": plan._asdict(),
            "cycles_mean": dict(zip(PHASES, (round(x, 1) for x in
                                             d.mean(0).tolist()))),
            "cycles_max": dict(zip(PHASES, d.max(0).values.tolist())),
            "start_spread_ns": float(gt[:, 0].max() - gt[:, 0].min()),
            "first_start_to_last_end_ns": float(gt[:, 1].max()
                                                - gt[:, 0].min())}),
            flush=True)
        del q, kc, vc


if __name__ == "__main__":
    main()
