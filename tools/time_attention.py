#!/usr/bin/env python3
"""Time the ``flash_attention`` kernel of one checkout on the card, for A/B
comparisons, and split its time by phase.

    python tools/time_attention.py CHECKOUT TAG [--reps 10] [--phases] [--mma]

Imports ``repro_torch`` from ``CHECKOUT/src`` (building its kernel there if
needed) and, at B 2 and S 8192, at three attention shapes: h2o-danube-3-4b's
(the prefill main path: 32 / 8 heads of 120, causal, window 4096),
glm4-9b's (32 / 2 heads of 128, causal, no window) and hymba-1.5b's (25 /
5 heads of 64, causal, window 1024), holds the kernel against its plain
version once (atol = rtol = 2e-5) and times ``--reps`` launches with CUDA
events after a warm-up.  Prints the card's name and power limit, then one
JSON line per shape: the tag, microseconds a launch, the error, and two
bounds: the split-TF32 tensor-core bound (3 x flops over 495 TFLOP/s) and
the FP32 FMA bound of the same flops (over 67 TFLOP/s).  The peak rates
and the tolerance are ``chip_smoke.py``'s, imported from this tool's
repo.

Compare two checkouts within one machine, in separate processes and in
alternating order (A B B A), e.g. a ``git archive`` of the parent under
``build/``: the card's clock follows its power limit and temperature.

``--phases`` builds a copy of the checkout's ``flash_attention.cu`` with
its ``FA_PHASE`` hooks defined (lane 0 of every warp sums ``clock64``
cycles by phase) into ``build/repro_torch/attention_phases/``, binds it in
place of the kernel's library, and prints, per shape, the mean cycles a
warp spends in each phase over the last launch: ``prologue`` (Q copied
in), ``wait`` (for the producers to split the tile), ``qk`` (Q.K^T),
``softmax`` (scale, mask, online softmax, rescaling O), ``pv`` (P.V),
``free`` (handing the buffer back) and ``epilogue`` (the output), with
each phase's share.  The stamps cost
registers and issue slots of their own: the kernel's time is the plain
run's.

``--mma`` instead builds ``tools/mma_rate.cu`` and prints the TF32
tensor rate (TFLOP/s of m16n8k8 products) of its four modes, at one and
two blocks of 8 warps an SM: the instruction alone, the split-at-use
inner loop, the inner loop over operands split beforehand and read with
ldmatrix, and the split-at-use loop rounding with integer operations.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("checkout")
ap.add_argument("tag")
ap.add_argument("--reps", type=int, default=10)
ap.add_argument("--phases", action="store_true")
ap.add_argument("--mma", action="store_true")
args = ap.parse_args()
sys.path.insert(0, str(Path(args.checkout).resolve() / "src"))
sys.path.append(str(Path(__file__).resolve().parents[1]))   # chip_smoke

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

B, S = 2, 8192
# name: (H, KV, hd, window), all causal
SHAPES = {"h2o-danube-3-4b": (32, 8, 120, 4096), "glm4-9b": (32, 2, 128, 0),
          "hymba-1.5b": (25, 5, 64, 1024)}
PHASES = ("prologue", "wait", "qk", "softmax", "pv", "free", "epilogue")
MAX_WARPS = 1 << 16
HOOKS = r"""
#define FA_PHASE 1
__device__ unsigned long long g_fa_clk[%(max)d * 8];
#define FA_PHASE_BEGIN() \
  unsigned long long fa_acc[7] = {0, 0, 0, 0, 0, 0, 0}; \
  long long fa_last = clock64()
#define FA_PHASE(k) do { const long long fa_now = clock64(); \
  fa_acc[k] += fa_now - fa_last; fa_last = fa_now; } while (0)
#define FA_PHASE_END() do { \
  const long long fa_w = ((static_cast<long long>(blockIdx.z) * gridDim.y \
      + blockIdx.y) * gridDim.x + blockIdx.x) * 8 + (threadIdx.x >> 5); \
  if ((threadIdx.x & 31) == 0 && fa_w < %(max)d) \
    for (int i = 0; i < 7; ++i) g_fa_clk[fa_w * 8 + i] = fa_acc[i]; \
} while (0)
""" % {"max": MAX_WARPS}
READER = r"""
extern "C" int fa_phases_read(unsigned long long* clk, int warps) {
  return (int)cudaMemcpyFromSymbol(clk, g_fa_clk,
                                   sizeof(unsigned long long) * warps * 8);
}
"""


def stamped_library() -> ctypes.CDLL:
    """The kernel's source with its phase hooks defined, built and bound."""
    src = _build.SOURCES["flash_attention"].read_text()
    if "FA_PHASE(" not in src:
        raise SystemExit(f"{args.checkout}: flash_attention.cu has no "
                         "FA_PHASE hooks")
    out = _build.build_dir() / "attention_phases"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "flash_attention_phases.cu", out / "libfa_phases.so"
    cu.write_text(HOOKS + src + READER)
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"build failed:\n{proc.stdout}{proc.stderr}")
    for ln in (proc.stdout + proc.stderr).splitlines():
        if "registers" in ln or "spill" in ln:
            print(args.tag, "phases ptxas", ln.strip(), flush=True)
    lib = ctypes.CDLL(str(so))
    for fn, (restype, argtypes) in _build.SIGNATURES["flash_attention"].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    lib.fa_phases_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def phases(lib, H, KV, window, q, k, v) -> dict:
    """Mean cycles a warp spends in each phase over one launch."""
    fa.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    warps = -(-S * (H // KV) // 128) * KV * B * 8
    if warps > MAX_WARPS:
        raise SystemExit(f"{warps} warps: more than the {MAX_WARPS} stamped")
    clk = torch.zeros(warps * 8, dtype=torch.int64)
    if lib.fa_phases_read(clk.data_ptr(), warps):
        raise SystemExit("reading the stamps failed")
    clk = clk.view(warps, 8)[:, :len(PHASES)].double()
    clk = clk[clk.sum(1) > 0]                 # warps past the last row: none
    mean = clk.mean(0)
    total = float(mean.sum())
    return {"warps": int(clk.shape[0]),
            "cycles_mean": dict(zip(PHASES, (round(x, 1)
                                             for x in mean.tolist()))),
            "share": dict(zip(PHASES, (round(x / total, 4)
                                       for x in mean.tolist()))),
            "cycles_max_total": float(clk.sum(1).max())}


def mma_rates() -> None:
    """TFLOP/s of TF32 m16n8k8 products in each mode of mma_rate.cu."""
    src = Path(__file__).with_name("mma_rate.cu")
    so = _build.build_dir() / "libmma_rate.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"build failed:\n{proc.stdout}{proc.stderr}")
    for ln in (proc.stdout + proc.stderr).splitlines():
        if "registers" in ln or "spill" in ln:
            print(args.tag, "mma_rate ptxas", ln.strip(), flush=True)
    lib = ctypes.CDLL(str(so))
    lib.mma_rate.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 2000
    for mode, mmas in ((0, 1), (1, 3), (2, 3), (3, 3)):
        for per_sm in (1, 2):
            blocks = sms * per_sm
            out = torch.empty(blocks * 256, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def run():
                if lib.mma_rate(mode, iters, blocks, out.data_ptr(), stream):
                    raise SystemExit(f"mma_rate mode {mode} failed")
            run()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                run()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / 3
            products = blocks * 8 * iters * 16 * 8 * mmas
            print(json.dumps({
                "tag": args.tag, "mma_mode": mode, "blocks_per_sm": per_sm,
                "ms": round(ms, 3),
                "tf32_tflops": round(products * 2048 / ms / 1e9, 1),
                "split_tflops": round(products / mmas * 2048 / ms / 1e9, 1),
                "finite": bool(torch.isfinite(out).all())}), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("time_attention: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    if args.mma:
        return mma_rates()
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = stamped_library() if args.phases else None
    if lib is not None:
        _build._libs["flash_attention"] = lib    # the wrapper launches it
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, (H, KV, hd, window) in SHAPES.items():
        q = torch.randn(B, S, H, hd, device=dev, generator=gen)
        k, v = (torch.randn(B, S, KV, hd, device=dev, generator=gen)
                for _ in range(2))
        got = fa.flash_attention(q, k, v, window=window)
        want = fa.flash_attention_plain(q, k, v, window=window)
        ok = smoke.close_err(torch, got, want, smoke.PREFILL_TOL)[2]
        del got, want
        row = {"tag": args.tag, "shape": name, "B": B, "S": S, "H": H,
               "KV": KV, "hd": hd, "window": window, "within_2e-5": ok}
        if lib is not None:
            row.update(phases(lib, H, KV, window, q, k, v))
        else:
            fa.flash_attention(q, k, v, window=window)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                fa.flash_attention(q, k, v, window=window)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / args.reps
            pairs = int(np.minimum(np.arange(1, S + 1), window or S).sum())
            flops = 4 * hd * pairs * B * H
            row.update({
                "us": round(ms * 1e3, 1),
                "split_tf32_bound_us": round(smoke.TF32_SPLIT_TERMS * flops
                                             / smoke.TF32_FLOPS_PER_S * 1e6, 1),
                "fp32_fma_bound_us": round(
                    flops / smoke.FP32_FLOPS_PER_S * 1e6, 1),
                "tflops": round(flops / ms / 1e9, 2)})
        print(json.dumps(row), flush=True)
        del q, k, v


if __name__ == "__main__":
    main()
