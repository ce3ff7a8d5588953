#!/usr/bin/env python3
"""Time the ``flash_attention`` kernel of one checkout on the card, for A/B
comparisons, and split its time by phase.

    python tools/time_attention.py CHECKOUT TAG [--reps 10] [--phases] [--mma]
    python tools/time_attention.py CHECKOUT TAG --backward [--phases]
    python tools/time_attention.py CHECKOUT TAG --mma-rounding

Imports ``repro_torch`` from ``CHECKOUT/src`` (building its kernel there if
needed) and, at B 2 and S 8192, at three attention shapes: h2o-danube-3-4b's
(the prefill main path: 32 / 8 heads of 120, causal, window 4096),
glm4-9b's (32 / 2 heads of 128, causal, no window) and hymba-1.5b's (25 /
5 heads of 64, causal, window 1024), holds the kernel against its plain
version once (atol = rtol = 2e-5; a digest of its out beside, so two
checkouts' outputs can be compared bit for bit) and times ``--reps``
launches with CUDA events after a warm-up.  Prints the card's name and power limit, then one
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

``--backward`` times the training backward instead: the ``delta``,
``dkdv`` and ``dq`` kernels of ``csrc/flash_attention_bwd.cu``, each by
its own C entry point, at B 2 and S 2048, causal, at minicpm-2b's shape
(36 / 36 heads of 64, the ``[train]`` phase's) and h2o-danube-3-4b's (32 /
8 heads of 120, G 4).  It holds ``flash_attention_bwd`` against
``flash_attention_bwd_plain`` once (atol = rtol = 2e-5; a digest of dq,
dk and dv beside), then prints microseconds a launch of each kernel, of
the three through the wrapper, and of SDPA's backward (autograd through
``F.scaled_dot_product_attention`` less its forward), each kernel's
split-TF32 and FP32 FMA bounds and ``backward_over_sdpa``.  With
``--phases`` it builds a copy of ``flash_attention_bwd.cu`` with its
``BWD_PHASE`` hooks defined into ``build/repro_torch/attention_phases/``
and prints the mean cycles a compute warp of each kernel spends in
``wait`` (for the producers' tile), ``products`` (S and dP), ``scores``
(P and dS), ``accumulate`` (dV and dK, or dQ), ``free`` and
``epilogue``.

``--mma`` instead builds ``tools/mma_rate.cu`` and prints the TF32
tensor rate (TFLOP/s of m16n8k8 products) of its four modes, at one and
two blocks of 8 warps an SM: the instruction alone, the split-at-use
inner loop, the inner loop over operands split beforehand and read with
ldmatrix, and the split-at-use loop rounding with integer operations.

``--mma-rounding`` builds ``tools/mma_rounding.cu``, runs one TF32
m16n8k8 product a warp on 12,000 warps of seeded random fragments (TF32
values of 11 bits, exponents spread over +-2 to +-6, the accumulator zero
or spread over 2^-24 to 2^2 times the products' scale) and prints the
share of the 1,536,000 outputs each model of the rounding gives bit for
bit: the exact sum rounded to nearest, and the terms (the 8 products and
c) aligned to the largest nominal exponent E (a product's is the sum of
its factors' exponents), each truncated to a multiple of 2^(E + 1 - bits),
summed exactly and truncated to float32, for bits 24 to 28.  The
backward's S and dP sums (``csrc/flash_attention_bwd.cu``) and the CPU
model's ``mma_hw`` follow the model that matches.
"""

import argparse
import ctypes
import hashlib
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
ap.add_argument("--backward", action="store_true")
ap.add_argument("--mma-rounding", action="store_true")
args = ap.parse_args()
sys.path.append(str(Path(__file__).resolve().parents[1]))   # chip_smoke

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402

# chip_smoke puts its own checkout's src first: the checkout timed goes
# before it
SRC = Path(args.checkout).resolve() / "src"
sys.path.insert(0, str(SRC))
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

if not Path(fa.__file__).resolve().is_relative_to(SRC):
    raise SystemExit(f"imported {fa.__file__}, not the checkout's {SRC}")

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
BWD_B, BWD_S = 2, 2048
# name: (H, KV, hd), causal
BWD_SHAPES = {"minicpm-2b": (36, 36, 64), "h2o-danube-3-4b": (32, 8, 120)}
BWD_PHASES = ("wait", "products", "scores", "accumulate", "free",
              "epilogue")
BWD_HOOKS = HOOKS.replace("FA_PHASE", "BWD_PHASE").replace(
    "fa_acc[7] = {0, 0, 0, 0, 0, 0, 0}", "fa_acc[6] = {0, 0, 0, 0, 0, 0}") \
    .replace("i < 7", "i < 6")
READER = r"""
extern "C" int fa_phases_read(unsigned long long* clk, int warps) {
  return (int)cudaMemcpyFromSymbol(clk, g_fa_clk,
                                   sizeof(unsigned long long) * warps * 8);
}
extern "C" int fa_phases_zero() {
  void* p;
  const cudaError_t e = cudaGetSymbolAddress(&p, g_fa_clk);
  return e ? (int)e : (int)cudaMemset(p, 0, sizeof(g_fa_clk));
}
"""


def stamped_library(name: str = "flash_attention") -> ctypes.CDLL:
    """Kernel source ``name`` with its phase hooks defined, built and
    bound (``-I`` its directory, for the headers it shares)."""
    src = _build.SOURCES[name].read_text()
    macro, text = (("BWD_PHASE", BWD_HOOKS) if name.endswith("_bwd")
                   else ("FA_PHASE", HOOKS))
    if f"{macro}(" not in src:
        raise SystemExit(f"{args.checkout}: {name}.cu has no {macro} hooks")
    out = _build.build_dir() / "attention_phases"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}_phases.cu", out / f"lib{name}_phases.so"
    cu.write_text(text + src + READER)
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(_build.SOURCES[name].parent), "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"build failed:\n{proc.stdout}{proc.stderr}")
    for ln in (proc.stdout + proc.stderr).splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print(args.tag, "phases ptxas", ln.strip(), flush=True)
    lib = ctypes.CDLL(str(so))
    for fn, (restype, argtypes) in _build.SIGNATURES[name].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    lib.fa_phases_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fa_phases_zero.argtypes = []
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


def events_us(fn, reps: int) -> float:
    """Mean microseconds a call of ``fn`` by CUDA events, after a warm
    call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def read_phases(lib, warps: int) -> dict:
    """Mean cycles a stamped compute warp spent in each phase."""
    torch.cuda.synchronize()
    clk = torch.zeros(warps * 8, dtype=torch.int64)
    if lib.fa_phases_read(clk.data_ptr(), warps):
        raise SystemExit("reading the stamps failed")
    clk = clk.view(warps, 8)[:, :len(BWD_PHASES)].double()
    clk = clk[clk.sum(1) > 0]                 # producer and absent warps
    mean = clk.mean(0)
    total = float(mean.sum())
    return {"warps": int(clk.shape[0]),
            "cycles_mean": dict(zip(BWD_PHASES, (round(x, 1)
                                                 for x in mean.tolist()))),
            "share": dict(zip(BWD_PHASES, (round(x / total, 4)
                                           for x in mean.tolist())))}


def backward() -> None:
    """Time (or, with --phases, split by phase) the backward kernels of the
    checkout at the train shapes."""
    import torch.nn.functional as F

    lib = (stamped_library("flash_attention_bwd") if args.phases else
           _build.library("flash_attention_bwd"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, S = BWD_B, BWD_S
    for name, (H, KV, hd) in BWD_SHAPES.items():
        q, do = (torch.randn(B, S, H, hd, device=dev, generator=gen)
                 for _ in range(2))
        k, v = (torch.randn(B, S, KV, hd, device=dev, generator=gen)
                for _ in range(2))
        out, lse = fa.flash_attention_lse(q, k, v)
        delta = fa.flash_attention_bwd_delta(out, do)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        stream = torch.cuda.current_stream().cuda_stream
        shape = (B, S, S, H, KV, hd, 1, 0, hd ** -0.5, stream)
        ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
        calls = {
            "delta": lambda: lib.flash_attention_bwd_delta_launch(
                do.data_ptr(), out.data_ptr(), delta.data_ptr(), B, S, H,
                hd, stream),
            "dkdv": lambda: lib.flash_attention_bwd_dkdv_launch(
                *ptrs, dk.data_ptr(), dv.data_ptr(), *shape),
            "dq": lambda: lib.flash_attention_bwd_dq_launch(
                *ptrs, dq.data_ptr(), *shape)}
        for kname, call in calls.items():
            if call():
                raise SystemExit(f"{kname} launch failed")
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do)
        errs = [smoke.close_err(torch, a, b, smoke.PREFILL_TOL)
                for a, b in zip((dq, dk, dv), want)]
        digest = hashlib.sha256(b"".join(
            t.cpu().numpy().tobytes() for t in (dq, dk, dv))).hexdigest()[:16]
        del want
        row = {"tag": args.tag, "shape": name, "B": B, "S": S, "H": H,
               "KV": KV, "hd": hd, "causal": True,
               "within_2e-5": all(e[2] for e in errs),
               "max_abs_err": [float(f"{e[0]:.3e}") for e in errs],
               "digest": digest}
        if args.phases:
            for kname in ("dkdv", "dq"):
                if lib.fa_phases_zero() or calls[kname]():
                    raise SystemExit(f"{kname} launch failed")
                row[kname] = read_phases(lib, MAX_WARPS)
            print(json.dumps(row), flush=True)
            continue
        pairs = S * (S + 1) // 2 * B * H
        flops = {"dkdv": 8 * hd * pairs, "dq": 6 * hd * pairs}
        for kname, call in calls.items():
            us = events_us(call, args.reps)
            row[f"{kname}_us"] = round(us, 1)
            if kname in flops:
                row[f"{kname}_split_tf32_bound_us"] = round(
                    smoke.TF32_SPLIT_TERMS * flops[kname]
                    / smoke.TF32_FLOPS_PER_S * 1e6, 1)
                row[f"{kname}_fp32_fma_bound_us"] = round(
                    flops[kname] / smoke.FP32_FLOPS_PER_S * 1e6, 1)
                row[f"{kname}_split_tflops"] = round(
                    smoke.TF32_SPLIT_TERMS * flops[kname] / us / 1e6, 1)
        row["three_us"] = round(sum(row[f"{n}_us"] for n in calls), 1)
        row["wrapper_us"] = round(events_us(
            lambda: fa.flash_attention_bwd(q, k, v, out, lse, do),
            args.reps), 1)
        leaves = [t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v)]
        dot = do.transpose(1, 2)
        gqa = H != KV

        def sdpa_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(*leaves, is_causal=True,
                                               enable_gqa=gqa)

        def sdpa_both():
            o = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                               enable_gqa=gqa)
            torch.autograd.grad(o, leaves, dot)

        row["sdpa_backward_us"] = round(events_us(sdpa_both, args.reps)
                                        - events_us(sdpa_fwd, args.reps), 1)
        row["backward_over_sdpa"] = round(row["three_us"]
                                          / row["sdpa_backward_us"], 3)
        print(json.dumps(row), flush=True)
        del q, k, v, do, out, lse, delta, dq, dk, dv, leaves, dot


def mma_rounding() -> None:
    """Share of mma_rounding.cu's outputs each rounding model gives."""
    src = Path(__file__).with_name("mma_rounding.cu")
    so = _build.build_dir() / "libmma_rounding.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"build failed:\n{proc.stdout}{proc.stderr}")
    rng = np.random.default_rng(7)
    n = 12000

    def tf32_values(shape, spread):
        e = rng.integers(-spread, spread + 1, size=shape)
        m = rng.integers(0, 1024, size=shape)
        return (rng.choice([-1.0, 1.0], size=shape)
                * np.ldexp(1.0 + m / 1024.0, e)).astype(np.float32)

    regime = rng.integers(0, 4, size=n)
    a = np.empty((n, 32, 4), np.float32)
    b = np.empty((n, 32, 2), np.float32)
    c = np.zeros((n, 32, 4), np.float32)
    for r, spread, c_top in ((0, 2, None), (1, 6, None), (2, 3, 0),
                             (3, 4, 8)):
        at = np.nonzero(regime == r)[0]
        a[at] = tf32_values((len(at), 32, 4), spread)
        b[at] = tf32_values((len(at), 32, 2), spread)
        if c_top is not None:
            e = rng.integers(c_top - 24, c_top + 3, size=(len(at), 32, 4))
            c[at] = (rng.standard_normal((len(at), 32, 4))
                     * np.ldexp(1.0, e)).astype(np.float32)
    lib = ctypes.CDLL(str(so))
    lib.mma_rounding.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    ta, tb = (torch.from_numpy(x.view(np.int32).copy()).cuda()
              for x in (a, b))
    tc = torch.from_numpy(c).cuda()
    td = torch.empty_like(tc)
    if lib.mma_rounding(ta.data_ptr(), tb.data_ptr(), tc.data_ptr(),
                        td.data_ptr(), n):
        raise SystemExit("mma_rounding failed")
    got = td.cpu().numpy()
    # the fragments as matrices (the m16n8k8 maps of the PTX ISA)
    g, t = np.arange(32) >> 2, np.arange(32) & 3
    A, B = np.zeros((n, 16, 8)), np.zeros((n, 8, 8))
    C, D = np.zeros((n, 16, 8)), np.zeros((n, 16, 8))
    for i in range(4):
        A[:, g + 8 * (i & 1), t + 4 * (i >> 1)] = a[:, :, i]
        C[:, g + 8 * (i >> 1), 2 * t + (i & 1)] = c[:, :, i]
        D[:, g + 8 * (i >> 1), 2 * t + (i & 1)] = got[:, :, i]
    for i in range(2):
        B[:, t + 4 * i, g] = b[:, :, i]
    prod = np.moveaxis(A[:, :, :, None] * B[:, None], 2, 3)   # n,16,8,k
    terms = np.concatenate([prod, C[..., None]], -1)

    def nominal(x):
        e = np.frexp(np.where(x != 0, np.abs(x), 1.0))[1] - 1
        return np.where(x != 0, e, -(1 << 20))

    e = np.moveaxis(nominal(A)[:, :, :, None] + nominal(B)[:, None], 2, 3)
    e = np.where(prod != 0, e, -(1 << 20))
    top = np.maximum(e.max(-1), nominal(C))

    def toward_zero(x):
        f = x.astype(np.float32)
        over = np.abs(f.astype(np.float64)) > np.abs(x)
        return np.where(over, np.nextafter(f, np.float32(0)), f)

    shares = {"nearest": float(np.mean(
        terms.sum(-1).astype(np.float32) == D))}
    for bits in range(24, 29):
        unit = np.ldexp(1.0, top + 1 - bits)[..., None]
        total = (np.trunc(terms / unit) * unit).sum(-1)
        shares[f"aligned_{bits}_bits_truncated"] = float(np.mean(
            toward_zero(total) == D))
    print(json.dumps({"tag": args.tag, "outputs": int(D.size),
                      "share_bit_equal": shares}), flush=True)


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
    print(args.tag, "repro_torch from", Path(fa.__file__).parents[1],
          flush=True)
    if args.mma_rounding:
        return mma_rounding()
    if args.mma:
        return mma_rates()
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.backward:
        return backward()
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
        digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]
        del got, want
        row = {"tag": args.tag, "shape": name, "B": B, "S": S, "H": H,
               "KV": KV, "hd": hd, "window": window, "within_2e-5": ok,
               "digest": digest}
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
