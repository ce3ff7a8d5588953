"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and bind them with
``ctypes``.

Each source has a plain C interface, so it compiles in seconds (no PyTorch
headers) into its own shared library.  Libraries are named by a hash of
their source and flags, so an edited source is never served from a stale
build.  They land, at first use, in ``build/repro_torch/`` at the
repository root when the package lies in a checkout's ``src/``, else in
``build/`` inside the installed package.  Nothing here runs at import
time: the CPU tests import every module of the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
SOURCES = {name: CSRC / f"{name}.cu"
           for name in ("cache_sim", "flash_attention", "flash_decode",
                        "page_gather")}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures, by library: {function: (restype, argtypes)}
SIGNATURES = {
    "cache_sim": {
        "cache_sim_launch": (_I, [_P, _P, ctypes.c_int64] + [_I] * 5 + [_P]
                             + [_I] * 8 + [_P] * 7),
        "cache_sim_hash_mul": (ctypes.c_uint32, []),
        "cache_sim_smem_optin": (_I, [_I, ctypes.POINTER(_I)]),
        "cache_sim_error_string": (ctypes.c_char_p, [_I]),
    },
    "flash_attention": {
        "flash_attention_launch": (_I, [_P] * 4 + [_I] * 6 + [_L] * 9
                                   + [_I, _I, ctypes.c_float, _P]),
        "flash_attention_error_string": (ctypes.c_char_p, [_I]),
    },
    "flash_decode": {
        "flash_decode_launch": (_I, [_P] * 6 + [_I] * 8 + [_L] * 6
                                + [ctypes.c_float, _P]),
        "flash_decode_max_active_clusters": (_I, [_I] * 4
                                             + [ctypes.POINTER(_I)]),
        "flash_decode_error_string": (ctypes.c_char_p, [_I]),
    },
    "page_gather": {
        "page_gather_launch": (_I, [_P] * 3 + [_L, _I, _I, _P]),
        "page_scatter_launch": (_I, [_P] * 3 + [_L, _I, _I, _P]),
        "page_gather_error_string": (ctypes.c_char_p, [_I]),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each library, by name;
# kept beside the library, so one built by an earlier run has its report too
build_log: dict[str, str] = {}


def build_dir() -> Path:
    """Where built libraries go, from the package's own location only."""
    pkg = Path(__file__).resolve().parents[1]
    if pkg.parent.name == "src":
        return pkg.parents[1] / "build" / "repro_torch"
    return pkg / "build"


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                       "the CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile source ``name`` unless it is built already; return the
    library's path.  Raises with the compiler's output on failure."""
    out = library_path(name)
    log = out.with_suffix(".ptxas")
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        build_log[name] = proc.stdout
        if proc.returncode != 0:
            raise RuntimeError(f"CUDA build of {name} failed: nvcc exited "
                               f"{proc.returncode}\n{proc.stdout}")
        tmp_log = log.with_suffix(f".{os.getpid()}.log")
        tmp_log.write_text(proc.stdout)
        os.replace(tmp_log, log)   # the report first: a library has one
        os.replace(tmp, out)   # atomic: concurrent builders agree
    elif name not in build_log and log.exists():
        build_log[name] = log.read_text()
    return out


def library(name: str) -> ctypes.CDLL:
    """The built and bound library ``name`` (building it on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (restype, argtypes) in SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return lib
