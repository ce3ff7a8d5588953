"""Single-token decode attention over a KV cache, as a CUDA kernel for
Hopper beside its plain PyTorch version.

``flash_decode(q, k_cache, v_cache, n_valid)`` has the semantics of the JAX
package's Pallas ``flash_decode_tpu``: q ``(B, H, hd)``, caches
``(B, Skv, KV, hd)`` with ``H = KV * G``; keys at ``pos >= n_valid`` are
masked with ``-1e30``; it returns the locally normalised output
``(B, H, hd)`` and the softmax statistics ``m``, ``l`` ``(B, H)`` (float32)
that :func:`combine_partials` merges across cache shards.

For CUDA tensors the wrapper launches ``csrc/flash_decode.cu``; for CPU
tensors it runs :func:`flash_decode_plain` (the reference's oracle
``flash_decode_ref``).  Nothing falls back from one to the other.  The
kernel reads the caches in place through their strides, so a cache that is
a view (one layer of a stacked decode state) costs no copy.  q and the
output are float32; the caches float32, or int8 for the instance below.
The kernel splits the valid keys of each ``(b, kv head)`` over a cluster of
CTAs as :func:`split_plan` says and merges their partials on the card; it
takes any group size ``G <= MAX_GROUP``.

``flash_decode_int8(q, k_i8, v_i8, k_scale, v_scale, n_valid)`` is the
same attention over int8 caches with float16 scales ``(B, Skv, KV)``, one
a (slot, kv head), as the JAX package's ``_attn_decode`` keeps them under
``kv_dtype="int8"``: its plain version dequantizes (``k_i8 * k_scale``, a
float32 product an element) and runs :func:`flash_decode_plain`; on the
card it launches the kernel's int8 instance, which reads the int8 rows and
dequantizes them in shared memory with the same products.

``LAUNCHES`` counts kernel launches only, so a run can show that it went
through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.models.layers import NEG_INF, decode_attention

LAUNCHES = {"flash_decode": 0, "flash_decode_int8": 0}
MAX_GROUP = 16        # G = H / KV the kernel takes (compiled for 1, 2, 4, 8, 16)
MAX_CLUSTER = 16      # CTAs a (b, kv head); above 8 is a non-portable size
ROWS_PER_CTA = 64     # key rows a CTA is planned for
MAX_CHUNK = 64        # key rows a CTA holds in shared memory at once
CHUNK_FLOATS = 8192   # floats of a chunk's K (or V) rows at most: 32 KB
MAX_HEAD_DIM = 512


class SplitPlan(NamedTuple):
    """How one call spreads over the card: ``cluster`` CTAs for each of
    the ``groups`` ``(b, kv head)`` pairs, CTA rank r owning the key rows
    ``[r * rows, (r + 1) * rows)`` of the valid ones, ``chunk`` rows at a
    time."""
    cluster: int
    rows: int
    chunk: int
    ctas: int

    def ranges(self, n_valid: int) -> list[tuple[int, int]]:
        """Each rank's key range ``[lo, hi)``, as the kernel computes it
        (the last ranks' may be short or empty)."""
        out = []
        for r in range(self.cluster):
            lo = min(n_valid, r * self.rows)
            out.append((lo, min(n_valid, lo + self.rows)))
        return out


def split_plan(n_valid: int, hd: int, groups: int = 1,
               cluster: int | None = None) -> SplitPlan:
    """The kernel's plan for ``n_valid`` keys of head dim ``hd`` over
    ``groups = B * KV`` clusters: about ``ROWS_PER_CTA`` rows a CTA, at
    most ``MAX_CLUSTER`` CTAs a cluster (``cluster`` forces the size)."""
    if cluster is None:
        cluster = min(MAX_CLUSTER, -(-n_valid // ROWS_PER_CTA))
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"a cluster holds 1 to {MAX_CLUSTER} CTAs, "
                         f"got {cluster}")
    rows = -(-n_valid // cluster)
    chunk = min(MAX_CHUNK, -(-rows // 8) * 8, CHUNK_FLOATS // hd // 8 * 8)
    return SplitPlan(cluster, rows, chunk, groups * cluster)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(q, k_cache, v_cache, n_valid: int,
           cache_dtype: torch.dtype = torch.float32) -> None:
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"need q (B, H, hd) and matching caches "
                         f"(B, Skv, KV, hd), got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, H, hd = q.shape
    Bk, Skv, KV, hdk = k_cache.shape
    if (Bk, hdk) != (B, hd) or KV < 1 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} does not fit caches "
                         f"{tuple(k_cache.shape)} (need equal B and hd, "
                         "H a multiple of KV)")
    if q.dtype != torch.float32:
        raise ValueError(f"flash_decode runs in float32, got q {q.dtype}")
    for t in (k_cache, v_cache):
        if t.dtype != cache_dtype:
            raise ValueError(f"this flash_decode takes {cache_dtype} caches, "
                             f"got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"tensors on {q.device} and {t.device}")
    if not 1 <= n_valid <= Skv:
        raise ValueError(f"n_valid={n_valid} must lie in [1, Skv={Skv}]")


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, n_valid):
    """Decode attention: ``(out (B, H, hd), m (B, H), l (B, H))``."""
    n_valid = int(n_valid)
    _check(q, k_cache, v_cache, n_valid)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, n_valid)
    return _launch(q, k_cache, v_cache, n_valid)


def flash_decode_int8(q: torch.Tensor, k_i8: torch.Tensor, v_i8: torch.Tensor,
                      k_scale: torch.Tensor, v_scale: torch.Tensor, n_valid):
    """Decode attention over int8 caches and their float16 scales: ``(out
    (B, H, hd), m (B, H), l (B, H))``."""
    n_valid = int(n_valid)
    _check(q, k_i8, v_i8, n_valid, cache_dtype=torch.int8)
    B, Skv, KV, _ = k_i8.shape
    for s in (k_scale, v_scale):
        if s.dtype != torch.float16:
            raise ValueError(f"flash_decode_int8 takes float16 scales, got "
                             f"{s.dtype}")
        if tuple(s.shape) != (B, Skv, KV) or s.device != q.device:
            raise ValueError(f"scales of shape {tuple(s.shape)} on "
                             f"{s.device} for caches {tuple(k_i8.shape)} on "
                             f"{q.device} (need (B, Skv, KV))")
    if q.device.type == "cpu":
        return flash_decode_int8_plain(q, k_i8, v_i8, k_scale, v_scale,
                                       n_valid)
    return _launch(q, k_i8, v_i8, n_valid, scales=(k_scale, v_scale))


def dequantize(cache: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 cache rows times their float16 scales, in float32 (the
    reference's ``k_cache.astype(f32) * k_scale.astype(f32)[..., None]``)."""
    return cache.float() * scale.float()[..., None]


def flash_decode_int8_plain(q, k_i8, v_i8, k_scale, v_scale, n_valid):
    """Dequantize, then :func:`flash_decode_plain`."""
    return flash_decode_plain(q, dequantize(k_i8, k_scale),
                              dequantize(v_i8, v_scale), n_valid)


def flash_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, n_valid):
    """Masked full-length decode attention and its ``(m, l)`` statistics
    (the reference's ``ref.flash_decode_ref``)."""
    out = decode_attention(q, k_cache, v_cache, n_valid)
    B, Smax, KV, hd = k_cache.shape
    H = q.shape[1]
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,bckd->bkgc", qg.float(), k_cache.float()) \
        * hd ** -0.5
    pos = torch.arange(Smax, device=q.device)
    n = torch.as_tensor(n_valid, device=q.device).reshape(-1, 1)
    s = torch.where((pos[None, :] < n)[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    l = torch.exp(s - m[..., None]).sum(-1)
    return out, m.reshape(B, H), l.reshape(B, H)


def combine_partials(outs: torch.Tensor, ms: torch.Tensor,
                     ls: torch.Tensor) -> torch.Tensor:
    """Merge per-shard decode partials along a leading shard axis.

    outs: (n, B, H, hd) locally normalised outputs; ms/ls: (n, B, H).
    Returns the exact global attention output (B, H, hd)."""
    m_glob = ms.amax(dim=0)
    w = torch.exp(ms - m_glob[None]) * ls                # un-normalise
    denom = w.sum(dim=0)
    num = (outs * w[..., None]).sum(dim=0)
    return num / torch.clamp(denom, min=1e-37)[..., None]


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.flash_decode_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def _check_rows(*caches) -> None:
    """The kernel copies cache rows as 16-byte vectors (int8 rows as 4-byte
    words): unit stride along hd, hd a multiple of 4 (at most
    ``MAX_HEAD_DIM``) and every row 16-byte (int8: 4-byte) aligned."""
    for t in caches:
        align = t.element_size() * 4
        if (t.stride(-1) != 1 or t.shape[-1] % 4 or t.data_ptr() % align
                or t.shape[-1] > MAX_HEAD_DIM
                or any(s % 4 for s in t.stride()[:-1])):
            raise ValueError(
                f"the kernel needs caches with hd a multiple of 4 up to "
                f"{MAX_HEAD_DIM} and {align}-byte aligned rows, got shape "
                f"{tuple(t.shape)}, strides {t.stride()}")


def _launch(q, k_cache, v_cache, n_valid: int, plan: SplitPlan | None = None,
            scales=None):
    """Launch the kernel on the tensors' card, on PyTorch's current stream,
    with ``plan`` (``split_plan``'s when not given): its int8 instance when
    ``scales`` (``(k_scale, v_scale)``) are given."""
    from repro_torch.kernels import _build

    B, H, hd = q.shape
    KV = k_cache.shape[2]
    if H // KV > MAX_GROUP:
        raise ValueError(f"the kernel takes group sizes H / KV up to "
                         f"{MAX_GROUP}, got {H // KV}")
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    _check_rows(k_cache, v_cache)
    plan = plan if plan is not None else split_plan(n_valid, hd, B * KV)
    lib = _build.library("flash_decode")
    q = q.contiguous()
    out = torch.empty((B, H, hd), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    l = torch.empty((B, H), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if scales is None:
            name = "flash_decode"
            err = lib.flash_decode_launch(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                out.data_ptr(), m.data_ptr(), l.data_ptr(), B, H, KV, hd,
                n_valid, plan.cluster, plan.rows, plan.chunk,
                *k_cache.stride()[:3], *v_cache.stride()[:3], hd ** -0.5,
                stream)
        else:
            name = "flash_decode_int8"
            k_scale, v_scale = scales
            err = lib.flash_decode_int8_launch(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(),
                m.data_ptr(), l.data_ptr(), B, H, KV, hd, n_valid,
                plan.cluster, plan.rows, plan.chunk, *k_cache.stride()[:3],
                *v_cache.stride()[:3], *k_scale.stride(), *v_scale.stride(),
                hd ** -0.5, stream)
        _raise_on(lib, err, f"{name} kernel launch")
        LAUNCHES[name] += 1
    return out, m, l


def max_active_clusters(G: int, hd: int, plan: SplitPlan,
                        int8: bool = False) -> int:
    """The most clusters of ``plan`` that the card holds at once
    (``cudaOccupancyMaxActiveClusters``) for the float32 or the int8
    instance, for the plan's report."""
    from repro_torch.kernels import _build

    lib = _build.library("flash_decode")
    n = ctypes.c_int(0)
    _raise_on(lib, lib.flash_decode_max_active_clusters(
        G, hd, plan.chunk, plan.cluster, int(int8), ctypes.byref(n)),
        "cudaOccupancyMaxActiveClusters")
    return n.value
