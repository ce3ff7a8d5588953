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
a view (one layer of a stacked decode state) costs no copy.  float32 only.

``LAUNCHES`` counts kernel launches only, so a run can show that it went
through the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import NEG_INF, decode_attention

LAUNCHES = {"flash_decode": 0}
GROUP_SIZES = (1, 2, 4, 8, 16)     # G = H / KV the kernel is compiled for


def reset_launches() -> None:
    LAUNCHES["flash_decode"] = 0


def _check(q, k_cache, v_cache, n_valid: int) -> None:
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
    for t in (q, k_cache, v_cache):
        if t.dtype != torch.float32:
            raise ValueError(f"flash_decode runs in float32, got {t.dtype}")
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
    """The kernel copies cache rows as 16-byte vectors: unit stride along
    hd, hd a multiple of 4 and every row 16-byte aligned."""
    for t in caches:
        if (t.stride(-1) != 1 or t.shape[-1] % 4 or t.data_ptr() % 16
                or any(s % 4 for s in t.stride()[:-1])):
            raise ValueError(
                f"the kernel needs caches with hd a multiple of 4 and "
                f"16-byte aligned rows, got shape {tuple(t.shape)}, "
                f"strides {t.stride()}")


def _launch(q, k_cache, v_cache, n_valid: int):
    """Launch the kernel on the tensors' card, on PyTorch's current stream."""
    from repro_torch.kernels import _build

    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    B, H, hd = q.shape
    KV = k_cache.shape[2]
    if H // KV not in GROUP_SIZES:
        raise ValueError(f"group size H / KV = {H // KV} is not one of "
                         f"{GROUP_SIZES}")
    _check_rows(k_cache, v_cache)
    lib = _build.library("flash_decode")
    q = q.contiguous()
    out = torch.empty((B, H, hd), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    l = torch.empty((B, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.flash_decode_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), m.data_ptr(), l.data_ptr(), B, H, KV, hd,
            n_valid, *k_cache.stride()[:3], *v_cache.stride()[:3],
            hd ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(lib, err, "flash_decode kernel launch")
        LAUNCHES["flash_decode"] += 1
    return out, m, l
