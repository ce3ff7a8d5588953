"""Prefill attention over a whole sequence, as a CUDA kernel for Hopper
beside its plain PyTorch version.

``flash_attention(q, k, v, causal=True, window=0)`` has the semantics of
the JAX package's Pallas ``flash_attention_tpu``: q ``(B, S, H, hd)``,
k / v ``(B, Skv, KV, hd)`` with ``H = KV * G`` (query head ``h`` reads KV
head ``h // G``); keys at ``k >= Skv`` are masked, and when ``causal`` also
keys after the query and, for ``window > 0``, keys ``window`` or more
positions before it.  It returns ``(B, S, H, hd)``.

For CUDA tensors the wrapper launches ``csrc/flash_attention.cu``; for CPU
tensors it runs :func:`flash_attention_plain` (the reference's oracle
``flash_attention_ref``).  Nothing falls back from one to the other.  The
kernel reads q, k and v in place through their strides, so views cost no
copy.  It takes both products on the tensor cores in split TF32: each
float32 operand ``x`` enters as ``big = tf32(x)`` and ``small = tf32(x -
big)``, and ``a . b`` is ``small_a . big_b + big_a . small_b + big_a .
big_b``, so the result keeps float32's accuracy (plain TF32 would not:
``tests/test_torch_attention_tf32.py``).  cuBLAS's float32 products
elsewhere keep TF32 off.  Both paths take float32 only, head dims that
are multiples of 4 up to 128 and the group sizes in ``GROUP_SIZES``, and
refuse tensors that require a gradient: the backward kernel comes with
the training slice.

``LAUNCHES`` counts kernel launches only, so a run can show that it went
through the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import attention_ref

LAUNCHES = {"flash_attention": 0}
GROUP_SIZES = (1, 2, 4, 5, 8, 16)  # G = H / KV held against the plain version
MAX_HEAD_DIM = 128
PLAIN_SCORES = 1 << 28             # score elements per chunk of query rows


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def _check(q, k, v, causal: bool, window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q (B, S, H, hd) and k, v (B, Skv, KV, hd) of "
                         f"one shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    Bk, Skv, KV, hdk = k.shape
    if (Bk, hdk) != (B, hd) or KV < 1 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)} "
                         "(need equal B and hd, H a multiple of KV)")
    if S < 1 or Skv < 1:
        raise ValueError(f"empty sequence: S={S}, Skv={Skv}")
    if causal and Skv != S:
        raise ValueError(f"causal attention needs Skv == S, got S={S}, "
                         f"Skv={Skv}")
    if window < 0:
        raise ValueError(f"window={window} must be >= 0")
    if hd % 4 or not 4 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} is not supported: the kernel takes "
                         f"multiples of 4 up to {MAX_HEAD_DIM}")
    if H // KV not in GROUP_SIZES:
        raise ValueError(f"group size H / KV = {H // KV} is not one of "
                         f"{GROUP_SIZES}")
    for t in (q, k, v):
        if t.dtype != torch.float32:
            raise ValueError(f"flash_attention runs in float32, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"tensors on {q.device} and {t.device}")
        if t.requires_grad:
            raise ValueError(
                "flash_attention has no backward yet (it comes with the "
                "training slice, ROADMAP Queue A item 14): call it on "
                "tensors that do not require a gradient, e.g. under "
                "torch.no_grad()")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Prefill attention ``(B, S, H, hd)``."""
    window = int(window)
    _check(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    return _launch(q, k, v, causal, window)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """Full-softmax attention (the reference's ``flash_attention_ref``),
    in chunks of query rows whose scores hold at most ``PLAIN_SCORES``
    elements, so that a full-width layer fits on the card."""
    B, S, H, _ = q.shape
    rows = max(1, PLAIN_SCORES // (B * H * k.shape[1]))
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    for s0 in range(0, S, rows):
        out[:, s0:s0 + rows] = attention_ref(
            q[:, s0:s0 + rows], k, v, causal=causal, window=window,
            q_start=s0)
    return out


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"{what} failed: error {err} ({msg})")


def _check_rows(*ts) -> None:
    """The kernel copies rows as 16-byte vectors: unit stride along hd and
    every row 16-byte aligned."""
    for t in ts:
        if (t.stride(-1) != 1 or t.data_ptr() % 16
                or any(s % 4 for s in t.stride()[:-1])):
            raise ValueError(
                f"the kernel needs 16-byte aligned rows with unit stride "
                f"along hd, got shape {tuple(t.shape)}, strides {t.stride()}")


def _launch(q, k, v, causal: bool, window: int) -> torch.Tensor:
    """Launch the kernel on the tensors' card, on PyTorch's current stream."""
    from repro_torch.kernels import _build

    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    _check_rows(q, k, v)
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    lib = _build.library("flash_attention")
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, Skv, H, KV, hd, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], int(causal), window, hd ** -0.5,
            torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(lib, err, "flash_attention kernel launch")
        LAUNCHES["flash_attention"] += 1
    return out
