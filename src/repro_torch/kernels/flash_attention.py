"""Prefill attention over a whole sequence and its backward, as CUDA
kernels for Hopper beside their plain PyTorch versions.

``flash_attention(q, k, v, causal=True, window=0)`` has the semantics of
the JAX package's Pallas ``flash_attention_tpu``: q ``(B, S, H, hd)``,
k / v ``(B, Skv, KV, hd)`` with ``H = KV * G`` (query head ``h`` reads KV
head ``h // G``); keys at ``k >= Skv`` are masked, and when ``causal`` also
keys after the query and, for ``window > 0``, keys ``window`` or more
positions before it.  It returns ``(B, S, H, hd)``.  When autograd
records and an input requires a gradient it goes through
:class:`FlashAttention` (the forward below with its ``lse``, then the
backward kernels); otherwise it launches the inference kernel.

For CUDA tensors the wrappers launch ``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu``; for CPU tensors they run the plain
versions (:func:`flash_attention_plain`, the reference's oracle
``flash_attention_ref``; :func:`flash_attention_lse_plain`;
:func:`flash_attention_bwd_plain`, the formulas of the reference's
``flash_vjp._flash_bwd``).  Nothing falls back from one to the other.  The
forward kernel reads q, k and v in place through their strides, so views
cost no copy.  It takes both products on the tensor cores in split TF32:
each float32 operand ``x`` enters as ``big = tf32(x)`` and ``small =
tf32(x - big)``, and ``a . b`` is ``small_a . big_b + big_a . small_b +
big_a . big_b``, so the result keeps float32's accuracy (plain TF32 would
not: ``tests/test_torch_attention_tf32.py``).  The backward's dk / dv and
dq kernels take all their products the same way
(``tests/test_torch_attention_bwd_tf32.py``).  cuBLAS's float32 products
elsewhere keep TF32 off.  Every path
takes float32 only, head dims that are multiples of 4 up to 128 and the
group sizes in ``GROUP_SIZES``, and raises ``ValueError`` on anything
else.

``flash_attention_lse`` (the forward of training) returns ``(out, lse)``
with ``lse`` ``(B, H, S)`` float32, the log-sum-exp of each row's scaled,
masked scores: on the card the kernel's ``LSE`` instance, whose ``out`` is
the inference instance's bit for bit.  ``flash_attention_bwd(q, k, v,
out, lse, dout, causal, window)`` returns ``(dq, dk, dv)``: on the card
three kernels, ``delta = rowsum(dout * out)``, then ``dk`` / ``dv`` (a
block a key tile, summed over the G heads of a KV head) and ``dq`` (a
block a query tile).

``LAUNCHES`` counts kernel launches only, so a run can show that it went
through the kernels.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import (NEG_INF, _block_mask,
                                      attention_ref)

LAUNCHES = {"flash_attention": 0, "flash_attention_lse": 0,
            "flash_attention_bwd_delta": 0, "flash_attention_bwd_dkdv": 0,
            "flash_attention_bwd_dq": 0}
GROUP_SIZES = (1, 2, 4, 5, 8, 16)  # G = H / KV held against the plain version
MAX_HEAD_DIM = 128
PLAIN_SCORES = 1 << 28             # score elements per chunk of query rows


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Prefill attention ``(B, S, H, hd)``, differentiable when autograd
    records and an input requires a gradient."""
    window = int(window)
    _check(q, k, v, causal, window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, bool(causal), window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    return _launch(q, k, v, causal, window)[0]


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0):
    """The training forward: ``(out (B, S, H, hd), lse (B, H, S))``, with
    no autograd of its own (:class:`FlashAttention` wraps it)."""
    window = int(window)
    _check(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_lse_plain(q, k, v, causal=causal,
                                         window=window)
    return _launch(q, k, v, causal, window, lse=True)


class FlashAttention(torch.autograd.Function):
    """``out = attention(q, k, v)`` with the flash backward: the forward
    runs :func:`flash_attention_lse` and saves only ``(q, k, v, out,
    lse)``, as the reference's custom VJP does, so no ``(S, Skv)`` score
    matrix is kept; the backward runs :func:`flash_attention_bwd`, which
    recomputes the score tiles."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.float(),
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


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


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int = 0):
    """:func:`flash_attention_plain`'s ``out`` and each row's ``lse``
    ``(B, H, S)``: the log-sum-exp of its scaled scores with masked keys at
    ``NEG_INF`` (the reference's ``m + log(max(l, 1e-37))``, which equals
    it: every row sees at least one key).  Float64 inputs are computed in
    float64: the reference a trained layer's scores (float32's own
    rounding there is a large share of the tolerance) are held to."""
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    rows = max(1, PLAIN_SCORES // (B * H * Skv))
    out = flash_attention_plain(q, k, v, causal=causal, window=window)
    lse = torch.empty((B, H, S), device=q.device,
                      dtype=torch.promote_types(q.dtype, torch.float32))
    for s0 in range(0, S, rows):
        s = _plain_scores(q[:, s0:s0 + rows], k, causal, window, s0)
        lse[:, :, s0:s0 + rows] = torch.logsumexp(s, dim=-1) \
            .reshape(B, H, -1)
    return out, lse


def _plain_scores(q, k, causal: bool, window: int, q_start: int):
    """Scaled, masked scores ``(B, KV, G, S, Skv)`` of the query rows at
    positions ``q_start ..``, masked keys at ``NEG_INF``."""
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    ct = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg.to(ct), k.to(ct)) * hd ** -0.5
    return torch.where(_plain_mask(S, Skv, causal, window, q_start, q.device),
                       s, NEG_INF)


def _plain_mask(S: int, Skv: int, causal: bool, window: int, q_start: int,
                device) -> torch.Tensor:
    """``(S, Skv)`` live pairs of the rows at ``q_start ..`` (the
    reference's ``flash_vjp._masks``)."""
    k_pos = torch.arange(Skv, device=device)
    m = torch.ones((S, Skv), dtype=torch.bool, device=device)
    if causal:
        q_pos = torch.arange(q_start, q_start + S, device=device)
        m = _block_mask(q_pos, k_pos, window)
    return m


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention` with respect
    to q, k and v, given its ``out``, ``lse`` (from
    :func:`flash_attention_lse`) and the gradient ``dout`` of ``out``."""
    window = int(window)
    _check(q, k, v, causal, window)
    B, S, H, hd = q.shape
    for name, t, shape in (("out", out, q.shape), ("dout", dout, q.shape),
                           ("lse", lse, (B, H, S))):
        if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"{name}: need float32 {tuple(shape)} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal, window=window)
    return _launch_bwd(q, k, v, out, lse, dout, causal, window)


def flash_attention_bwd_delta(out: torch.Tensor, dout: torch.Tensor
                              ) -> torch.Tensor:
    """The backward's first pass, ``delta = rowsum(dout * out)`` ``(B, H,
    S)`` float32 of out and dout ``(B, S, H, hd)``."""
    if out.shape != dout.shape or out.dim() != 4 or \
            out.device != dout.device:
        raise ValueError(f"need out and dout (B, S, H, hd) of one shape on "
                         f"one device, got {tuple(out.shape)} on "
                         f"{out.device}, {tuple(dout.shape)} on {dout.device}")
    if out.device.type == "cpu":
        return flash_attention_bwd_delta_plain(out, dout)
    return _launch_delta(out.contiguous(), dout.contiguous())


def flash_attention_bwd_delta_plain(out, dout) -> torch.Tensor:
    return (dout.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal: bool = True,
                              window: int = 0):
    """The reference's ``_flash_bwd`` formulas over full rows of keys, in
    chunks of query rows whose scores hold at most ``PLAIN_SCORES``
    elements: ``P = exp(S * scale - lse)``, ``delta = rowsum(dout *
    out)``, ``dV = P^T dout``, ``dS = P * (dout V^T - delta) * scale``,
    ``dK = dS^T Q``, ``dQ = dS K`` (dK and dV summed over each KV head's G
    query heads).  Float64 inputs are computed in float64, as
    :func:`flash_attention_lse_plain` does: the reference the kernels are
    held to where float32's own rounding is a large share of the
    tolerance.  Float32 inputs compute in float32."""
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    ct = torch.promote_types(q.dtype, torch.float32)
    kf, vf = k.to(ct), v.to(ct)
    dq = torch.empty((B, S, H, hd), dtype=ct, device=q.device)
    dk = torch.zeros((B, Skv, KV, hd), dtype=ct, device=q.device)
    dv = torch.zeros_like(dk)
    rows = max(1, PLAIN_SCORES // (B * H * Skv))
    for s0 in range(0, S, rows):
        sl = slice(s0, s0 + rows)
        n = q[:, sl].shape[1]
        qg = q[:, sl].reshape(B, n, KV, G, hd).to(ct)
        dog = dout[:, sl].reshape(B, n, KV, G, hd).to(ct)
        og = out[:, sl].reshape(B, n, KV, G, hd).to(ct)
        delta = (dog * og).sum(-1).permute(0, 2, 3, 1)        # (B,KV,G,n)
        s = _plain_scores(q[:, sl], k, causal, window, s0)
        p = torch.exp(s - lse[:, :, sl].reshape(B, KV, G, n)[..., None]
                      .to(ct))
        dv += torch.einsum("bkgqc,bqkgd->bckd", p, dog)
        dp = torch.einsum("bqkgd,bckd->bkgqc", dog, vf)
        ds = p * (dp - delta[..., None]) * scale
        dk += torch.einsum("bkgqc,bqkgd->bckd", ds, qg)
        dq[:, sl] = torch.einsum("bkgqc,bckd->bqkgd", ds, kf) \
            .reshape(B, n, H, hd)
    return dq, dk, dv


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


def _launch(q, k, v, causal: bool, window: int, lse: bool = False):
    """Launch the forward kernel (its ``LSE`` instance when ``lse``) on the
    tensors' card, on PyTorch's current stream: ``(out, lse or None)``."""
    from repro_torch.kernels import _build

    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    _check_rows(q, k, v)
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    lib = _build.library("flash_attention")
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=dev)
    lse_t = (torch.empty((B, H, S), dtype=torch.float32, device=dev)
             if lse else None)
    with torch.cuda.device(dev):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse_t.data_ptr() if lse else None,
            B, S, Skv, H, KV, hd, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], int(causal), window, hd ** -0.5,
            torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(lib, err, "flash_attention kernel launch")
        LAUNCHES["flash_attention_lse" if lse else "flash_attention"] += 1
    return out, lse_t


def _launch_bwd(q, k, v, out, lse, dout, causal: bool, window: int):
    """Launch the three backward kernels on the tensors' card, on
    PyTorch's current stream, over contiguous copies of the inputs (a
    no-op for the model's own, contiguous, tensors)."""
    from repro_torch.kernels import _build

    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    q, k, v, out, lse, dout = (t.contiguous()
                               for t in (q, k, v, out, lse, dout))
    _check_rows(q, k, v, out, dout)
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    delta = _launch_delta(out, dout)
    lib = _build.library("flash_attention_bwd")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    shape = (B, S, Skv, H, KV, hd, int(causal), window, hd ** -0.5)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for name, call in (
                ("dkdv", lambda: lib.flash_attention_bwd_dkdv_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), *shape, stream)),
                ("dq", lambda: lib.flash_attention_bwd_dq_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), *shape, stream))):
            _raise_on_bwd(lib, call(), name)
    return dq, dk, dv


def _launch_delta(out, dout) -> torch.Tensor:
    """Launch the backward's delta kernel over contiguous out and dout."""
    from repro_torch.kernels import _build

    dev = out.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if out.dtype != torch.float32 or dout.dtype != torch.float32:
        raise ValueError(f"delta runs in float32, got {out.dtype}, "
                         f"{dout.dtype}")
    B, S, H, hd = out.shape
    lib = _build.library("flash_attention_bwd")
    delta = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _raise_on_bwd(lib, lib.flash_attention_bwd_delta_launch(
            dout.data_ptr(), out.data_ptr(), delta.data_ptr(), B, S, H, hd,
            torch.cuda.current_stream(dev).cuda_stream), "delta")
    return delta


def _raise_on_bwd(lib, err: int, name: str) -> None:
    """Raise on a failed launch of backward kernel ``name``, else count
    it."""
    if err != 0:
        msg = lib.flash_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"flash_attention_bwd_{name} kernel launch "
                           f"failed: error {err} ({msg})")
    LAUNCHES[f"flash_attention_bwd_{name}"] += 1
