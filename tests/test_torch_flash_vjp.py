"""The port's differentiable attention against the JAX package's custom
VJP, on the CPU.

On the CPU the wrappers run their plain versions:
``flash_attention_lse_plain`` (out and each row's log-sum-exp) is held
against the reference's ``_flash_fwd`` (its ``out`` and the ``lse``
residual, reordered to ``(B, H, S)``), and ``flash_attention_bwd_plain``
and the autograd form ``flash_attention_vjp`` against ``jax.vjp`` of the
reference's ``flash_attention_vjp``, over group sizes, head dims, the
causal / sliding-window / cross masks and lengths that are multiples of
neither the reference's blocks nor the kernels' tiles.  Tolerance 2e-5
absolute and relative: the same float32 formulas, whose sums (over hd,
and over up to 150 keys or query rows) run in another order; the
reference's 64-row blocks split the softmax's max and sum (``out``'s
``acc / l``) where the plain version takes whole rows.  The CUDA kernels
are held against the same plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import flash_vjp as JV
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as L
from repro_torch.models.flash_vjp import (flash_attention_tri,
                                          flash_attention_vjp)

TOL = dict(rtol=2e-5, atol=2e-5)
BLOCK = 64                     # the reference's q_block / kv_block here

# (S, Skv, causal, window)
MODES = {"causal": (150, 150, True, 0), "window": (150, 150, True, 40),
         "cross": (70, 45, False, 0), "ragged": (133, 133, True, 0),
         "tile_edge": (65, 65, True, 0), "cross_edge": (64, 129, False, 0)}
CASES = ([(1, 16, m) for m in MODES]
         + [(4, 16, "causal"), (5, 16, "window"), (2, 16, "cross"),
            (1, 64, "window"), (4, 36, "ragged"), (8, 128, "cross_edge"),
            (16, 8, "tile_edge")])


def _inputs(seed, S, Skv, KV, G, hd, B=2):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, S, KV * G, hd), (B, Skv, KV, hd),
                             (B, Skv, KV, hd), (B, S, KV * G, hd)))
    return q, k, v, do


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _np(x):
    return x.detach().cpu().numpy()


def _jax_lse(lse_b, B, S, H):
    """The reference's lse residual (nq, B, KV, G, qb) as (B, H, S)."""
    nq, _, KV, G, qb = lse_b.shape
    return np.asarray(lse_b).transpose(1, 2, 3, 0, 4).reshape(
        B, KV * G, nq * qb)[:, :, :S]


@pytest.mark.parametrize("G,hd,mode", CASES)
def test_forward_out_and_lse_match_the_reference(G, hd, mode):
    S, Skv, causal, window = MODES[mode]
    q, k, v, _ = _inputs(G * 100 + hd, S, Skv, 2, G, hd)
    out, (_, _, _, _, lse_b) = JV._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, window,
        BLOCK, BLOCK)
    got, lse = fa.flash_attention_lse(_t(q), _t(k), _t(v), causal=causal,
                                      window=window)
    np.testing.assert_allclose(_np(got), np.asarray(out), **TOL)
    np.testing.assert_allclose(_np(lse), _jax_lse(lse_b, 2, S, 2 * G), **TOL)
    # the training forward's out is the inference path's
    np.testing.assert_array_equal(
        _np(got), _np(fa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                         window=window)))


@pytest.mark.parametrize("G,hd,mode", CASES)
def test_backward_matches_jax_vjp(G, hd, mode):
    S, Skv, causal, window = MODES[mode]
    q, k, v, do = _inputs(G * 1000 + hd, S, Skv, 2, G, hd)
    out, vjp = jax.vjp(lambda a, b, c: JV.flash_attention_vjp(
        a, b, c, causal, window, BLOCK, BLOCK),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    # the plain backward on the plain forward's residuals
    o, lse = fa.flash_attention_lse(_t(q), _t(k), _t(v), causal=causal,
                                    window=window)
    plain = fa.flash_attention_bwd(_t(q), _t(k), _t(v), o, lse, _t(do),
                                   causal=causal, window=window)
    # and autograd through the layer's call
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    got = L.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.grad_fn is not None
    np.testing.assert_allclose(_np(got), np.asarray(out), **TOL)
    got.backward(_t(do))
    for name, a, b, w in zip("qkv", plain, (qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(_np(a), np.asarray(w), **TOL,
                                   err_msg=f"plain d{name}")
        np.testing.assert_array_equal(_np(b), _np(a),
                                      err_msg=f"autograd d{name}")


def test_tri_is_the_same_function_and_autograd_agrees():
    """``flash_attention_tri`` is ``flash_attention_vjp``, and the plain
    backward's formulas agree with autograd through the plain forward's
    (softmax, einsum) ops, another derivation of the same gradient."""
    assert flash_attention_tri is flash_attention_vjp
    q, k, v, do = _inputs(7, 37, 37, 2, 4, 12)
    args = [_t(a, True) for a in (q, k, v)]
    o, lse = fa.flash_attention_lse_plain(*args, causal=True, window=9)
    want = torch.autograd.grad(o, args, _t(do))
    got = fa.flash_attention_bwd_plain(*(a.detach() for a in args),
                                       o.detach(), lse.detach(), _t(do),
                                       causal=True, window=9)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


def test_no_gradient_keeps_the_inference_path():
    q, k, v, _ = _inputs(3, 12, 12, 1, 1, 8)
    qt = _t(q, True)
    with torch.no_grad():
        out = L.flash_attention(qt, _t(k), _t(v))
    assert out.grad_fn is None and not out.requires_grad
    np.testing.assert_array_equal(
        _np(out), _np(fa.flash_attention_plain(_t(q), _t(k), _t(v))))


def test_refused_shapes_raise_on_the_autograd_route():
    q, k, v, _ = _inputs(4, 8, 8, 1, 3, 16)               # G = 3
    with pytest.raises(ValueError, match="group size"):
        L.flash_attention(_t(q, True), _t(k), _t(v))
    q, k, v, _ = _inputs(4, 8, 8, 1, 1, 18)               # hd 18
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_vjp(_t(q, True), _t(k, True), _t(v, True))
    q, k, v, do = _inputs(4, 8, 8, 1, 1, 16)
    o, lse = fa.flash_attention_lse(_t(q), _t(k), _t(v))
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(_t(q), _t(k), _t(v), o, lse[:, :, :4], _t(do))
    with pytest.raises(ValueError, match="float32"):
        fa.flash_attention_lse(_t(q).double(), _t(k).double(),
                               _t(v).double())


@pytest.mark.parametrize("mode", ["causal", "window", "cross"])
def test_the_plain_forward_computes_float64_inputs_in_float64(mode):
    """``flash_attention_lse_plain`` on float64 inputs keeps float64 (the
    reference ``chip_smoke.py`` holds a trained layer's forward to): its
    out and lse are the float32 version's within float32's rounding, and
    a float64 softmax's to float64's."""
    S, Skv, causal, window = MODES[mode]
    q, k, v, _ = _inputs(11, S, Skv, 2, 4, 32)
    q64, k64, v64 = (torch.from_numpy(x).double() for x in (q, k, v))
    out, lse = fa.flash_attention_lse_plain(q64, k64, v64, causal=causal,
                                            window=window)
    assert out.dtype == lse.dtype == torch.float64
    out32, lse32 = fa.flash_attention_lse_plain(
        q64.float(), k64.float(), v64.float(), causal=causal, window=window)
    torch.testing.assert_close(out32.double(), out, **TOL)
    torch.testing.assert_close(lse32.double(), lse, **TOL)
    qg = q64.reshape(2, S, 2, 4, 32)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg, k64) * 32 ** -0.5
    if causal:
        i, j = torch.arange(S)[:, None], torch.arange(Skv)[None, :]
        keep = (i >= j) & ((window <= 0) | (i - j < window))
        s = s.masked_fill(~keep, float("-inf"))
    want = torch.einsum("bkgqc,bckd->bqkgd", torch.softmax(s, -1), v64)
    torch.testing.assert_close(out, want.reshape(2, S, 8, 32),
                               rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(
        lse, torch.logsumexp(s, -1).reshape(2, 8, S), rtol=1e-12, atol=1e-12)


def _bwd_plain_float32_before(q, k, v, out, lse, dout, causal, window):
    """``flash_attention_bwd_plain`` as it read before it took float64:
    every operand cast to float32."""
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    kf, vf = k.float(), v.float()
    dq = torch.empty((B, S, H, hd), dtype=torch.float32)
    dk = torch.zeros((B, Skv, KV, hd), dtype=torch.float32)
    dv = torch.zeros_like(dk)
    rows = max(1, fa.PLAIN_SCORES // (B * H * Skv))
    for s0 in range(0, S, rows):
        sl = slice(s0, s0 + rows)
        n = q[:, sl].shape[1]
        qg = q[:, sl].reshape(B, n, KV, G, hd).float()
        dog = dout[:, sl].reshape(B, n, KV, G, hd).float()
        og = out[:, sl].reshape(B, n, KV, G, hd).float()
        delta = (dog * og).sum(-1).permute(0, 2, 3, 1)
        s = fa._plain_scores(q[:, sl], k, causal, window, s0)
        p = torch.exp(s - lse[:, :, sl].reshape(B, KV, G, n)[..., None])
        dv += torch.einsum("bkgqc,bqkgd->bckd", p, dog)
        dp = torch.einsum("bqkgd,bckd->bkgqc", dog, vf)
        ds = p * (dp - delta[..., None]) * scale
        dk += torch.einsum("bkgqc,bqkgd->bckd", ds, qg)
        dq[:, sl] = torch.einsum("bkgqc,bckd->bqkgd", ds, kf) \
            .reshape(B, n, H, hd)
    return dq, dk, dv


@pytest.mark.parametrize("mode", ["causal", "window", "cross"])
def test_the_plain_backward_computes_float64_inputs_in_float64(mode):
    """``flash_attention_bwd_plain`` on float64 inputs keeps float64 (the
    reference the kernels are held to at a trained layer and over long
    sums): it equals autograd through a float64 softmax attention to
    float64's rounding, and float32 inputs still give float32, bit for bit
    what it gave before it took float64."""
    S, Skv, causal, window = MODES[mode]
    q, k, v, do = _inputs(13, S, Skv, 2, 4, 32)
    args = [torch.from_numpy(x).double().requires_grad_() for x in (q, k, v)]
    out, lse = fa.flash_attention_lse_plain(*args, causal=causal,
                                            window=window)
    dout = torch.from_numpy(do).double()
    got = fa.flash_attention_bwd_plain(
        *(a.detach() for a in args), out.detach(), lse.detach(), dout,
        causal=causal, window=window)
    assert all(g.dtype == torch.float64 for g in got)
    qg = args[0].reshape(2, S, 2, 4, 32)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg, args[1]) * 32 ** -0.5
    if causal:
        i, j = torch.arange(S)[:, None], torch.arange(Skv)[None, :]
        keep = (i >= j) & ((window <= 0) | (i - j < window))
        s = s.masked_fill(~keep, float("-inf"))
    o = torch.einsum("bkgqc,bckd->bqkgd", torch.softmax(s, -1), args[2])
    want = torch.autograd.grad(o.reshape(2, S, 8, 32), args, dout)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    q32, k32, v32, do32 = map(torch.from_numpy, (q, k, v, do))
    o32, lse32 = fa.flash_attention_lse_plain(q32, k32, v32, causal=causal,
                                              window=window)
    now = fa.flash_attention_bwd_plain(q32, k32, v32, o32, lse32, do32,
                                       causal=causal, window=window)
    before = _bwd_plain_float32_before(q32, k32, v32, o32, lse32, do32,
                                       causal, window)
    for a, b in zip(now, before):
        assert a.dtype == torch.float32 and torch.equal(a, b)
