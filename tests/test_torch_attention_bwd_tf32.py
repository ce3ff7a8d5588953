"""The split-TF32 arithmetic of ``csrc/flash_attention_bwd.cu`` (the
training backward's ``dkdv`` and ``dq`` kernels), on the CPU.

The kernels cannot run here, so this file models what they compute, step
by step, in float32, as ``tests/test_torch_attention_tf32.py`` does for the
forward (whose ``tf32``, ``split`` and fragment maps it imports):

- every product in split TF32, ``small.big + big.small + big.big`` a
  k-step of 8 at a time; S and dP (sums over hd) kept as hi + lo, each
  k-step's small terms onto lo, big.big onto hi and then again onto what
  that add changed, which gives back what its rounding lost, onto lo
  (``step_hi_lo``); dV, dK and dQ (sums over rows or keys) a k-step at a time,
  each step's products summed onto the rounding error the previous step's
  add left and then added to the running sum, the last error added at the
  end of the tile (``mma3_comp``, Fast2Sum);
- the fragment maps: a warp's A fragment read by ``ldmatrix`` from a raw
  tile, and the accumulators of S^T / dP^T (dkdv) and dS (dq) fed as A
  operands of dV += P^T.dO, dK += dS^T.Q and dQ += dS.K through the row
  permutation of the transposed tiles (``permuted`` in ``tf32_mma.cuh``);
- the tiling and sum order: dkdv blocks of 128 keys (64 past hd 64), a
  warp a 16 keys, walking their causal / window band of (position, head)
  rows R = i * G + g in tiles of 32 rows (16); dq blocks of 128 rows (64),
  a warp a 16 rows, walking key tiles of 32 (16); tiles masked for all
  of a warp's keys or rows skipped, the mask applied on edge tiles only.

``mma.sync`` does not round to nearest: it aligns its 8 products and its
accumulator to the largest exponent, cuts each to 2^-25 of it and
truncates the sum (``mma_hw``, as ``tools/mma_rounding.cu`` measures it on
the card).  The model sums to nearest by default, and on ``mma_hw`` where
a test says so: there the kernels' S stays within an ulp of float64,
where S summed in place strays by many.

The model is held at atol = rtol = 2e-5, the kernels' tolerance on the
card, against ``flash_attention_bwd_plain`` evaluated in float64 (float64
inputs compute in float64), against its float32 evaluation and against
``jax.vjp`` of the reference's ``flash_attention_vjp`` (in process, as
``tests/test_torch_flash_vjp.py``), over every mask, head dim and group
size, and with scores four times as large (q x 4), where float32
arithmetic itself can stray past 2e-5 of float64 (the float32 plain
backward does on dk at G 16).  With one term (plain TF32) the model
misses the tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import flash_vjp as JV
from repro_torch.kernels import flash_attention as fa
from test_torch_attention_tf32 import (a_map, c_map, ldmatrix_x4, mma_warp,
                                       split, tf32, v_read, vt_column)

TOL = dict(atol=2e-5, rtol=2e-5)
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
SMEM_LIMIT = 232448              # bytes of shared memory a block may use

# (S, Skv, causal, window), as in tests/test_torch_cuda.py: "edge" ends one
# key and, at G 1, one row past a tile; "cross_edge" one key past a tile
MODES = {"causal": (256, 256, True, 0), "window": (320, 320, True, 100),
         "cross": (160, 200, False, 0), "ragged": (333, 333, True, 0),
         "edge": (129, 129, True, 0), "cross_edge": (65, 129, False, 0)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models issue many small tensor ops; across several test
    processes on one machine, torch's intra-op thread pool then spends
    far more time waiting on its threads than computing (a test that
    takes 2 s alone took minutes), so this module runs them on one
    thread and gives the process its setting back afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------- tiling
def tiling(hd: int) -> dict:
    """``Tiling<NK>`` of the kernel instance that takes head dim ``hd``:
    compute warps, owned keys (dkdv) / rows (dq) a block, streamed rows /
    keys a tile, strides and shared memory in floats."""
    nk = -(-hd // 8)
    NK = 8 if nk <= 8 else nk if nk in (15, 16) else 16
    W = 8 if NK <= 8 else 4
    T = 32 if NK <= 8 else 16
    NP = (NK + 1) // 2
    ST, TS = 8 * NK + 4, T + 4
    RT, TT = T * ST, 16 * NP * TS
    own = 16 * W
    return dict(NK=NK, W=W, OWN=own, T=T, ST=ST, TS=TS,
                dkdv_floats=2 * own * ST + 2 * (4 * RT + 4 * TT + 2 * T),
                dq_floats=2 * own * ST + 2 * (4 * RT + 2 * TT))


def permuted(r: int) -> int:
    """``tf32_mma.cuh``'s ``permuted``: the column of a transposed tile
    that holds row r (8j + 2t -> 8j + t, 8j + 2t + 1 -> 8j + t + 4)."""
    return (r & ~7) | ((r & 1) << 2) | ((r >> 1) & 3)


def test_every_instance_fits_a_blocks_shared_memory():
    for hd in range(4, 129, 4):
        t = tiling(hd)
        assert 4 * t["dkdv_floats"] <= SMEM_LIMIT, hd
        assert 4 * t["dq_floats"] <= SMEM_LIMIT, hd
        assert t["OWN"] % t["T"] == 0 and t["T"] % 16 == 0
    # the three exact instances: 213,504 / 209,152 / 217,344 B (dkdv)
    assert [4 * tiling(hd)["dkdv_floats"] for hd in (64, 120, 128)] == \
        [213504, 209152, 217344]


def test_transposed_tiles_use_the_forwards_permutation_and_every_bank():
    """The producers store row r of a streamed tile at column permuted(r)
    of its transposed copies (the forward's V^T order); a warp's 32 items
    (rows i % T of float4 column chunks i / T) store to 32 distinct banks,
    and ldmatrix reads of strides T + 4 and 8 NK + 4 do too."""
    assert [permuted(r) for r in range(64)] == [vt_column(r)
                                                for r in range(64)]
    for T in (32, 16):
        TS = T + 4
        for c0 in range(0, 64, 4):
            for e in range(4):
                banks = {((4 * (c0 + i // T) + e) * TS + permuted(i % T)) % 32
                         for i in range(32)}
                assert len(banks) == 32, (T, c0, e)
        for st in (TS, 8 * 8 + 4, 8 * 15 + 4, 8 * 16 + 4):
            for col in (0, 4, 8, 12):
                assert len({(row * st + col + b) % 32 for row in range(8)
                            for b in range(4)}) == 32


# ------------------------------------------------------- fragment maps
def a_ldmatrix(lane, i):
    """Register i of the A fragment ``a_split`` reads with ldmatrix4 from a
    warp's 16 rows: lane l addresses row 8 ((l / 8) % 2) + l % 8, column
    4 (l / 16) -> (row, column) within the 16 x 8 block."""
    addr_lane = 8 * i + lane // 4
    row = 8 * ((addr_lane >> 3) & 1) + (addr_lane & 7)
    return row, 4 * (addr_lane >> 4) + lane % 4


def b_row_major(lane, i, jp, kk):
    """B register i (of a pair of n-tiles, 2 (j % 2) + i) of a row-major
    streamed tile at n-tile pair jp, k-step kk: ldmatrix4 at row 16 jp,
    column 8 kk -> (row of the tile, column)."""
    row, col = ldmatrix_x4(lane, i)
    return 16 * jp + row, 8 * kk + col


def test_a_fragments_read_by_ldmatrix_are_the_a_map():
    for lane in range(32):
        for i in range(4):
            assert a_ldmatrix(lane, i) == a_map(lane, i)


def _regs(m, fmap, regs):
    return np.array([[m[fmap(lane, i)] for i in range(regs)]
                     for lane in range(32)])


def _tile(acc):
    out = np.zeros((16, 8))
    for lane in range(32):
        for i in range(4):
            out[c_map(lane, i)] = acc[lane, i]
    return out


@pytest.mark.parametrize("T", [32, 16])
def test_dkdv_products_feed_p_t_and_ds_t_from_registers(T):
    """One dkdv warp at one step: S^T = K . Q^T with K's A fragments from
    ldmatrix and Q's B fragments from the row-major tile, then dV += P^T .
    dO and dK += dS^T . Q with the S^T accumulator as the A operand
    (d0, d2, d1, d3) and dO^T / Q^T read from their permuted transposed
    copies (the forward's V^T reads): equal to the products."""
    rng = np.random.default_rng(T)
    hd = 16
    k = rng.standard_normal((16, hd))            # the warp's keys
    q = rng.standard_normal((T, hd))             # the tile's rows
    do = rng.standard_normal((T, hd))
    st = np.zeros((T // 8, 32, 4))
    for j in range(T // 8):                      # n-tiles of rows
        for kk in range(hd // 8):
            a = np.array([[k[a_ldmatrix(lane, i)[0],
                             8 * kk + a_ldmatrix(lane, i)[1]]
                           for i in range(4)] for lane in range(32)])
            b = np.array([[q[b_row_major(lane, 2 * (j % 2) + i, j // 2, kk)]
                           for i in range(2)] for lane in range(32)])
            st[j] = mma_warp(a, b, st[j])
        np.testing.assert_allclose(_tile(st[j]), k @ q[8 * j:8 * j + 8].T,
                                   atol=1e-12)
    p_t = np.concatenate([_tile(st[j]) for j in range(T // 8)], axis=1)
    for n in range(hd // 8):                     # n-tiles of columns
        acc = np.zeros((32, 4))
        for j in range(T // 8):                  # k-steps of rows
            a = st[j][:, [0, 2, 1, 3]]
            b = np.array([[do[v_read(lane, i, j, n)] for i in range(2)]
                          for lane in range(32)])
            acc = mma_warp(a, b, acc)
        np.testing.assert_allclose(_tile(acc), p_t @ do[:, 8 * n:8 * n + 8],
                                   atol=1e-12)


def test_dq_product_feeds_ds_from_registers():
    """One dq warp: dS (16 rows x 32 keys) in S's accumulator layout as the
    A operand of dQ += dS . K, K^T read from its permuted transposed
    copy."""
    rng = np.random.default_rng(5)
    ds = rng.standard_normal((16, 32))
    k = rng.standard_normal((32, 24))
    for n in range(3):
        acc = np.zeros((32, 4))
        for j in range(4):
            s_regs = _regs(ds[:, 8 * j:8 * j + 8], c_map, 4)
            b = np.array([[k[v_read(lane, i, j, n)] for i in range(2)]
                          for lane in range(32)])
            acc = mma_warp(s_regs[:, [0, 2, 1, 3]], b, acc)
        np.testing.assert_allclose(_tile(acc), ds @ k[:, 8 * n:8 * n + 8],
                                   atol=1e-12)


# ------------------------------------------------------------ the kernels
def _terms(a, b, terms):
    """The split terms of ``a @ b`` for each k-step of 8, in the kernel's
    order (small.big, big.small, big.big; ``terms`` 1: big.big only, plain
    TF32; 4: small.small first as well): tensors ``(steps, ..., M, N)``."""
    ab, as_ = split(a)
    bb, bs = split(b)
    steps = a.shape[-1] // 8
    pairs = (([(as_, bs)] if terms == 4 else [])
             + ([(as_, bb), (ab, bs)] if terms >= 3 else []) + [(ab, bb)])
    return [x.unflatten(-1, (steps, 8)).movedim(-2, 0)
            @ y.unflatten(-2, (steps, 8)).movedim(-3, 0) for x, y in pairs]


def _nexp(x):
    """floor(log2 |x|) of float64 ``x``, far below any other where x = 0."""
    e = torch.frexp(x)[1].to(torch.int64) - 1
    return torch.where(x != 0, e, torch.full_like(e, -(1 << 20)))


def mma_hw(a, b, c):
    """``c + a @ b`` (a: (..., M, 8), b: (..., 8, N) TF32 values, c float32)
    as the card's TF32 ``mma.sync`` rounds it (``tools/mma_rounding.cu``
    measures it): the 8 products and c aligned to the largest nominal
    exponent E (of a product, the sum of its factors' exponents), each
    truncated to a multiple of 2^(E - 25), summed exactly, and the sum
    truncated to float32."""
    a, b, c = a.double(), b.double(), c.double()
    prod = a[..., :, :, None] * b[..., None, :, :]          # (..., M, 8, N)
    e = _nexp(a)[..., :, :, None] + _nexp(b)[..., None, :, :]
    e = torch.where(prod != 0, e, torch.full_like(e, -(1 << 20)))
    top = torch.maximum(e.amax(-2), _nexp(c))
    unit = torch.ldexp(torch.ones_like(c), (top - 25).clamp(min=-1000))
    total = (torch.trunc(prod / unit[..., None, :]).sum(-2)
             + torch.trunc(c / unit)) * unit
    out = total.float()
    over = out.double().abs() > total.abs()
    return torch.where(over, torch.nextafter(out, torch.zeros_like(out)), out)


def _hi_lo(a, b, terms, hw=False):
    """``a @ b`` (a: (..., M, hd8), b: (..., hd8, N)) as ``products`` sums
    S or dP: each k-step's small terms onto lo, big.big x onto hi (t),
    then x again onto hi - t, which gives back what t lost, onto lo
    (``step_hi_lo``).  ``hw``: every product on ``mma_hw`` (the card's
    rounding, in column chunks); else each k-step's terms summed to
    nearest, t = hi + x rounded to nearest and its error onto lo.
    ``terms`` 1: big.big only (plain TF32); 4: small.small first as well.
    Returns (hi, lo)."""
    if not hw:
        ts = _terms(a, b, terms)
        hi = torch.zeros_like(ts[0][0])
        lo = torch.zeros_like(hi)
        for k in range(ts[0].shape[0]):
            for t in ts[:-1]:
                lo = lo + t[k]
            x, t = ts[-1][k], hi + ts[-1][k]
            lo, hi = lo + (x - (t - hi)), t
        return hi, lo
    M, N = a.shape[-2], b.shape[-1]
    step = max(8, (1 << 18) // max(1, M * a[..., :1, :1].numel()) // 8 * 8)
    his, los = [], []
    for n0 in range(0, N, step):
        bc = b[..., n0:n0 + step]
        hi = torch.zeros(a.shape[:-1] + (bc.shape[-1],))
        lo = torch.zeros_like(hi)
        for k in range(a.shape[-1] // 8):
            ab, as_ = split(a[..., 8 * k:8 * k + 8].contiguous())
            bb, bs = split(bc[..., 8 * k:8 * k + 8, :].contiguous())
            if terms == 4:
                lo = mma_hw(as_, bs, lo)
            if terms >= 3:
                lo = mma_hw(ab, bs, mma_hw(as_, bb, lo))
            t = mma_hw(ab, bb, hi)
            lo = lo + mma_hw(ab, bb, hi - t)
            hi = t
        his.append(hi)
        los.append(lo)
    return torch.cat(his, -1), torch.cat(los, -1)


def _add_steps(acc, a, b, terms):
    """``acc + a @ b`` over a tile's k-steps of 8 as ``accumulate`` sums
    it (``mma3_comp``): each step's terms summed onto the error the
    previous add left, added to ``acc`` (Fast2Sum), the last error added
    at the end."""
    ts = _terms(a, b, terms)
    err = torch.zeros_like(acc)
    for k in range(ts[0].shape[0]):
        step = err
        for t in ts:
            step = step + t[k]
        total = acc + step
        err = step - (total - acc)
        acc = total
    return acc + err


def _rows(x, KV, G, n_pad):
    """(B, S, KV * G, hd) -> (B, KV, n_pad, hd8): the (position, head) rows
    R = i * G + g of each KV head, zero past S * G and past hd."""
    B, S, _, hd = x.shape
    out = torch.zeros(B, KV, n_pad, 8 * -(-hd // 8))
    out[:, :, :S * G, :hd] = (x.reshape(B, S, KV, G, hd)
                              .permute(0, 2, 1, 3, 4).reshape(B, KV, S * G, hd))
    return out


def _keys(x, n_pad):
    B, Skv, KV, hd = x.shape
    out = torch.zeros(B, KV, n_pad, 8 * -(-hd // 8))
    out[:, :, :Skv, :hd] = x.permute(0, 2, 1, 3)
    return out


def _live(pos, key, Skv, causal, window):
    pos, key = torch.broadcast_tensors(pos, key)
    ok = key < Skv
    if causal:
        ok = ok & (pos >= key)
        if window > 0:
            ok = ok & (pos - key < window)
    return ok


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _scores(s, dp, lse, delta, scale, live):
    """P = exp2((s_hi scale - lse + s_lo scale) log2e) (``logit``), zero
    where masked; dS = P ((dP_hi - delta) + dP_lo) scale."""
    p = torch.exp2(_fma(s[1], scale, _fma(s[0], scale, -lse)) * LOG2E)
    p = torch.where(live, p, torch.zeros(()))
    return p, p * ((dp[0] - delta) + dp[1]) * scale


def dkdv_model(q, k, v, lse, delta, do, *, causal, window, terms=3,
               hw=False, stats=None):
    """``dk``, ``dv`` as the dkdv kernel computes them: every key block's
    warps (16 keys each) at once along the key axis, the row tiles in the
    kernel's order."""
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    t_ = tiling(hd)
    T, OWN = t_["T"], t_["OWN"]
    rows = S * G
    n_tiles = -(-rows // T)
    k_pad = -(-Skv // OWN) * OWN
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    Q, dO = _rows(q, KV, G, n_tiles * T), _rows(do, KV, G, n_tiles * T)
    L = torch.zeros(B, KV, n_tiles * T)
    D = torch.zeros(B, KV, n_tiles * T)
    L[:, :, :rows] = lse.reshape(B, KV, G, S).transpose(2, 3) \
        .reshape(B, KV, rows)
    D[:, :, :rows] = delta.reshape(B, KV, G, S).transpose(2, 3) \
        .reshape(B, KV, rows)
    K, V = _keys(k, k_pad), _keys(v, k_pad)

    key = torch.arange(k_pad)
    kw0 = key // 16 * 16                          # each key's warp
    k0 = key // OWN * OWN                         # each key's block
    r_lo = torch.zeros_like(key)
    r_hi = torch.full_like(key, rows - 1)
    if causal:
        r_lo = k0 * G
        if window > 0:
            last = torch.clamp(torch.clamp(k0 + OWN, max=Skv) - 2 + window,
                               max=S - 1)
            r_hi = (last + 1) * G - 1
    t_lo, t_hi = r_lo // T, r_hi // T
    dk = torch.zeros(B, KV, k_pad, K.shape[-1])
    dv = torch.zeros_like(dk)
    # S^T and dP^T of every (key, row) pair: each element is summed the
    # same way whatever tile it falls in
    ST = _hi_lo(K, Q.transpose(-1, -2), terms, hw)
    dPT = _hi_lo(V, dO.transpose(-1, -2), terms, hw)
    for t in range(n_tiles):
        r0 = t * T
        pos_lo, pos_hi = r0 // G, (min(r0 + T, rows) - 1) // G
        live = (t >= t_lo) & (t <= t_hi) & (kw0 < Skv)
        if causal:
            live &= ~((pos_hi < kw0) |
                      ((window > 0) & (pos_lo - (kw0 + 15) >= window)))
        edge = kw0 + 15 >= Skv
        if causal:
            edge |= (kw0 + 15 > pos_lo) | ((window > 0) &
                                           (pos_hi - kw0 >= window))
        R = torch.arange(r0, r0 + T)
        keep = _live(R[None, :] // G, key[:, None], Skv, causal, window)
        # inner tiles need no mask: every (valid row, key) pair is live
        inner = live & ~edge & (key < Skv)
        assert bool(keep[inner][:, R < rows].all())
        # skipped warp-tiles hold no live pair
        assert not bool(keep[~live & (key < Skv)].any())
        mask = keep | ~edge[:, None]
        Qt, dOt = Q[:, :, r0:r0 + T], dO[:, :, r0:r0 + T]
        st = [x[..., r0:r0 + T] for x in ST]
        dpt = [x[..., r0:r0 + T] for x in dPT]
        p, ds = _scores(st, dpt, L[:, :, None, r0:r0 + T],
                        D[:, :, None, r0:r0 + T], scale, mask)
        dv_new = _add_steps(dv, p, dOt, terms)
        dk_new = _add_steps(dk, ds, Qt, terms)
        if stats is not None:
            first = (key % 16 == 0) & (kw0 < Skv)
            stats["skipped"] += B * KV * int((first & ~live).sum())
            stats["edge"] += B * KV * int((first & live & edge).sum())
            stats["inner"] += B * KV * int((first & live & ~edge).sum())
        dv = torch.where(live[:, None], dv_new, dv)
        dk = torch.where(live[:, None], dk_new, dk)
    return (dk[:, :, :Skv, :hd].permute(0, 2, 1, 3),
            dv[:, :, :Skv, :hd].permute(0, 2, 1, 3))


def dq_model(q, k, v, lse, delta, do, *, causal, window, terms=3,
             hw=False):
    """``dq`` as the dq kernel computes it: every row block's warps (16
    rows each) at once along the row axis, the key tiles in order."""
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    t_ = tiling(hd)
    T, OWN = t_["T"], t_["OWN"]
    rows = S * G
    r_pad = -(-rows // OWN) * OWN
    n_tiles = -(-Skv // T)
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    Q, dO = _rows(q, KV, G, r_pad), _rows(do, KV, G, r_pad)
    L = torch.zeros(B, KV, r_pad, 1)
    D = torch.zeros(B, KV, r_pad, 1)
    L[:, :, :rows, 0] = lse.reshape(B, KV, G, S).transpose(2, 3) \
        .reshape(B, KV, rows)
    D[:, :, :rows, 0] = delta.reshape(B, KV, G, S).transpose(2, 3) \
        .reshape(B, KV, rows)
    K, V = _keys(k, n_tiles * T), _keys(v, n_tiles * T)

    R = torch.arange(r_pad)
    pos = R // G
    w_lo = R // 16 * 16
    warp_live = w_lo < rows
    wp_lo = w_lo // G
    wp_hi = (torch.clamp(w_lo + 16, max=rows) - 1) // G
    b_lo = R // OWN * OWN
    p_lo = b_lo // G
    p_hi = (torch.clamp(b_lo + OWN, max=rows) - 1) // G
    t_lo = torch.zeros_like(R)
    t_hi = torch.full_like(R, (Skv - 1) // T)
    if causal:
        t_hi = torch.clamp(p_hi, max=Skv - 1) // T
        if window > 0:
            t_lo = torch.clamp(p_lo - window + 1, min=0) // T
    dq = torch.zeros(B, KV, r_pad, Q.shape[-1])
    SF = _hi_lo(Q, K.transpose(-1, -2), terms, hw)
    dPF = _hi_lo(dO, V.transpose(-1, -2), terms, hw)
    for t in range(n_tiles):
        k0, k1 = t * T, t * T + T - 1
        live = (t >= t_lo) & (t <= t_hi) & warp_live
        if causal:
            live &= ~((k0 > wp_hi) | ((window > 0) & (wp_lo - k1 >= window)))
        edge = torch.full_like(live, k1 >= Skv)
        if causal:
            edge |= (k1 > wp_lo) | ((window > 0) & (wp_hi - k0 >= window))
        key = torch.arange(k0, k1 + 1)
        keep = _live(pos[:, None], key[None, :], Skv, causal, window)
        assert bool(keep[live & ~edge & (R < rows)].all())
        assert not bool(keep[~live & (R < rows)].any())
        mask = keep | ~edge[:, None]
        Kt, Vt = K[:, :, k0:k1 + 1], V[:, :, k0:k1 + 1]
        s = [x[..., k0:k1 + 1] for x in SF]
        dp = [x[..., k0:k1 + 1] for x in dPF]
        _, ds = _scores(s, dp, L, D, scale, mask)
        dq = torch.where(live[:, None], _add_steps(dq, ds, Kt, terms), dq)
    out = dq[:, :, :rows, :hd]
    return (out.reshape(B, KV, S, G, hd).permute(0, 2, 1, 3, 4)
            .reshape(B, S, H, hd))


def kernel_model(q, k, v, out, lse, do, *, causal=True, window=0, terms=3,
                 hw=False):
    """``(dq, dk, dv)`` of the three kernels, delta from the plain rowsum
    (the delta kernel's float32 sum over hd)."""
    delta = fa.flash_attention_bwd_delta_plain(out, do)
    kw = dict(causal=causal, window=window, terms=terms, hw=hw)
    dk, dv = dkdv_model(q, k, v, lse, delta, do, **kw)
    return dq_model(q, k, v, lse, delta, do, **kw), dk, dv


def _inputs(seed, S, Skv, G, hd, q_scale=1.0, B=1, KV=2, v_shift=0.0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, S, KV * G, hd), (B, Skv, KV, hd),
                             (B, Skv, KV, hd), (B, S, KV * G, hd)))
    return (q * np.float32(q_scale), k, v + np.float32(v_shift), do)


def _forward(q, k, v, causal, window):
    return fa.flash_attention_lse_plain(q, k, v, causal=causal,
                                        window=window)


def _share(got, want):
    """The largest error as a share of the tolerance (1 = at its edge)."""
    want = want.double()
    return float(((got.double() - want).abs()
                  / (TOL["atol"] + TOL["rtol"] * want.abs())).max())


def _plain64(q, k, v, out, lse, do, causal, window):
    return fa.flash_attention_bwd_plain(
        *(x.double() for x in (q, k, v, out, lse, do)), causal=causal,
        window=window)


# every (hd, mask) pair and every (hd, G) pair once (G's index is the
# mask's plus twice hd's, mod 5), as chip_smoke.py's BWD_CHECKS;
# tests/test_torch_cuda.py holds the kernels over the whole product on the
# card
CASES = [(hd, (1, 4, 5, 8, 16)[(m + 2 * h) % 5], mode)
         for h, hd in enumerate((64, 120, 128, 36))
         for m, mode in enumerate(MODES)]


@pytest.mark.parametrize("hd,G,mode", CASES)
def test_kernel_model_matches_the_plain_backward(hd, G, mode):
    """Against the plain backward in float64 and in float32 (the card
    tests' reference), on the plain forward's out and lse."""
    S, Skv, causal, window = MODES[mode]
    q, k, v, do = map(torch.from_numpy, _inputs(hd * 31 + G, S, Skv, G, hd))
    out, lse = _forward(q, k, v, causal, window)
    got = kernel_model(q, k, v, out, lse, do, causal=causal, window=window)
    ref64 = _plain64(q, k, v, out, lse, do, causal, window)
    ref32 = fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                         causal=causal, window=window)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, ref64, ref32):
        assert _share(a, b) <= 1, (name, "float64", _share(a, b))
        assert _share(a, c) <= 1, (name, "float32", _share(a, c))


@pytest.mark.parametrize("hd,G,mode", [
    (120, 4, "causal"), (120, 4, "window"), (128, 16, "window"),
    (64, 5, "ragged"), (36, 8, "cross"), (100, 1, "edge"),
    (64, 1, "causal"), (128, 5, "cross_edge")])
def test_kernel_model_with_large_scores(hd, G, mode):
    """q x 4: each of the model's outputs is within 2e-5 of the float64
    plain backward (the float32 plain backward is not, in some of these
    cases)."""
    S, Skv, causal, window = MODES[mode]
    q, k, v, do = map(torch.from_numpy,
                      _inputs(hd + G, S, Skv, G, hd, q_scale=4))
    out, lse = _forward(q, k, v, causal, window)
    got = kernel_model(q, k, v, out, lse, do, causal=causal, window=window)
    ref64 = _plain64(q, k, v, out, lse, do, causal, window)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref64):
        assert _share(a, b) <= 1, (name, _share(a, b))


def test_the_float32_references_stray_at_large_scores():
    """Why q x 4 is held to float64: at hd 128, G 16 with a window the
    float32 plain backward's dk is past 2e-5 of its own float64
    evaluation, and every output of the model is closer to it."""
    S, Skv, causal, window = MODES["window"]
    q, k, v, do = map(torch.from_numpy, _inputs(144, S, Skv, 16, 128,
                                                q_scale=4))
    out, lse = _forward(q, k, v, causal, window)
    ref64 = _plain64(q, k, v, out, lse, do, causal, window)
    ref32 = fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                         causal=causal, window=window)
    got = kernel_model(q, k, v, out, lse, do, causal=causal, window=window)
    plain = [_share(a, b) for a, b in zip(ref32, ref64)]
    model = [_share(a, b) for a, b in zip(got, ref64)]
    assert plain[1] > 1, plain
    assert all(m < p for m, p in zip(model, plain)), (plain, model)


@pytest.mark.parametrize("G,hd,mode", [
    (1, 64, "causal"), (4, 120, "window"), (5, 36, "ragged"),
    (16, 128, "cross_edge"), (8, 64, "edge"), (2, 100, "cross")])
def test_kernel_model_matches_jax_vjp(G, hd, mode):
    """Against ``jax.vjp`` of the reference's ``flash_attention_vjp`` (64-row
    blocks), on the reference's own forward residuals."""
    S, Skv, causal, window = MODES[mode]
    q, k, v, do = _inputs(G * 1000 + hd, S, Skv, G, hd)
    out, vjp = jax.vjp(lambda a, b, c: JV.flash_attention_vjp(
        a, b, c, causal, window, 64, 64),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    o, lse = _forward(qt, kt, vt, causal, window)
    got = kernel_model(qt, kt, vt, o, lse, dot, causal=causal, window=window)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


def test_plain_tf32_misses_the_tolerance():
    """One term (big.big, plain TF32) at hd 120, G 4, causal S 256 is far
    outside 2e-5 of float64; the split's three terms and four are inside
    it."""
    S, Skv, causal, window = MODES["causal"]
    q, k, v, do = map(torch.from_numpy, _inputs(5, S, Skv, 4, 120))
    out, lse = _forward(q, k, v, causal, window)
    ref64 = _plain64(q, k, v, out, lse, do, causal, window)
    shares = {terms: max(_share(a, b) for a, b in zip(
        kernel_model(q, k, v, out, lse, do, terms=terms), ref64))
        for terms in (1, 3, 4)}
    assert shares[1] > 5, shares
    assert shares[3] <= 1 and shares[4] <= 1, shares
    assert shares[3] < shares[1] / 10, shares


def test_fresh_accumulators_keep_a_long_sum_exact():
    """Diffuse rows over a long causal band with values near 8 (the card
    test's case, at S 512): dq, dk and dv, summed a k-step at a time with
    compensated adds, stay within 2e-5 of float64."""
    S = 512
    q, k, v, do = map(torch.from_numpy, _inputs(11, S, S, 4, 64, v_shift=8))
    q = q * 0.3
    out, lse = _forward(q, k, v, True, 0)
    got = kernel_model(q, k, v, out, lse, do)
    ref64 = _plain64(q, k, v, out, lse, do, True, 0)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref64):
        assert _share(a, b) <= 1, (name, _share(a, b))


def test_mma_hw_truncates_at_its_largest_terms_scale():
    """A product 1.75 * 2^-14 onto 1024 (E = 10): cut to 3 * 2^-15, the
    sum truncated to 1024 (to nearest it would be 1024 + 2^-13); the same
    with both signs flipped; and small integers, which no cut reaches,
    sum exactly."""
    a = torch.zeros(1, 16, 8)
    b = torch.zeros(1, 8, 8)
    a[0, 0, 0], b[0, 0, 0] = 1.75, 2.0 ** -14
    for sign in (1.0, -1.0):
        c = torch.zeros(1, 16, 8)
        c[0, 0, 0] = sign * 1024.0
        got = mma_hw(sign * a, b, c)[0, 0, 0]
        assert float(got) == sign * 1024.0
        assert float((c + (sign * a) @ b)[0, 0, 0]) == sign * (1024 + 2 ** -13)
    gen = torch.Generator().manual_seed(0)
    a = torch.randint(-8, 9, (1, 16, 8), generator=gen).float()
    b = torch.randint(-8, 9, (1, 8, 8), generator=gen).float()
    c = torch.randint(-99, 100, (1, 16, 8), generator=gen).float()
    assert torch.equal(mma_hw(a, b, c), c + a @ b)


def test_s_keeps_float32_accuracy_on_the_cards_rounding():
    """Scores of a trained layer's scale (|S| to ~900, hd 64) on
    ``mma_hw``: S as the kernels sum it is within an ulp of S in float64;
    the three split products summed in place, onto one accumulator, are
    many ulps off (what put dv at 1.7x its tolerance on the card)."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy((3 + 2 * rng.standard_normal((1, 1, 64, 64)))
                         .astype(np.float32))
    k = torch.from_numpy((3 + 2 * rng.standard_normal((1, 1, 512, 64)))
                         .astype(np.float32))
    kt = k.transpose(-1, -2)
    want = q.double() @ kt.double()
    ulp = torch.ldexp(torch.ones_like(want), _nexp(want) - 23)
    hi, lo = _hi_lo(q, kt, 3, hw=True)
    assert float(((hi.double() + lo.double() - want).abs() / ulp).max()) <= 1
    acc = torch.zeros(1, 1, 64, 512)
    for k8 in range(8):
        ab, as_ = split(q[..., 8 * k8:8 * k8 + 8].contiguous())
        bb, bs = split(kt[..., 8 * k8:8 * k8 + 8, :].contiguous())
        acc = mma_hw(ab, bb, mma_hw(ab, bs, mma_hw(as_, bb, acc)))
    off = (acc.double() - want).abs() / ulp
    assert float(off.max()) > 8 and float(off.mean()) > 2


@pytest.mark.parametrize("hd,G,mode", [(64, 1, "causal"),
                                       (36, 5, "cross_edge")])
def test_kernel_model_on_the_cards_rounding(hd, G, mode):
    """q x 4, every product on ``mma_hw``: dq, dk and dv within 2e-5 of
    the float64 plain backward."""
    S, Skv, causal, window = MODES[mode]
    q, k, v, do = map(torch.from_numpy,
                      _inputs(hd + G, S, Skv, G, hd, q_scale=4))
    out, lse = _forward(q, k, v, causal, window)
    got = kernel_model(q, k, v, out, lse, do, causal=causal, window=window,
                       hw=True)
    ref64 = _plain64(q, k, v, out, lse, do, causal, window)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref64):
        assert _share(a, b) <= 1, (name, _share(a, b))


def test_kernel_model_skips_and_masks_as_the_band_says():
    """Causal with a window on a longer sequence: the skip and edge rules,
    asserted inside the model, hold; most of the dkdv warp-tiles that run
    need no mask, and tiles before the diagonal or past the window are
    skipped."""
    S, G, window = 700, 4, 300
    q, k, v, do = map(torch.from_numpy, _inputs(9, S, S, G, 16))
    out, lse = _forward(q, k, v, True, window)
    delta = fa.flash_attention_bwd_delta_plain(out, do)
    stats = dict(skipped=0, edge=0, inner=0)
    dk, dv = dkdv_model(q, k, v, lse, delta, do, causal=True, window=window,
                        stats=stats)
    ref = _plain64(q, k, v, out, lse, do, True, window)
    assert _share(dk, ref[1]) <= 1 and _share(dv, ref[2]) <= 1
    assert stats["inner"] > stats["edge"] > 0 and stats["skipped"] > 0
