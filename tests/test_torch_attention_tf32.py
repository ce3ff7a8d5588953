"""The split-TF32 arithmetic of ``csrc/flash_attention.cu``, on the CPU.

The kernel cannot run here, so this file models what it computes, step by
step, in float32:

- ``tf32``: the ``cvt.rna.tf32.f32`` instruction, bit for bit (10 mantissa
  bits, round to nearest, ties away from zero), and the split of an
  operand into ``big = tf32(x)`` and ``small = tf32(x - big)``;
- the three-term product ``small.big + big.small + big.big``, one k-step
  of 8 at a time into one accumulator, as the kernel issues its
  ``mma.m16n8k8`` instructions;
- the m16n8k8 TF32 fragment maps, (lane, register) -> (row, column), with
  the kernel's ldmatrix reads of its split K and V^T tiles and the key
  permutation that lets the S accumulator feed P.V as the A operand
  unchanged;
- the kernel's tiling: blocks of 128 (position, head) rows of one KV head,
  warps of 16 rows, 32-key tiles over each block's causal / window band,
  tiles masked for all of a warp's rows skipped, the mask applied on a
  warp's edge tiles only, the online softmax with per-thread shares of
  ``l``.

The model is held against ``flash_attention_plain`` and the Pallas
``flash_attention_tpu`` (interpret mode) at atol = rtol = 2e-5, the
tolerance the kernel is held to on the card (``tests/test_kernels.py``'s,
float32 sums in another order).  With one term (plain TF32) the same model
misses that tolerance, which is why the kernel splits.
"""

import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_tpu
from repro_torch.kernels import flash_attention as fa

TOL = dict(atol=2e-5, rtol=2e-5)
ROWS, WARP_ROWS, KEYS = 128, 16, 32      # block rows, warp rows, key tile
NEG_INF = -1e30
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)

# (S, Skv, causal, window), as in tests/test_torch_cuda.py and chip_smoke.py:
# "edge" ends one key past a key tile (129 = 4 x 32 + 1) and, at G 1, one
# row past a block; "cross_edge" one key past a tile with one partial block
MODES = {"causal": (256, 256, True, 0), "window": (320, 320, True, 100),
         "cross": (160, 200, False, 0), "ragged": (333, 333, True, 0),
         "edge": (129, 129, True, 0), "cross_edge": (65, 129, False, 0)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models issue many small tensor ops; across several test
    processes on one machine, torch's intra-op thread pool then spends
    far more time waiting on its threads than computing (the file takes
    19 s alone and took 17 minutes beside five other test processes), so
    this module runs them on one thread and gives the process its setting
    back afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------- numerics
def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on float32 ``x``: the magnitude rounded to 10
    mantissa bits, halfway cases away from zero (finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    big = tf32(x)
    return big, tf32(x - big)


def split_matmul(a: torch.Tensor, b: torch.Tensor, terms: int = 3):
    """``a @ b`` as the kernel takes it: k-steps of 8 in order, each split
    product issued small.big, big.small, big.big into one float32
    accumulator (``terms`` 1: big.big only, plain TF32; 4: small.small
    first as well)."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        ab, as_ = split(a[..., k0:k0 + 8])
        bb, bs = split(b[..., k0:k0 + 8, :])
        if terms == 4:
            acc = acc + as_ @ bs
        if terms >= 3:
            acc = acc + as_ @ bb
            acc = acc + ab @ bs
        acc = acc + ab @ bb
    return acc


def _tf32_reference(x: np.ndarray) -> np.ndarray:
    """Round float32 ``x`` to 11 significant bits, ties away from zero, in
    float64 arithmetic (normal numbers only)."""
    m, e = np.frexp(x.astype(np.float64))          # |m| in [0.5, 1)
    r = np.floor(np.abs(m) * 2.0 ** 11 + 0.5) * np.sign(m)
    return np.ldexp(r, e - 11).astype(np.float32)


def test_tf32_is_cvt_rna_bit_for_bit():
    rng = np.random.default_rng(0)
    bits = rng.integers(0x00800000, 0x7F000000, 200_000, dtype=np.int64)
    x = np.concatenate([bits, bits | 0x80000000]).astype(np.uint32)
    # halfway cases, in both signs: the 13 dropped bits are 1 0000 0000 0000
    ties = (bits[:1000] & ~0x1FFF | 0x1000).astype(np.uint32)
    x = np.concatenate([x, ties, ties | 0x80000000]).view(np.float32)
    got = tf32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _tf32_reference(x).view(np.uint32))
    assert not (got.view(np.uint32) & 0x1FFF).any()
    # ties go away from zero; a carry out of the mantissa bumps the exponent
    cases = {1.0 + 2.0 ** -11: 1.0 + 2.0 ** -10,
             -(1.0 + 2.0 ** -11): -(1.0 + 2.0 ** -10),
             1.0 + 2.0 ** -12: 1.0, 2.0 - 2.0 ** -23: 2.0, 0.0: 0.0}
    for x, want in cases.items():
        assert float(tf32(torch.tensor([x], dtype=torch.float32))) == want


def test_split_keeps_float32_accuracy():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(100_000)
                         .astype(np.float32) * 37)
    big, small = split(x)
    assert torch.equal(tf32(big), big) and torch.equal(tf32(small), small)
    err = (x.double() - big.double() - small.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    assert float((x - big).abs().max()) > 1e-4     # one term alone is not


# ------------------------------------------------------- fragment maps
# mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (PTX ISA, "Matrix
# Fragments for mma.m16n8k8"), lane = 4 * groupID + threadID_in_group
def a_map(lane, i):
    """A (16 x 8) register i of a lane -> (row, k)."""
    g, t = lane >> 2, lane & 3
    return g + 8 * (i & 1), t + 4 * (i >> 1)


def b_map(lane, i):
    """B (8 x 8) register i of a lane -> (k, n)."""
    g, t = lane >> 2, lane & 3
    return t + 4 * i, g


def c_map(lane, i):
    """C / D (16 x 8) register i of a lane -> (row, n)."""
    g, t = lane >> 2, lane & 3
    return g + 8 * (i >> 1), 2 * t + (i & 1)


def mma_warp(a_regs, b_regs, c_regs):
    """One warp's m16n8k8: D = A . B + C from and to per-lane registers
    ((32, 4), (32, 2), (32, 4)), in float64."""
    A, Bm, C = np.zeros((16, 8)), np.zeros((8, 8)), np.zeros((16, 8))
    for lane in range(32):
        for i in range(4):
            A[a_map(lane, i)] = a_regs[lane, i]
            C[c_map(lane, i)] = c_regs[lane, i]
        for i in range(2):
            Bm[b_map(lane, i)] = b_regs[lane, i]
    D = A @ Bm + C
    return np.array([[D[c_map(lane, i)] for i in range(4)]
                     for lane in range(32)])


def test_fragment_maps_cover_their_tiles_once():
    for fmap, regs, shape in ((a_map, 4, (16, 8)), (b_map, 2, (8, 8)),
                              (c_map, 4, (16, 8))):
        cells = [fmap(lane, i) for lane in range(32) for i in range(regs)]
        assert sorted(cells) == [(r, c) for r in range(shape[0])
                                 for c in range(shape[1])]


# The kernel's operand reads, (lane, register) -> element, for k-step kk,
# key n-tile j and column n-tile n (csrc/flash_attention.cu).  Q comes from
# registers loaded as the A map; K and V^T come from their split copies in
# shared memory by ldmatrix.x4: lane l gives the address of row 8 (l / 16)
# + l % 8, column 4 ((l / 8) % 2) of a 16 x 8 block, and gets of matrix i
# the element (row l / 4, column l % 4).
def q_read(lane, i, kk):        # qf[kk][i]: rows (gr, gr + 8), columns
    gr, tq = lane >> 2, lane & 3  # (8 kk + tq, 8 kk + tq + 4)
    return gr + 8 * (i & 1), 8 * kk + tq + 4 * (i >> 1)


def ldmatrix_x4(lane, i):
    """(row, column) within the 16 x 8 block of register i of a lane."""
    addr_lane = 8 * i + lane // 4              # the lane whose row it is
    row = 8 * (addr_lane >> 4) + (addr_lane & 7)
    col = 4 * ((addr_lane >> 3) & 1)
    return row, col + lane % 4


def k_read(lane, i, kk, j):
    """B register i of n-tile j: ldmatrix4 at row 16 (j / 2), column 8 kk of
    K, register 2 (j % 2) + i -> (key, column)."""
    row, col = ldmatrix_x4(lane, 2 * (j % 2) + i)
    return 16 * (j // 2) + row, 8 * kk + col


def vt_column(key):
    """V^T column that holds ``key``: 8j + 2t -> 8j + t, 8j + 2t + 1 ->
    8j + t + 4 (split_tile)."""
    return (key & ~7) | ((key & 1) << 2) | ((key >> 1) & 3)


def v_read(lane, i, j, n):
    """B register i of column n-tile n at k-step j: ldmatrix4 at row 16
    (n / 2) of V^T, column 8 j -> (key, column of V)."""
    row, col = ldmatrix_x4(lane, 2 * (n % 2) + i)
    vcol = 8 * j + col
    key = next(k for k in range(8 * j, 8 * j + 8) if vt_column(k) == vcol)
    return key, 16 * (n // 2) + row


P_AS_A = (0, 2, 1, 3)           # A register i <- S accumulator register


def test_q_and_k_reads_are_the_operand_fragments():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((16, 16))                 # 16 rows, 2 k-steps
    k = rng.standard_normal((16, 16))                 # 16 keys: 2 n-tiles
    for j in range(2):
        acc = np.zeros((32, 4))
        for kk in range(2):
            a = np.array([[q[q_read(lane, i, kk)] for i in range(4)]
                          for lane in range(32)])
            b = np.array([[k[k_read(lane, i, kk, j)] for i in range(2)]
                          for lane in range(32)])
            acc = mma_warp(a, b, acc)
        want = q @ k[8 * j:8 * j + 8].T
        for lane in range(32):
            for i in range(4):
                r, c = c_map(lane, i)
                assert acc[lane, i] == pytest.approx(want[r, c], abs=1e-12)


def test_s_accumulator_feeds_p_dot_v_through_the_key_permutation():
    """The registers of S (keys 8j .. 8j + 7) become P.V's A fragment as
    (s0, s2, s1, s3) when V's rows are read as key 8j + 2 tq (+ 1): no
    shuffle and no shared memory in between."""
    rng = np.random.default_rng(3)
    p = rng.random((16, 64))                          # a warp's P tile
    v = rng.standard_normal((64, 24))                 # 3 column n-tiles
    for n in range(3):
        acc = np.zeros((32, 4))
        for j in range(8):
            s_regs = np.array([[p[c_map(lane, i)[0], 8 * j + c_map(lane, i)[1]]
                                for i in range(4)] for lane in range(32)])
            a = s_regs[:, P_AS_A]
            b = np.array([[v[v_read(lane, i, j, n)] for i in range(2)]
                          for lane in range(32)])
            acc = mma_warp(a, b, acc)
        want = p @ v[:, 8 * n:8 * n + 8]
        got = np.zeros((16, 8))
        for lane in range(32):
            for i in range(4):
                got[c_map(lane, i)] = acc[lane, i]
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # and without the permutation the product is wrong
    a = np.array([[p[c_map(lane, i)[0], c_map(lane, i)[1]] for i in range(4)]
                  for lane in range(32)])
    b = np.array([[v[v_read(lane, i, 0, 0)] for i in range(2)]
                  for lane in range(32)])
    got = mma_warp(a, b, np.zeros((32, 4)))
    want = p[:, :8] @ v[:8, :8]
    assert not np.allclose([got[lane, i] for lane in range(32)
                            for i in range(4)],
                           [want[c_map(lane, i)] for lane in range(32)
                            for i in range(4)])


def test_ldmatrix_reads_are_the_b_fragments():
    """Each register the kernel's ldmatrix4 hands a lane is the element the
    m16n8k8 B map asks of it: K[8j + gr][8kk + tq (+ 4)] and, through the
    V^T column permutation, V[8j + 2tq (+ 1)][8n + gr]."""
    for lane in range(32):
        gr, tq = lane >> 2, lane & 3
        for i in range(2):
            for kk, j in ((0, 0), (3, 1), (14, 6), (15, 7)):
                assert k_read(lane, i, kk, j) == (8 * j + gr, 8 * kk + tq + 4 * i)
            for j, n in ((0, 0), (2, 1), (7, 14), (5, 15)):
                assert v_read(lane, i, j, n) == (8 * j + 2 * tq + i, 8 * n + gr)
    assert sorted(vt_column(k) for k in range(64)) == list(range(64))


def test_tile_row_strides_spread_ldmatrix_over_all_banks():
    """Row strides of 4 mod 8 floats (Q and K: 8 nk + 4, V^T: 36) put the 8
    rows of each ldmatrix phase, 16 bytes each, on 32 distinct banks."""
    for st in [8 * nk + 4 for nk in range(1, 17)] + [36]:
        for col in (0, 4, 8, 12):
            banks = {(row * st + col + b) % 32 for row in range(8)
                     for b in range(4)}
            assert len(banks) == 32, st


# ------------------------------------------------------------ the kernel
def kernel_model(q, k, v, *, causal=True, window=0, terms=3, stats=None):
    """``flash_attention`` as ``csrc/flash_attention.cu`` computes it, every
    block, warp and key tile at once along the row axis.  ``stats``, a
    dict, counts the warp-tiles of the tiles in order: skipped (outside
    the block's band, or masked for all of the warp's rows), run with the
    mask (edge) and run without it (inner)."""
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    hd8 = 8 * -(-hd // 8)
    rows = S * G
    r_pad = -(-rows // ROWS) * ROWS
    n_tiles = -(-Skv // KEYS)
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    # rows R = i * G + g of each KV head; zero past hd8, rows and Skv
    Q = torch.zeros(B, KV, r_pad, hd8)
    Q[:, :, :rows, :hd] = (q.reshape(B, S, KV, G, hd).permute(0, 2, 1, 3, 4)
                           .reshape(B, KV, rows, hd))
    Kp, Vp = (torch.zeros(B, KV, n_tiles * KEYS, hd8) for _ in range(2))
    Kp[:, :, :Skv, :hd] = k.permute(0, 2, 1, 3)
    Vp[:, :, :Skv, :hd] = v.permute(0, 2, 1, 3)

    R = torch.arange(r_pad)
    pos = R // G
    w_lo = (R // WARP_ROWS) * WARP_ROWS              # each row's warp
    warp_live = w_lo < rows
    wp_lo = w_lo // G
    wp_hi = (torch.clamp(w_lo + WARP_ROWS, max=rows) - 1) // G
    b_lo = (R // ROWS) * ROWS                         # each row's block
    p_lo = b_lo // G
    p_hi = (torch.clamp(b_lo + ROWS, max=rows) - 1) // G
    t_lo = torch.zeros_like(R)
    t_hi = torch.full_like(R, (Skv - 1) // KEYS)
    if causal:
        t_hi = torch.clamp(p_hi, max=Skv - 1) // KEYS
        if window > 0:
            t_lo = torch.clamp(p_lo - window + 1, min=0) // KEYS

    m = torch.full((B, KV, r_pad), NEG_INF)
    l = torch.zeros(B, KV, r_pad, 4)                  # one share a lane
    o = torch.zeros(B, KV, r_pad, hd8)
    for t in range(n_tiles):
        k0, k1 = t * KEYS, t * KEYS + KEYS - 1
        band = (t >= t_lo) & (t <= t_hi)           # a block loads its band
        live = band & warp_live
        if causal:                          # warps skip fully masked tiles
            live &= ~((k0 > wp_hi) | ((window > 0) & (wp_lo - k1 >= window)))
        edge = torch.full_like(live, k1 >= Skv)
        if causal:
            edge |= (k1 > wp_lo) | ((window > 0) & (wp_hi - k0 >= window))
        key = torch.arange(k0, k1 + 1)
        keep = (key < Skv)[None, :].expand(r_pad, KEYS)
        if causal:
            keep = keep & (pos[:, None] >= key[None, :])
            if window > 0:
                keep = keep & (pos[:, None] - key[None, :] < window)
        # tiles that skip the mask need none: every pair of their valid
        # rows is live; and no tile the warp skips has a live pair
        inner = live & ~edge & (R < rows)
        assert bool(keep[inner].all())
        assert not bool(keep[~live & (R < rows)].any())
        mask = edge[:, None] & ~keep

        s = split_matmul(Q, Kp[:, :, k0:k1 + 1].transpose(-1, -2), terms)
        s = torch.where(mask, torch.tensor(NEG_INF), s * scale)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2((s - m_new[..., None]) * LOG2E)
        # lane tq of a quad holds keys 8j + 2tq and 8j + 2tq + 1
        share = p.reshape(B, KV, r_pad, KEYS // 8, 4, 2).sum((-3, -1))
        l_new = l * corr[..., None] + share
        o_new = o * corr[..., None]
        for j in range(KEYS // 8):                    # k-steps of P.V
            pb, ps = split(p[..., 8 * j:8 * j + 8])
            vb, vs = split(Vp[:, :, k0 + 8 * j:k0 + 8 * j + 8])
            if terms == 4:
                o_new = o_new + ps @ vs
            if terms >= 3:
                o_new = o_new + ps @ vb
                o_new = o_new + pb @ vs
            o_new = o_new + pb @ vb
        if stats is not None:
            first = (R % WARP_ROWS == 0) & warp_live    # one row a warp
            n_blocks = B * KV
            stats["skipped"] += n_blocks * int((first & ~live).sum())
            stats["edge"] += n_blocks * int((first & live & edge).sum())
            stats["inner"] += n_blocks * int((first & live & ~edge).sum())
        m = torch.where(live, m_new, m)
        l = torch.where(live[:, None], l_new, l)
        o = torch.where(live[:, None], o_new, o)

    den = torch.clamp((l[..., 0] + l[..., 1]) + (l[..., 2] + l[..., 3]),
                      min=1e-37)
    out = (o / den[..., None])[:, :, :rows, :hd]
    return (out.reshape(B, KV, S, G, hd).permute(0, 2, 1, 3, 4)
            .reshape(B, S, H, hd))


def _qkv(seed, S, Skv, G, hd, q_scale=1.0, B=2, KV=2):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, KV * G, hd), (B, Skv, KV, hd),
                         (B, Skv, KV, hd)))
    return q * np.float32(q_scale), k, v


def _close(got, want):
    diff = (got - want).abs()
    ok = bool((diff <= TOL["atol"] + TOL["rtol"] * want.abs()).all())
    return float(diff.max()), ok


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("G", [1, 4, 5, 8, 16])
@pytest.mark.parametrize("hd", [64, 120, 128, 36])
def test_kernel_model_matches_the_plain_version(hd, G, mode):
    S, Skv, causal, window = MODES[mode]
    q, k, v = map(torch.from_numpy, _qkv(hd * 31 + G, S, Skv, G, hd))
    err, ok = _close(kernel_model(q, k, v, causal=causal, window=window),
                     fa.flash_attention_plain(q, k, v, causal=causal,
                                              window=window))
    assert ok, f"max error {err:.3e}"


@pytest.mark.parametrize("hd,G,mode", [
    (120, 4, "causal"), (120, 4, "window"), (128, 16, "window"),
    (64, 5, "ragged"), (36, 8, "cross"), (100, 1, "edge")])
def test_kernel_model_with_large_scores(hd, G, mode):
    """q x 4: scores four times as large, so exp amplifies any error in
    them four times as much."""
    S, Skv, causal, window = MODES[mode]
    q, k, v = map(torch.from_numpy, _qkv(hd + G, S, Skv, G, hd, q_scale=4))
    err, ok = _close(kernel_model(q, k, v, causal=causal, window=window),
                     fa.flash_attention_plain(q, k, v, causal=causal,
                                              window=window))
    assert ok, f"max error {err:.3e}"


@pytest.mark.parametrize("hd,G,mode,q_scale", [
    (120, 4, "window", 1.0), (128, 16, "ragged", 1.0), (64, 5, "causal", 1.0),
    (36, 1, "cross", 1.0), (100, 8, "edge", 1.0), (120, 5, "cross_edge", 1.0),
    (120, 4, "causal", 4.0)])
def test_kernel_model_matches_pallas(hd, G, mode, q_scale):
    S, Skv, causal, window = MODES[mode]
    q, k, v = _qkv(hd * 7 + G, S, Skv, G, hd, q_scale=q_scale)
    got = kernel_model(*map(torch.from_numpy, (q, k, v)), causal=causal,
                       window=window)
    want = torch.from_numpy(np.asarray(flash_attention_tpu(
        q, k, v, causal=causal, window=window, interpret=True)))
    err, ok = _close(got, want)
    assert ok, f"max error {err:.3e}"


def test_plain_tf32_misses_the_tolerance():
    """One term (big.big, plain TF32) at hd 120, G 4, causal S 256 is far
    outside 2e-5; the split and four terms are inside it."""
    q, k, v = map(torch.from_numpy, _qkv(5, 256, 256, 4, 120))
    want = fa.flash_attention_plain(q, k, v)
    errs = {terms: _close(kernel_model(q, k, v, terms=terms), want)
            for terms in (1, 3, 4)}
    assert not errs[1][1] and errs[1][0] > 5 * TOL["atol"], errs
    assert errs[3][1] and errs[4][1], errs
    assert errs[3][0] < errs[1][0] / 10, errs


def test_kernel_model_skips_and_masks_as_the_band_says():
    """Causal with a window on a longer sequence: the skip and edge rules,
    asserted inside the model, hold; most warp-tiles of the band run
    without the mask, and the tiles past the diagonal or before the window
    are skipped."""
    S, G, window = 700, 4, 300
    q, k, v = map(torch.from_numpy, _qkv(9, S, S, G, 16))
    stats = dict(skipped=0, edge=0, inner=0)
    err, ok = _close(kernel_model(q, k, v, window=window, stats=stats),
                     fa.flash_attention_plain(q, k, v, window=window))
    assert ok, f"max error {err:.3e}"
    warps = 2 * 2 * S * G // WARP_ROWS
    tiles = -(-S // KEYS)
    assert sum(stats.values()) == warps * tiles
    # a warp's 4 positions reach at most ceil(303 / 32) + 1 = 11 tiles
    assert stats["edge"] + stats["inner"] <= warps * 11
    assert stats["inner"] > stats["edge"] > 0 and stats["skipped"] > 0
