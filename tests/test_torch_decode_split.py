"""The split of ``flash_decode`` over a thread-block cluster, on the CPU.

``csrc/flash_decode.cu`` cannot run here, so :func:`kernel_model` repeats
its arithmetic step by step in float32: each CTA's key range from
:func:`split_plan`, the CTA's online softmax over its shared-memory chunks
(p . V summed over the kernel's row subsets, then those partials in
order), and the cluster's merge of the partials in rank order (m = max
m_x, w_x = exp(m_x - m), l = sum w_x l_x, out = sum w_x acc_x / max(l,
1e-37)).  The model is held against the JAX package's Pallas kernel (in
interpret mode) and against ``flash_decode_plain`` at the tolerances of
``tests/test_kernels.py``: out 2e-5, m 1e-5, l rtol 1e-4 (float32 sums in
another order).  The kernel itself is held against the plain version on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_decode as fd

THREADS = 256                  # the kernel's threads a CTA
NEG_INF = -1e30


def kernel_model(q, kc, vc, n_valid, plan):
    """``(out, m, l)`` as the kernel computes them under ``plan``."""
    B, H, hd = q.shape
    KV = kc.shape[2]
    G, nc = H // KV, hd // 4
    # p . V: a thread per (4 heads, float4 column), over row subsets
    splits = max(1, THREADS // (-(-G // 4) * nc))
    qg = q.reshape(B, KV, G, hd)
    keys = kc.permute(0, 2, 1, 3)               # (B, KV, Skv, hd)
    vals = vc.permute(0, 2, 1, 3)
    ranges = plan.ranges(n_valid)
    assert [k for lo, hi in ranges for k in range(lo, hi)] == \
        list(range(n_valid)), "every valid key in exactly one CTA, in order"

    parts = []
    for lo, hi in ranges:                       # one CTA
        m = torch.full((B, KV, G), NEG_INF)
        l = torch.zeros(B, KV, G)
        acc = torch.zeros(splits, B, KV, G, hd)
        for k0 in range(lo, hi, plan.chunk):    # one shared-memory chunk
            rows = slice(k0, min(k0 + plan.chunk, hi))
            s = torch.einsum("bkgd,bkjd->bkgj", qg, keys[:, :, rows]) \
                * hd ** -0.5
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            v = vals[:, :, rows]
            for r in range(splits):
                acc[r] = acc[r] * corr[..., None] + torch.einsum(
                    "bkgj,bkjd->bkgd", p[..., r::splits], v[:, :, r::splits])
            m = m_new
        total = acc[0]
        for r in range(1, splits):
            total = total + acc[r]
        parts.append((m, l, total))

    mx = parts[0][0]
    for m_x, _, _ in parts[1:]:
        mx = torch.maximum(mx, m_x)
    lsum = torch.zeros(B, KV, G)
    o = torch.zeros(B, KV, G, hd)
    for m_x, l_x, a_x in parts:                 # rank order
        w = torch.exp(m_x - mx)
        lsum = lsum + w * l_x
        o = o + w[..., None] * a_x
    out = o / torch.clamp(lsum, min=1e-37)[..., None]
    return out.reshape(B, H, hd), mx.reshape(B, H), lsum.reshape(B, H)


def _inputs(seed, B, Skv, KV, G, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, KV * G, hd), (B, Skv, KV, hd), (B, Skv, KV, hd))]


def _close(got, want):
    out, m, l = (np.asarray(x) for x in got)
    wo, wm, wl = (np.asarray(x) for x in want)
    np.testing.assert_allclose(out, wo, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(m, wm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l, wl, rtol=1e-4, atol=1e-5)


# (B, Skv, KV, G, hd, n_valid, cluster); cluster None is split_plan's own
# (64 rows a CTA): n_valid 63 / 64 / 65 and 127 / 128 / 129 sit on split
# edges, 1100 over 16 CTAs gives ranges of two chunks (64 + 5 rows); Skv is
# never a multiple of the rows a CTA.
CASES = [
    (2, 128, 2, 4, 32, 128, 1),       # one CTA, two chunks
    (2, 128, 2, 4, 32, 77, 2),        # two CTAs, 39 + 38 rows
    (2, 160, 2, 5, 16, 150, 8),       # G 5, ranges of 19 and a short last
    (2, 160, 1, 8, 16, 100, 16),      # G 8, 16 CTAs of 7 rows
    (2, 96, 2, 1, 16, 40, 16),        # 16 CTAs of 3 rows: the last two empty
    (1, 96, 1, 16, 16, 3, 16),        # 3 keys over 16 CTAs: 13 empty
    (2, 300, 1, 4, 64, 300, 2),       # two CTAs of 150 rows: 64 + 64 + 22
    (2, 200, 2, 4, 32, 127, None),
    (2, 200, 2, 4, 32, 128, None),
    (2, 200, 2, 4, 32, 129, None),
    (2, 200, 2, 5, 64, 63, None),
    (2, 200, 2, 5, 64, 64, None),
    (2, 200, 2, 5, 64, 65, None),
    (1, 1200, 1, 4, 16, 1100, None),  # 16 CTAs of 69 rows: 64 + 5
    (2, 100, 1, 16, 32, 97, None),    # G 16
    (2, 96, 2, 1, 120, 50, None),     # hd 120 (30 float4 columns)
]


@pytest.mark.parametrize("B,Skv,KV,G,hd,n_valid,cluster", CASES)
def test_kernel_model_matches_pallas_and_plain(B, Skv, KV, G, hd, n_valid,
                                               cluster):
    q, kc, vc = _inputs(B * 1000 + n_valid, B, Skv, KV, G, hd)
    plan = fd.split_plan(n_valid, hd, B * KV, cluster=cluster)
    got = kernel_model(*map(torch.from_numpy, (q, kc, vc)), n_valid, plan)
    _close(got, jops.flash_decode_op(q, kc, vc, n_valid, bk=32))
    _close(got, fd.flash_decode_plain(*map(torch.from_numpy, (q, kc, vc)),
                                      n_valid))


@pytest.mark.parametrize("n_valid", [1, 40, 448, 511, 512])
def test_kernel_model_matches_plain_at_the_serving_shape(n_valid):
    """h2o-danube-3-4b's decode attention: B 4, KV 8, G 4, hd 120."""
    q, kc, vc = map(torch.from_numpy, _inputs(n_valid, 4, 512, 8, 4, 120))
    plan = fd.split_plan(n_valid, 120, 4 * 8)
    _close(kernel_model(q, kc, vc, n_valid, plan),
           fd.flash_decode_plain(q, kc, vc, n_valid))


@pytest.mark.parametrize("cluster", [None, 1, 2, 8, 16])
@pytest.mark.parametrize("n_valid", [1, 2, 31, 32, 33, 63, 64, 65, 127, 448,
                                     511, 512, 513, 1024, 1025, 4000, 4096,
                                     32768])
def test_split_plan_invariants(n_valid, cluster):
    for hd, groups in ((h, g) for h in (4, 64, 120, 128, 256, 512)
                       for g in (1, 8, 32, 512)):
        plan = fd.split_plan(n_valid, hd, groups, cluster=cluster)
        assert 1 <= plan.cluster <= fd.MAX_CLUSTER
        assert plan.ctas == groups * plan.cluster      # the launch's grid
        assert plan.ctas % plan.cluster == 0
        if cluster is not None:
            assert plan.cluster == cluster
        covered = [k for lo, hi in plan.ranges(n_valid)
                   for k in range(lo, hi)]
        assert covered == list(range(n_valid))  # each valid key once
        assert plan.rows == -(-n_valid // plan.cluster)
        assert plan.chunk % 8 == 0 and 8 <= plan.chunk <= fd.MAX_CHUNK
        assert plan.chunk * hd <= fd.CHUNK_FLOATS
        if cluster is None:
            if n_valid <= fd.ROWS_PER_CTA:
                assert plan.cluster == 1
            # nobody idles: the default plan leaves no CTA without keys
            assert all(hi > lo for lo, hi in plan.ranges(n_valid))
            if plan.cluster < fd.MAX_CLUSTER:
                assert plan.rows <= fd.ROWS_PER_CTA


def test_serving_plan_spreads_over_the_card():
    """h2o-danube-3-4b at batch 4, n_valid 512: 32 clusters of 8 CTAs of
    64 rows, 256 CTAs for the H100's 132 SMs; glm4-9b's 8 (b, kv head)
    pairs take 64."""
    assert fd.split_plan(512, 120, 32) == fd.SplitPlan(8, 64, 64, 256)
    assert fd.split_plan(512, 128, 8) == fd.SplitPlan(8, 64, 64, 64)
    assert fd.split_plan(4096, 120, 32).cluster == fd.MAX_CLUSTER


def test_cluster_sizes_outside_1_to_16_are_refused():
    for bad in (0, 17, 32):
        with pytest.raises(ValueError, match="1 to 16 CTAs"):
            fd.split_plan(512, 120, 32, cluster=bad)


def test_group_size_above_16_is_refused():
    """The kernel takes any G up to 16; G 17 is refused before any launch
    (the plain version, on the CPU, computes it)."""
    q = torch.zeros(1, 17 * 2, 8, device="meta")
    kv = torch.zeros(1, 16, 2, 8, device="meta")
    with pytest.raises(ValueError, match="up to 16, got 17"):
        fd.flash_decode(q, kv, kv, 4)
    rng = np.random.default_rng(0)
    q, kc, vc = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((1, 34, 8), (1, 16, 2, 8), (1, 16, 2, 8)))
    assert fd.flash_decode(q, kc, vc, 9)[0].shape == (1, 34, 8)
