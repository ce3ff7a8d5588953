"""The CUDA kernels on the card, against their plain PyTorch versions.

These tests need an NVIDIA GPU and nvcc; without them they skip.  Run them
on the card with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Cache replay outputs are integers and flags, and page copies are bytes:
those comparisons are exact.  ``flash_decode`` sums in another order than
its plain version (and splits the keys over a cluster of CTAs): out within
2e-5, m within 1e-5, l within rtol 1e-4 (the tolerances of
``tests/test_kernels.py``); so does ``flash_attention``:
within 2e-5.  A reduced-width forward on the card matches the CPU's within
1e-4 (float32 matmuls summed in another order).  This file imports no JAX,
so it also runs where JAX is not installed.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.cache.dram_cache import DRAMCacheConfig
from repro_torch.core.devices import make_device
from repro_torch.core.replay.cuda_engine import run_cuda
from repro_torch.configs import get_arch
from repro_torch.distributed.step import make_prefill_step
from repro_torch.kernels import cache_sim as ks
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import page_gather as pg
from repro_torch.kernels.ops import page_gather_op, page_scatter_op
from repro_torch.launch.serve import serve
from repro_torch.models.transformer import forward, init_params
from repro_torch.tiered.store import TieredStore, TieredStoreConfig

pytestmark = pytest.mark.cuda
TIMING = dict(issue_ns=1, hit_ns=50, miss_ns=5000, miss_occ_ns=213, wb_ns=97)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _equal(got, want):
    for g, w in zip(got, want):
        if isinstance(g, tuple):
            _equal(g, w)
        else:
            assert g.device.type == "cuda" and torch.equal(g, w)


@pytest.mark.parametrize("policy,num_sets,ways,outstanding,shape,kind", [
    ("lru", 1, 64, 32, (600,), "uniform"),
    ("fifo", 16, 4, 8, (777,), "uniform"),
    ("direct", 64, 1, 1, (600,), "uniform"),
    ("lru", 4096, 8, 32, (300,), "uniform"),   # state in global scratch
    ("lru", 4, 8, 4, (2, 300), "uniform"),     # two lanes, two blocks
    ("fifo", 1, 33, 2, (0,), "uniform"),       # empty trace
    ("lru", 1, 64, 32, (2500,), "collide"),    # long probes and shifts
    ("fifo", 1, 64, 8, (2500,), "collide"),
    ("fifo", 1, 4096, 32, (2, 9000), "uniform"),   # Table I shape, 2 lanes
    ("lru", 3, 40, 8, (2500,), "uniform"),     # sets not a power of two
    ("lru", 1, 4096, 32, (9000,), "all_hit"),
    ("lru", 1, 4096, 32, (9000,), "all_miss"),
])
def test_kernels_equal_plain_versions(card, policy, num_sets, ways,
                                      outstanding, shape, kind):
    pages, writes = (x.to(card) for x in ks.stress_trace(
        kind, num_sets, ways, shape, seed=7))
    geo = dict(num_sets=num_sets, ways=ways, policy=policy)
    before = dict(ks.LAUNCHES)
    got = ks.cache_sim(pages, writes, return_state=True, **geo)
    got_f = ks.cache_sim_fused(pages, writes, outstanding=outstanding,
                               **TIMING, **geo)
    torch.cuda.synchronize()
    assert ks.LAUNCHES["cache_sim"] == before["cache_sim"] + 1
    assert ks.LAUNCHES["cache_sim_fused"] == before["cache_sim_fused"] + 1
    _equal(got, ks.cache_sim_plain(pages, writes, **geo))
    _equal(got_f, ks.cache_sim_fused_plain(pages, writes,
                                           outstanding=outstanding,
                                           **TIMING, **geo))


def test_kernel_hash_is_the_wrappers(card):
    from repro_torch.kernels import _build

    assert _build.library("cache_sim").cache_sim_hash_mul() == ks.HASH_MUL


def test_run_cuda_on_the_card_equals_the_cpu(card):
    rng = np.random.default_rng(3)
    addrs = rng.integers(0, 256, 3000) * 4096 + rng.integers(0, 64, 3000) * 64
    writes = rng.random(3000) < 0.3
    for policy in ("lru", "fifo", "direct"):
        def run(where):
            dev = make_device("cxl-ssd-cache", cache_cfg=DRAMCacheConfig(
                policy=policy, capacity_bytes=64 * 4096))
            return run_cuda(dev, addrs, writes, validate=True,
                            torch_device=where)
        gpu, cpu = run("cuda"), run("cpu")
        for f in ("latency_ticks", "hit_flags", "evict_flags"):
            np.testing.assert_array_equal(getattr(gpu, f), getattr(cpu, f))
        for f in ("elapsed_ticks", "sum_latency_ticks", "end_tick"):
            assert getattr(gpu, f) == getattr(cpu, f)


def _decode_close(got, want):
    out, m, l = got
    wo, wm, wl = want
    assert out.device.type == "cuda"
    torch.testing.assert_close(out, wo, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(m, wm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, wl, rtol=1e-4, atol=1e-5)


def _decode_inputs(card, seed, B, Skv, KV, G, hd):
    gen = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(B, KV * G, hd, device=card, generator=gen)
    kc, vc = (torch.randn(B, Skv, KV, hd, device=card, generator=gen)
              for _ in range(2))
    return q, kc, vc


# n_valid on the earlier kernel's tile edges (31, 32), on and around split
# edges (64 rows a CTA: 63, 64, 65; 448 = 7 x 64; 511), and a 4096-slot
# cache split over 16 CTAs (1000 and 1025: ranges of 63 and 65 rows, the
# latter two chunks)
@pytest.mark.parametrize("Skv,n_valid", [(512, n) for n in (
    1, 31, 32, 63, 64, 65, 448, 511, 512)] + [(4096, n) for n in (
        1000, 1025, 4096)])
@pytest.mark.parametrize("G", [4, 1, 5, 16])
@pytest.mark.parametrize("hd", [120, 128, 64])
def test_flash_decode_equals_plain(card, hd, G, Skv, n_valid):
    q, kc, vc = _decode_inputs(card, hd * 100 + G, 4, Skv, 8 if G < 16
                               else 2, G, hd)
    before = fd.LAUNCHES["flash_decode"]
    got = fd.flash_decode(q, kc, vc, n_valid)
    torch.cuda.synchronize()
    assert fd.LAUNCHES["flash_decode"] == before + 1
    _decode_close(got, fd.flash_decode_plain(q, kc, vc, n_valid))


@pytest.mark.parametrize("n_valid", [1, 40, 63, 64, 65, 200, 511])
@pytest.mark.parametrize("cluster", [1, 2, 8, 16])
@pytest.mark.parametrize("hd,G", [(120, 4), (64, 5), (128, 16)])
def test_flash_decode_forced_cluster_sizes_equal_plain(card, hd, G, cluster,
                                                       n_valid):
    """Every cluster size, with short and empty last ranges (n_valid 40
    over 16 CTAs leaves two of them no key)."""
    q, kc, vc = _decode_inputs(card, cluster * 1000 + n_valid, 2, 512, 2, G,
                               hd)
    plan = fd.split_plan(n_valid, hd, 2 * 2, cluster=cluster)
    _decode_close(fd._launch(q, kc, vc, n_valid, plan),
                  fd.flash_decode_plain(q, kc, vc, n_valid))


def test_flash_decode_refused_launch_raises(card):
    """A launch the card refuses raises and counts no launch; the next
    call runs."""
    q, kc, vc = _decode_inputs(card, 9, 2, 512, 8, 4, 120)
    plan = fd.split_plan(512, 120, 16)
    before = fd.LAUNCHES["flash_decode"]
    for bad in (plan._replace(cluster=32, rows=16, ctas=512),  # > 16 CTAs
                plan._replace(chunk=1024)):        # 960 KB of shared memory
        with pytest.raises(RuntimeError, match="CUDA error"):
            fd._launch(q, kc, vc, 512, bad)
    assert fd.LAUNCHES["flash_decode"] == before
    _decode_close(fd.flash_decode(q, kc, vc, 512),
                  fd.flash_decode_plain(q, kc, vc, 512))


def test_flash_decode_spreads_over_the_card(card):
    """At the serving shape one call is one launch of 256 CTAs (clusters
    of 8), and the card holds clusters of every planned size."""
    plan = fd.split_plan(512, 120, 4 * 8)
    assert (plan.cluster, plan.rows, plan.ctas) == (8, 64, 256)
    assert plan.ctas >= torch.cuda.get_device_properties(
        card).multi_processor_count
    for G, hd in ((4, 120), (16, 128), (5, 64)):
        for n_valid in (64, 512, 4096):
            p = fd.split_plan(n_valid, hd)
            assert fd.max_active_clusters(G, hd, p) >= 1, (G, hd, p)


def test_flash_decode_reads_one_layer_of_the_stacked_state(card):
    gen = torch.Generator(device=card).manual_seed(1)
    k = torch.randn(3, 2, 64, 8, 120, device=card, generator=gen)
    v = torch.randn(3, 2, 64, 8, 120, device=card, generator=gen)
    q = torch.randn(2, 32, 120, device=card, generator=gen)
    _decode_close(fd.flash_decode(q, k[1], v[1], 40),
                  fd.flash_decode_plain(q, k[1], v[1], 40))
    odd = torch.randn(2, 64, 2, 30, device=card, generator=gen)
    with pytest.raises(ValueError, match="multiple of 4"):
        fd.flash_decode(q[:, :4, :30], odd, odd, 64)


def _int8_inputs(card, seed, B, Skv, KV, G, hd, layers=()):
    """q and int8 caches with float16 scales, as a decode state holds them
    (a quantized random row per slot and KV head)."""
    gen = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(B, KV * G, hd, device=card, generator=gen)
    out = [q]
    for _ in range(2):
        rows = torch.randn(*layers, B, Skv, KV, hd, device=card, generator=gen)
        scale = torch.clamp(rows.abs().amax(-1), min=1e-6) / 127.0
        out.append(torch.round(rows / scale[..., None]).to(torch.int8))
        out.append(scale.to(torch.float16))
    q, kc, ks, vc, vs = out
    return q, kc, vc, ks, vs


# hd 120 (head rows at 8-byte offsets of a 960-byte slot), 64 and 128; G
# 1, 4, 5 (hymba), 8; fill levels on and around the split edges (64 rows
# a CTA) and a 4096-slot cache (ranges of two chunks and more)
@pytest.mark.parametrize("Skv,n_valid", [(512, n) for n in (
    1, 31, 63, 64, 65, 448, 512)] + [(4096, n) for n in (1025, 4096)])
@pytest.mark.parametrize("G", [1, 4, 5, 8])
@pytest.mark.parametrize("hd", [120, 64, 128])
def test_flash_decode_int8_equals_plain(card, hd, G, Skv, n_valid):
    args = _int8_inputs(card, hd * 100 + G, 4, Skv, 8 if G < 8 else 4, G, hd)
    before = dict(fd.LAUNCHES)
    got = fd.flash_decode_int8(*args, n_valid)
    torch.cuda.synchronize()
    assert fd.LAUNCHES["flash_decode_int8"] == before["flash_decode_int8"] + 1
    assert fd.LAUNCHES["flash_decode"] == before["flash_decode"]
    _decode_close(got, fd.flash_decode_int8_plain(*args, n_valid))


@pytest.mark.parametrize("n_valid", [1, 40, 65, 200, 511])
@pytest.mark.parametrize("cluster", [1, 2, 8, 16])
@pytest.mark.parametrize("hd,G", [(120, 4), (64, 5), (128, 16)])
def test_flash_decode_int8_forced_cluster_sizes_equal_plain(card, hd, G,
                                                            cluster, n_valid):
    q, kc, vc, ks, vs = _int8_inputs(card, cluster * 1000 + n_valid, 2, 512,
                                     2, G, hd)
    plan = fd.split_plan(n_valid, hd, 2 * 2, cluster=cluster)
    _decode_close(fd._launch(q, kc, vc, n_valid, plan, scales=(ks, vs)),
                  fd.flash_decode_int8_plain(q, kc, vc, ks, vs, n_valid))


def test_flash_decode_int8_reads_one_layer_of_the_stacked_state(card):
    """One layer of stacked (layers, B, Sc, KV, hd) caches and (layers, B,
    Sc, KV) scales, read in place; rows not 4-byte aligned are refused."""
    q, kc, vc, ks, vs = _int8_inputs(card, 2, 2, 64, 8, 4, 120, layers=(3,))
    _decode_close(fd.flash_decode_int8(q, kc[1], vc[1], ks[1], vs[1], 40),
                  fd.flash_decode_int8_plain(q, kc[1], vc[1], ks[1], vs[1],
                                             40))
    with pytest.raises(ValueError, match="4-byte"):
        fd.flash_decode_int8(q[..., :116], kc[1, ..., 2:118],
                             vc[1, ..., 2:118], ks[1], vs[1], 40)


def test_flash_decode_int8_spreads_as_the_float_kernel(card):
    for G, hd in ((4, 120), (16, 128), (5, 64)):
        for n_valid in (64, 512, 4096):
            p = fd.split_plan(n_valid, hd)
            assert fd.max_active_clusters(G, hd, p, int8=True) >= \
                fd.max_active_clusters(G, hd, p), (G, hd, p)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


@pytest.mark.parametrize("arch,int8", [
    ("mixtral-8x7b", False), ("mamba2-2_7b", False), ("hymba-1_5b", False),
    ("musicgen-large", False), ("kimi-k2-1t-a32b", False),
    ("h2o-danube-3-4b", True), ("hymba-1_5b", True)])
def test_family_decode_on_the_card_equals_the_cpu(card, arch, int8):
    """12 teacher-forced decode steps at reduced width through the
    kernels: logits within 1e-4 of the CPU's, one decode kernel launch a
    step and attention layer."""
    cfg = get_arch(arch).reduced()
    if int8:
        cfg = dataclasses.replace(cfg, kv_dtype="int8")
    params = init_params(cfg, 8, torch_device="cpu")
    kw = dict(batch=2, prompt_len=4, gen=8, context=16, kv_page_tokens=4,
              seed=8)
    cpu = serve(params, cfg, keep_logits=True, **kw)
    fd.reset_launches()
    gpu = serve(_to(params, card), cfg, forced=cpu.tokens, keep_logits=True,
                **kw)
    name = "flash_decode_int8" if int8 else "flash_decode"
    attn = cfg.n_layers if cfg.n_heads else 0
    assert fd.LAUNCHES[name] == 12 * attn
    torch.testing.assert_close(torch.stack(gpu.logits).cpu(),
                               torch.stack(cpu.logits), rtol=1e-4, atol=1e-4)
    if int8:                  # inputs equal to float32 rounding: a code
        for k in ("k", "v"):  # at most one apart, scales to float16's
            diff = gpu.state[k].cpu().int() - cpu.state[k].int()
            assert int(diff.abs().max()) <= 1, k
            torch.testing.assert_close(gpu.state[f"{k}_scale"].cpu(),
                                       cpu.state[f"{k}_scale"], rtol=1e-3,
                                       atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.uint8])
def test_page_ops_equal_plain_with_a_repeated_slot(card, dtype):
    gen = torch.Generator(device=card).manual_seed(2)
    shape = (9, 3, 7) if dtype == torch.uint8 else (9, 24, 4, 16, 8)
    pool = torch.randint(0, 100, shape, device=card, generator=gen).to(dtype)
    pages = torch.randint(0, 100, (4,) + shape[1:], device=card,
                          generator=gen).to(dtype)
    table = torch.tensor([7, 2, 7, 0], dtype=torch.int32)   # 7 twice
    before = dict(pg.LAUNCHES)
    assert torch.equal(page_gather_op(pool, table), pool[table.long()])
    got = page_scatter_op(pool.clone(), table, pages)
    want = pool.clone()
    for i, slot in enumerate(table.tolist()):
        want[slot] = pages[i]
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got[7], pages[2])
    assert pg.LAUNCHES == {k: v + 1 for k, v in before.items()}


def test_tiered_store_on_the_card_equals_the_cpu(card):
    rng = np.random.default_rng(4)
    stores = [TieredStore(TieredStoreConfig(n_logical_pages=16,
                                            page_shape=(4, 8), hbm_pages=3,
                                            policy="2q"),
                          backing=make_device("cxl-ssd"), torch_device=d)
              for d in ("cuda", "cpu")]
    for _ in range(60):
        lpns = [int(x) for x in rng.integers(0, 16, rng.integers(1, 4))]
        data = rng.standard_normal((4, 8)).astype(np.float32)
        if rng.random() < 0.3:
            for st in stores:
                st.update_page(lpns[0], data)
        else:
            a, b = (st.read_pages(lpns) for st in stores)
            assert torch.equal(a.cpu(), b)
    for st in stores:
        st.flush()
    assert stores[0].stats == stores[1].stats
    assert stores[0].sim_ticks == stores[1].sim_ticks
    for lpn in range(16):
        np.testing.assert_array_equal(stores[0].capacity_page(lpn),
                                      stores[1].capacity_page(lpn))


def test_serve_on_the_card_runs_the_kernels_and_matches_the_cpu(card):
    cfg = get_arch("h2o-danube-3-4b").reduced()
    params = init_params(cfg, 5, torch_device="cpu")
    kw = dict(batch=2, prompt_len=8, gen=40, context=32, kv_page_tokens=4,
              seed=5)
    cpu = serve(params, cfg, keep_logits=True, **kw)
    fd.reset_launches()
    pg.reset_launches()
    gpu = serve({k: (v.to(card) if torch.is_tensor(v) else
                     {n: t.to(card) for n, t in v.items()})
                 for k, v in params.items()}, cfg, forced=cpu.tokens,
                keep_logits=True, **kw)
    assert fd.LAUNCHES["flash_decode"] == 48 * cfg.n_layers
    assert pg.LAUNCHES["page_gather"] > 0 and pg.LAUNCHES["page_scatter"] > 0
    torch.testing.assert_close(torch.stack(gpu.logits).cpu(),
                               torch.stack(cpu.logits), rtol=1e-4, atol=1e-4)
    assert gpu.tiered.stats == cpu.tiered.stats
    assert gpu.tiered.sim_ticks == cpu.tiered.sim_ticks


# (S, Skv, causal, window): a block is 128 query rows (position, head) of
# one KV head, 16 a warp, a key tile 32 keys; "edge" ends one key past a
# tile (and, at G 1, one row past a block), "cross_edge" one key past a
# tile with one partial block
PREFILL_MODES = {"causal": (256, 256, True, 0), "window": (320, 320, True, 100),
                 "cross": (160, 200, False, 0), "ragged": (333, 333, True, 0),
                 "edge": (129, 129, True, 0), "cross_edge": (65, 129, False, 0)}


@pytest.mark.parametrize("q_scale", [1.0, 4.0])   # x 4: large scores
@pytest.mark.parametrize("mode", sorted(PREFILL_MODES))
@pytest.mark.parametrize("G", [1, 4, 5, 8, 16])
@pytest.mark.parametrize("hd", [64, 120, 128, 36, 100])
def test_flash_attention_equals_plain(card, hd, G, mode, q_scale):
    S, Skv, causal, window = PREFILL_MODES[mode]
    gen = torch.Generator(device=card).manual_seed(hd * 100 + G)
    q = torch.randn(2, S, 2 * G, hd, device=card, generator=gen) * q_scale
    k, v = (torch.randn(2, Skv, 2, hd, device=card, generator=gen)
            for _ in range(2))
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert got.device.type == "cuda"
    torch.testing.assert_close(
        got, fa.flash_attention_plain(q, k, v, causal=causal, window=window),
        rtol=2e-5, atol=2e-5)


def test_flash_attention_reads_strided_views_in_place(card):
    gen = torch.Generator(device=card).manual_seed(3)
    # q: every other head of a wider tensor; k, v: one layer of a stack,
    # interleaved along the head axis
    wide = torch.randn(2, 96, 64, 120, device=card, generator=gen)
    kv = torch.randn(3, 2, 96, 8, 120, device=card, generator=gen)
    q, k, v = wide[:, :, ::2], kv[1, :, :, ::2], kv[2, :, :, 1::2]
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    got = fa.flash_attention(q, k, v, window=40)
    torch.testing.assert_close(
        got, fa.flash_attention_plain(q.contiguous(), k.contiguous(),
                                      v.contiguous(), window=40),
        rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="16-byte"):      # 4-byte offset
        fa.flash_attention(wide[..., 1:117], k[..., :116], v[..., :116])


def test_forward_on_the_card_runs_the_kernel_and_matches_the_cpu(card):
    full = get_arch("h2o-danube-3-4b")
    cfg = full.reduced(n_layers=full.n_layers)     # full depth: 24 layers
    params = init_params(cfg, 6, torch_device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(6).integers(0, cfg.vocab, (2, 96)))
    cpu = make_prefill_step(cfg, torch_device="cpu")(params, {"tokens": tokens})
    on_card = {k: (v.to(card) if torch.is_tensor(v) else
                   {n: t.to(card) for n, t in v.items()})
               for k, v in params.items()}
    fa.reset_launches()
    gpu = make_prefill_step(cfg)(on_card, {"tokens": tokens})
    assert fa.LAUNCHES["flash_attention"] == cfg.n_layers == 24
    with torch.no_grad():
        logits, aux = forward(on_card, cfg, {"tokens": tokens.to(card)})
    assert fa.LAUNCHES["flash_attention"] == 2 * cfg.n_layers
    assert aux == 0.0
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(logits, gpu, rtol=0, atol=0)


# --------------------------------------------------- the training kernels
# the CPU tests' tolerance (tests/test_torch_flash_vjp.py,
# tests/test_torch_attention_bwd_tf32.py): the backward kernels take every
# product in split TF32 on the tensor cores (float32 accuracy) and sum over
# up to Skv keys (dq) or S x G query rows (dk, dv) in another order than
# the plain version
BWD_TOL = dict(rtol=2e-5, atol=2e-5)


def _bwd_inputs(card, seed, mode, G, hd, q_scale=1.0):
    S, Skv, causal, window = PREFILL_MODES[mode]
    gen = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(2, S, 2 * G, hd, device=card, generator=gen) * q_scale
    k, v = (torch.randn(2, Skv, 2, hd, device=card, generator=gen)
            for _ in range(2))
    do = torch.randn(2, S, 2 * G, hd, device=card, generator=gen)
    return q, k, v, do, dict(causal=causal, window=window)


@pytest.mark.parametrize("mode", sorted(PREFILL_MODES))
@pytest.mark.parametrize("G", [1, 4, 5, 8, 16])
@pytest.mark.parametrize("hd", [64, 120, 128, 36])
def test_flash_attention_lse_instance_equals_plain(card, hd, G, mode):
    """The training forward: lse within 2e-5 of the plain version's, and
    its out bit-equal to the inference instance's."""
    q, k, v, _, kw = _bwd_inputs(card, hd * 10 + G, mode, G, hd, 4.0)
    before = dict(fa.LAUNCHES)
    out, lse = fa.flash_attention_lse(q, k, v, **kw)
    inference = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_lse"] == \
        before["flash_attention_lse"] + 1
    assert torch.equal(out, inference)
    want_out, want_lse = fa.flash_attention_lse_plain(q, k, v, **kw)
    torch.testing.assert_close(out, want_out, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("hd", [64, 120, 128, 36])
def test_flash_attention_keeps_a_large_running_sum_exact(card, hd):
    """Diffuse rows over long sequences: O grows to l times out (2048
    keys of values near 8), where products summed straight onto it lose
    low bits; the kernel is held to the plain version in float64."""
    gen = torch.Generator(device=card).manual_seed(hd)
    S = 2048
    q = torch.randn(1, S, 4, hd, device=card, generator=gen) * 0.3
    k = torch.randn(1, S, 4, hd, device=card, generator=gen)
    v = torch.randn(1, S, 4, hd, device=card, generator=gen) + 8.0
    out, lse = fa.flash_attention_lse(q, k, v)
    want_out, want_lse = fa.flash_attention_lse_plain(
        *(x.double() for x in (q, k, v)))
    torch.testing.assert_close(out.double(), want_out, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse.double(), want_lse, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("hd", [64, 120, 128])
def test_flash_attention_bwd_keeps_a_large_running_sum_exact(card, hd):
    """The backward over the same diffuse rows (S 2048, G 4, values near
    8): dq, dk and dv, summed over 2048 keys or 8192 (position, head)
    rows, held to the plain backward evaluated in float64 on the kernels'
    own out and lse."""
    gen = torch.Generator(device=card).manual_seed(hd + 1)
    S = 2048
    q = torch.randn(1, S, 16, hd, device=card, generator=gen) * 0.3
    k = torch.randn(1, S, 4, hd, device=card, generator=gen)
    v = torch.randn(1, S, 4, hd, device=card, generator=gen) + 8.0
    do = torch.randn(1, S, 16, hd, device=card, generator=gen)
    out, lse = fa.flash_attention_lse(q, k, v)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do)
    want = fa.flash_attention_bwd_plain(
        *(x.double() for x in (q, k, v, out, lse, do)))
    for name, a, b in zip("qkv", got, want):
        torch.testing.assert_close(a.double(), b, **BWD_TOL, msg=f"d{name}")


@pytest.mark.parametrize("mode", sorted(PREFILL_MODES))
@pytest.mark.parametrize("G", [1, 4, 5, 8, 16])
@pytest.mark.parametrize("hd", [64, 120, 128, 36])
def test_flash_attention_bwd_equals_plain(card, hd, G, mode):
    q, k, v, do, kw = _bwd_inputs(card, hd * 100 + G, mode, G, hd)
    out, lse = fa.flash_attention_lse_plain(q, k, v, **kw)
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    for name in ("delta", "dkdv", "dq"):
        key = f"flash_attention_bwd_{name}"
        assert fa.LAUNCHES[key] == before[key] + 1
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    for name, a, b in zip("qkv", got, want):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a, b, **BWD_TOL, msg=f"d{name}")
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    for a, b in zip(got, again):                 # no atomics: same bits
        assert torch.equal(a, b)


def test_autograd_on_the_card_goes_through_the_kernels(card):
    from repro_torch.models import layers as L

    q, k, v, do, kw = _bwd_inputs(card, 5, "window", 4, 64)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.reset_launches()
    out = L.flash_attention(*leaves, **kw)
    out.backward(do)
    assert {n: fa.LAUNCHES[n] for n in fa.LAUNCHES} == {
        "flash_attention": 0, "flash_attention_lse": 1,
        "flash_attention_bwd_delta": 1, "flash_attention_bwd_dkdv": 1,
        "flash_attention_bwd_dq": 1}
    o, lse = fa.flash_attention_lse_plain(q, k, v, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for t, w in zip(leaves, want):
        torch.testing.assert_close(t.grad, w, **BWD_TOL)


def test_flash_decode_at_the_vlm_cross_length(card):
    """The vlm's cross decode: one query over all T = 1600 frontend keys of
    llama-3.2-vision-90b's 64 / 8 heads of 128."""
    gen = torch.Generator(device=card).manual_seed(16)
    q = torch.randn(2, 64, 128, device=card, generator=gen)
    k, v = (torch.randn(2, 1600, 8, 128, device=card, generator=gen)
            for _ in range(2))
    _decode_close(fd.flash_decode(q, k, v, 1600),
                  fd.flash_decode_plain(q, k, v, 1600))


# ------------------------------------------------------------- the fabric
def test_hash_twins_on_the_card_equal_numpy(card):
    from repro_torch.core.fabric.routing import (flow_choices,
                                                 flow_choices_torch)
    from repro_torch.core.faults import (FaultConfig, FaultPlan,
                                         erase_fails_torch,
                                         nand_read_retries_torch)

    rng = np.random.default_rng(11)
    values = rng.integers(0, 2**64 - 1, 1 << 16, dtype=np.uint64,
                          endpoint=True)
    values[:3] = [2**63, 2**64 - 1, 2**63 - 1]
    bits = torch.from_numpy(values.view(np.int64)).to(card)
    for n in range(1, 17):
        got = flow_choices_torch("h1", "d2", bits, n)
        assert got.device.type == "cuda"
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      flow_choices("h1", "d2", values, n))
    plan = FaultPlan(FaultConfig(nand_read_retry_rate=0.35,
                                 nand_read_retry_max=3,
                                 erase_fail_rate=0.4), seed=2**63 + 5)
    statics = plan.nand_statics()
    cpu = bits.cpu()
    assert torch.equal(nand_read_retries_torch(statics, bits).cpu(),
                       nand_read_retries_torch(statics, cpu))
    assert torch.equal(erase_fails_torch(statics, bits).cpu(),
                       erase_fails_torch(statics, cpu))
    seq = torch.arange(300, device=card)
    assert nand_read_retries_torch(statics, seq).tolist() == [
        plan.nand_read_retries(i) for i in range(300)]


def test_congestion_estimator_on_the_card_equals_the_cpu(card):
    from repro_torch.core.fabric import Fabric
    from repro_torch.core.fabric.link_sim import LinkCongestionSim

    fab = Fabric.build("spine_leaf", num_hosts=4, num_devices=4,
                       num_leaves=2, num_spines=2, ecmp=True)
    hosts, devices = fab.topology.hosts, fab.topology.devices
    rng = np.random.default_rng(5)
    n = 1 << 18
    hi, di = rng.integers(0, 4, n), rng.integers(0, 4, n)
    nb = rng.integers(1, 5, n) * 64
    gpu = LinkCongestionSim(fab, hosts, devices)
    cpu = LinkCongestionSim(fab, hosts, devices, torch_device="cpu")
    assert gpu.routes.device.type == "cuda"
    a, b = gpu.estimate(hi, di, nb, 1e-4), cpu.estimate(hi, di, nb, 1e-4)
    assert a["bottleneck_link"] == b["bottleneck_link"]
    for key in ("link_utilization", "pair_slowdown", "pair_bytes"):
        np.testing.assert_allclose(a[key], b[key], rtol=1e-5)
    a = gpu.what_if_bandwidth(hi, di, nb, 1e-4, [0.5, 1.0, 2.0])
    b = cpu.what_if_bandwidth(hi, di, nb, 1e-4, [0.5, 1.0, 2.0])
    for key in ("max_link_utilization", "mean_pair_slowdown"):
        np.testing.assert_allclose(a[key], b[key], rtol=1e-5)


def test_fabric_mount_on_the_card_replays_as_the_bare_device(card):
    from repro_torch.core.fabric import Fabric
    from repro_torch.core.faults import FaultConfig, FaultPlan, install
    from repro_torch.core.replay.spec import ReplayUnsupported

    rng = np.random.default_rng(9)
    addrs = rng.integers(0, 256, 3000) * 4096 + rng.integers(0, 64, 3000) * 64
    writes = rng.random(3000) < 0.3

    def cached():
        return make_device("cxl-ssd-cache", cache_cfg=DRAMCacheConfig(
            capacity_bytes=64 * 4096))

    mount = Fabric.build("two_level", num_hosts=2, num_devices=2,
                         num_leaves=2).mount("h1", "d1", cached())
    before = ks.LAUNCHES["cache_sim_fused"]
    got = run_cuda(mount, addrs, writes, validate=True)
    assert ks.LAUNCHES["cache_sim_fused"] == before + 1
    want = run_cuda(cached(), addrs, writes, validate=True)
    for f in ("latency_ticks", "hit_flags", "evict_flags"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    install(FaultPlan(FaultConfig(link_retry_rate=0.25)), [mount])
    with pytest.raises(ReplayUnsupported, match="fault plan"):
        run_cuda(mount, addrs, writes)


# ------------------------------------------------------ the scan lane
SCAN_SCENARIOS = ([f"{d}@{a}" for d in ("dram", "cxl-dram", "pmem",
                                         "cxl-ssd", "cxl-ssd-cache")
                   for a in ("direct", "fabric")]
                  + ["dram@stream", "pmem@stream", "dram-qos@fabric",
                     "ssd-gc@direct"])


def _scan_both(dev_fn, trace, outstanding, posted=True, start=0,
               placed=None, chunk=None):
    """``replay_scan`` on the card and its plain twin on the CPU, from
    fresh states: every output and every final state tensor.  With
    ``placed`` or ``chunk`` given, the kernel runs under that layout
    (``placed=False``: every placed array in device memory) through
    ``call_launch``; else through the wrapper, one counted launch.
    Returns the stack's ``(cfg, params)`` and the twin's final state."""
    from repro_torch.core.replay import stack
    from repro_torch.core.replay.engine import ReplayEngine
    from repro_torch.core.replay.metrics import MetricsSpec
    from repro_torch.core.replay.spec import trace_to_arrays
    from repro_torch.kernels import _build
    from repro_torch.kernels import replay_scan as rs

    addrs, writes, size = trace_to_arrays(trace)
    cfg, params, routes, retries, _ = ReplayEngine(
        dev_fn(), outstanding=outstanding, posted_writes=posted,
        metrics=MetricsSpec()).prepare(addrs, size=size)
    routes = None if routes is None else torch.from_numpy(routes)
    retries = None if retries is None else torch.from_numpy(retries)
    a, w = torch.from_numpy(addrs), torch.from_numpy(writes)
    cpu_state = stack.init_state(cfg, "cpu")
    gpu_state = stack.init_state(cfg, "cuda")
    want = rs.replay_scan(cfg, params, cpu_state, a, w, routes,
                          start_tick=start, retries=retries)
    r = None if routes is None else routes.cuda()
    rt = None if retries is None else retries.cuda()
    if placed is None and chunk is None:
        before = rs.LAUNCHES["replay_scan"]
        got = rs.replay_scan(cfg, params, gpu_state, a.cuda(), w.cuda(), r,
                             start_tick=start, retries=rt)
        assert rs.LAUNCHES["replay_scan"] == before + 1
    else:
        lib = _build.library("replay_scan")
        lay = rs.layout(cfg, params, rs._smem_optin(lib, 0),
                        chunk=chunk or rs.CHUNK, placed=placed is not False)
        err, got = rs.call_launch(lib, cfg, params, gpu_state, a.cuda(),
                                  w.cuda(), r, start, lay,
                                  torch.cuda.current_stream().cuda_stream,
                                  retries=rt)
        assert err == 0
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), x)
    for part in ("media", "flash"):
        for k, x in (cpu_state[part] or {}).items():
            assert torch.equal(gpu_state[part][k].cpu(), x), (part, k)
    return (cfg, params), cpu_state


@pytest.mark.parametrize("name", SCAN_SCENARIOS)
def test_replay_scan_equals_its_twin_on_the_scenarios(card, name):
    from golden import scenarios as sc
    from test_torch_scenarios import make_target, scenario_trace

    (cfg, _), state = _scan_both(lambda: make_target(name),
                                 scenario_trace(name),
                                 sc.scenario_outstanding(name))
    if name == "ssd-gc@direct":
        assert cfg.gc and int(state["flash"]["gcs"]) > 0


# (policy, MSHR entries, writeback slots, outstanding, posted writes,
# frames): the CPU tests' hypothesis ranges, corners and middles
SCAN_SHAPES = [("lru", 1, 1, 1, True, 1), ("fifo", 4, 3, 32, False, 16),
               ("direct", 2, 2, 7, True, 8), ("lru", 3, 1, 33, False, 3),
               ("fifo", 1, 2, 2, True, 8), ("direct", 4, 3, 16, False, 16),
               ("lru", 2, 3, 32, True, 16), ("fifo", 3, 1, 5, False, 1)]


@pytest.mark.parametrize("policy,mshr,wb,outstanding,posted,frames",
                         SCAN_SHAPES)
def test_replay_scan_equals_its_twin_on_cache_shapes(card, policy, mshr, wb,
                                                     outstanding, posted,
                                                     frames):
    from repro_torch.core.workloads.traces import make_trace

    kw = dict(policy=policy, capacity_bytes=frames * 4096, mshr_entries=mshr,
              writeback_buffer=wb)
    _scan_both(lambda: make_device("cxl-ssd-cache",
                                   cache_cfg=DRAMCacheConfig(**kw)),
               make_trace(outstanding, n=600, pages=24, write_frac=0.5),
               outstanding, posted, start=777)


@pytest.mark.parametrize("device", ["dram", "cxl-dram", "pmem", "cxl-ssd",
                                    "cxl-ssd-cache"])
def test_replay_scan_equals_its_twin_at_table_i_width(card, device):
    from repro_torch.core.workloads.traces import make_trace

    _scan_both(lambda: make_device(device),
               make_trace(3, n=8000, pages=8192), 32)


def test_replay_scan_keeps_large_caches_in_device_memory(card):
    from repro_torch.core.workloads.traces import make_trace
    from repro_torch.kernels import _build
    from repro_torch.kernels import replay_scan as rs

    big = DRAMCacheConfig(capacity_bytes=32768 * 4096)     # 256 KB of frames
    (cfg, params), _ = _scan_both(
        lambda: make_device("cxl-ssd-cache", cache_cfg=big),
        make_trace(4, n=3000, pages=40000), 32)
    lay = rs.layout(cfg, params, rs._smem_optin(_build.library("replay_scan"),
                                                0))
    assert "frames" not in lay.in_smem and lay.smem_bytes <= 232448


@pytest.mark.parametrize("name", SCAN_SCENARIOS)
def test_replay_scan_device_memory_layout_equals_its_twin(card, name):
    from golden import scenarios as sc
    from test_torch_scenarios import make_target, scenario_trace

    _scan_both(lambda: make_target(name), scenario_trace(name),
               sc.scenario_outstanding(name), placed=False)


@pytest.mark.parametrize("device", ["cxl-ssd", "cxl-ssd-cache"])
@pytest.mark.parametrize("placed", [True, False])
def test_replay_scan_layouts_equal_the_twin_at_table_i_width(card, device,
                                                            placed):
    from repro_torch.core.workloads.traces import make_trace

    _scan_both(lambda: make_device(device),
               make_trace(0, n=(1 << 14) + 77, pages=16384), 32,
               placed=placed)


# (accesses, chunk): a trace that wraps the two staging buffers 125 times,
# one whose length is not a multiple of its chunk, one shorter than a chunk
SCAN_CHUNKS = [(2000, 16), (1001, 64), (5, 256)]


@pytest.mark.parametrize("n,chunk", SCAN_CHUNKS)
@pytest.mark.parametrize("placed", [True, False])
@pytest.mark.parametrize("device", ["pmem", "cxl-ssd-cache"])
def test_replay_scan_chunks_wrap_the_staging_ring(card, n, chunk, placed,
                                                  device):
    from repro_torch.core.workloads.traces import make_trace

    kw = dict(cache_cfg=DRAMCacheConfig(capacity_bytes=64 * 4096)) \
        if device == "cxl-ssd-cache" else {}
    _scan_both(lambda: make_device(device, **kw),
               make_trace(n, n=n, pages=200), 8, placed=placed, chunk=chunk)


def test_scan_lane_on_the_card_equals_the_python_lane(card):
    from test_torch_scenarios import ServiceTap
    from repro_torch.core.replay.metrics import MetricsSpec
    from repro_torch.core.workloads.driver import TraceDriver
    from repro_torch.core.workloads.traces import make_trace
    from repro_torch.kernels import replay_scan as rs

    trace = make_trace(8, n=5000, pages=2048)
    for device in ("dram", "cxl-ssd-cache"):
        tap = ServiceTap(make_device(device))
        TraceDriver(tap).run(trace)
        want = TraceDriver(make_device(device), metrics=MetricsSpec()).run(
            trace)
        before = rs.LAUNCHES["replay_scan"]
        got = TraceDriver(make_device(device), engine="scan",
                          metrics=MetricsSpec()).run(trace)
        assert rs.LAUNCHES["replay_scan"] == before + 1
        assert got.latency_ticks.tolist() == tap.latencies
        assert got.end_tick == want.end_tick
        assert got.metrics.to_jsonable() == want.metrics.to_jsonable()


def test_scan_lane_on_the_card_runs_faults_and_streaming(card):
    """A fault plan runs on the card in one launch, equal to the python
    lane, and streams in one launch a chunk, equal to the one-launch
    replay; what the lane refuses is a retry burst too long for its
    one-byte code and more LFB slots than the kernel has."""
    from repro_torch.core.fabric import Fabric
    from repro_torch.core.faults import FaultConfig, FaultPlan, install
    from repro_torch.core.replay.engine import ReplayEngine
    from repro_torch.core.replay.spec import ReplayUnsupported
    from repro_torch.core.workloads.driver import TraceDriver
    from repro_torch.core.workloads.traces import make_trace
    from repro_torch.kernels import replay_scan as rs

    def nand():
        dev = make_device("cxl-ssd-cache")
        install(FaultPlan(FaultConfig(nand_read_retry_rate=0.5,
                                      poison_rate=0.2)), [dev])
        return dev

    trace = make_trace(3, n=3000, pages=4096)
    want = TraceDriver(nand()).run(trace)
    before = rs.LAUNCHES["replay_scan"]
    got = ReplayEngine(nand()).run(trace)
    assert rs.LAUNCHES["replay_scan"] == before + 1
    assert (got.sum_latency_ticks, got.end_tick) == (want.sum_latency_ticks,
                                                     want.end_tick)
    assert got.poison_flags.any()
    fab = Fabric.build("two_level", num_hosts=2, num_devices=2, num_leaves=2)
    mount = fab.mount("h0", "d0", make_device("dram"))
    install(FaultPlan(FaultConfig(link_retry_rate=1.0, link_retry_max=1000),
                      seed=2), [mount])
    with pytest.raises(ReplayUnsupported, match="one-byte code"):
        ReplayEngine(mount).run(trace[:64])
    before = rs.LAUNCHES["replay_scan"]
    chunked = ReplayEngine(nand()).run(trace, chunk_size=1000)
    assert rs.LAUNCHES["replay_scan"] == before + 3
    assert chunked.latency_ticks.tolist() == got.latency_ticks.tolist()
    assert chunked.poison_flags.tolist() == got.poison_flags.tolist()
    with pytest.raises(ValueError, match="LFB slots"):
        ReplayEngine(make_device("dram"),
                     outstanding=rs.MAX_OUTSTANDING + 1).run([(0, 64, False)])


FAULTED = ["faults-linkretry@spine_leaf", "faults-portdown-failover@mesh",
           "faults-nand-retry@direct", "nand-gc/cxl-ssd-cache",
           "nand-gc/cxl-ssd", "link/cxl-dram", "down-ecmp/dram",
           "qos-retry/cxl-ssd-cache", "qos-retry-fixed/pmem"]


@pytest.mark.parametrize("placed", [None, False])
@pytest.mark.parametrize("name", FAULTED)
def test_replay_scan_equals_its_twin_under_faults(card, name, placed):
    from torch_scenarios import fault_case, make_target, scenario_trace

    if "@" in name:
        _scan_both(lambda: make_target(name), scenario_trace(name), 8,
                   placed=placed)
    else:
        _scan_both(lambda: fault_case(name)[0], fault_case(name)[1], 8,
                   placed=placed)


MULTI = ["multihost-qos-ecmp", "multihost-ssd-mounts", "multihost-ssd-pool",
         "multihost-ssd-sharedflash", "faults-portdown@multihost_x2",
         "faults-linkretry@spine_leaf_x4"]


def _multi_both(targets, traces, placed=None):
    """The multi-host instance on the card and its plain twin on the CPU,
    from fresh lanes: every output and every final state tensor.  With
    ``placed=False`` every placed array kind sits in device memory
    (through ``call_launch_multi``); else the wrapper launches once."""
    from repro_torch.core.replay import stack
    from repro_torch.core.replay.metrics import MetricsSpec
    from repro_torch.core.replay.multihost import MultiHostReplay
    from repro_torch.kernels import _build
    from repro_torch.kernels import replay_scan as rs

    prep = MultiHostReplay(targets, outstanding=8,
                           metrics=MetricsSpec()).prepare(traces)
    cfg = prep.cfg

    def t(x):
        return None if x is None else torch.from_numpy(x)

    ins = [t(x) for x in (prep.addrs, prep.writes, prep.lens, prep.devs,
                          prep.routes)]
    rt = t(prep.retries)
    cpu_state = stack.init_lanes(cfg.stack, cfg.num_devs, cfg.n_flash, "cpu")
    gpu_state = stack.init_lanes(cfg.stack, cfg.num_devs, cfg.n_flash,
                                 "cuda")
    want = rs.replay_multi(cfg, prep.params, cpu_state, *ins, retries=rt)
    gins = [None if x is None else x.cuda() for x in ins]
    grt = None if rt is None else rt.cuda()
    if placed is None:
        before = rs.LAUNCHES["replay_scan"]
        got = rs.replay_multi(cfg, prep.params, gpu_state, *gins,
                              retries=grt)
        assert rs.LAUNCHES["replay_scan"] == before + 1
    else:
        lib = _build.library("replay_scan")
        lay = rs.layout_multi(cfg, prep.params, rs._smem_optin(lib, 0),
                              placed=placed)
        assert placed or lay.in_smem == ()
        err, got = rs.call_launch_multi(
            lib, cfg, prep.params, gpu_state, *gins, 0, lay,
            torch.cuda.current_stream().cuda_stream, retries=grt)
        assert err == 0
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), x)
    for part in ("media", "flash"):
        for k, x in (cpu_state[part] or {}).items():
            assert torch.equal(gpu_state[part][k].cpu(), x), (part, k)
    return want


@pytest.mark.parametrize("placed", [None, False])
@pytest.mark.parametrize("name", MULTI)
def test_replay_multi_equals_its_twin(card, name, placed):
    from torch_scenarios import make_multi_targets, multi_traces

    _multi_both(make_multi_targets(name), multi_traces(name), placed)


# (case, shards) of the sharded instance: DRAM mounts at every portable
# cluster size and at 16, cached CXL-SSD with a private flash a host, QoS +
# ECMP, and the faulted spine-leaf
SHARDED = ([("shard/multipod-8", d) for d in (1, 2, 4, 8)]
           + [("shard/multipod-16", 16), ("shard/cxl-ssd-cache-4", 2),
              ("shard/cxl-ssd-cache-4", 4), ("shard/qos-8", 4),
              ("shard/qos-8", 8), ("faults-linkretry@spine_leaf_x4", 2),
              ("faults-linkretry@spine_leaf_x4", 4),
              ("shard/nand-2", 2), ("shard/transport-4", 4)])


@pytest.mark.parametrize("placed", [None, False])
@pytest.mark.parametrize("name,shards", SHARDED)
def test_replay_sharded_equals_its_twins(card, name, shards, placed):
    """The sharded instance (one cluster of ``shards`` CTAs) against its
    plain twin on the CPU and the one-CTA instance on the card: every
    output and every final state tensor, from fresh lanes."""
    from torch_scenarios import shard_case
    from repro_torch.core.replay import stack
    from repro_torch.core.replay.metrics import MetricsSpec
    from repro_torch.core.replay.multihost import MultiHostReplay
    from repro_torch.core.replay.spec import ReplayUnsupported
    from repro_torch.kernels import _build
    from repro_torch.kernels import replay_scan as rs

    targets, traces = shard_case(name)
    prep = MultiHostReplay(targets, outstanding=8,
                           metrics=MetricsSpec()).prepare(traces)
    cfg = prep.cfg

    def t(x, dev="cpu"):
        return None if x is None else torch.from_numpy(x).to(dev)

    cols = (prep.addrs, prep.writes, prep.lens, prep.devs, prep.routes)
    ins, gins = [t(x) for x in cols], [t(x, "cuda") for x in cols]
    rt, grt = t(prep.retries), t(prep.retries, "cuda")
    states = [stack.init_lanes(cfg.stack, cfg.num_devs, cfg.n_flash, d)
              for d in ("cpu", "cuda", "cuda")]
    want = rs.replay_sharded(cfg, shards, prep.params, states[0], *ins,
                             retries=rt)
    one = rs.replay_multi(cfg, prep.params, states[1], *gins, retries=grt)
    lib = _build.library("replay_scan")
    lay = rs.layout_multi(cfg, prep.params, rs._smem_optin(lib, 0),
                          shards=shards, placed=placed is None)
    active, largest = rs.sharded_fit(lib, cfg, prep.params, shards,
                                     lay.smem_bytes)
    if shards > largest or active < 1:
        with pytest.raises(ReplayUnsupported, match=f"{shards} CTAs"):
            rs.replay_sharded(cfg, shards, prep.params, states[2], *gins,
                              retries=grt)
        pytest.skip(f"a cluster of {shards} CTAs is not launchable here")
    if placed is None:
        before = rs.LAUNCHES["replay_scan"]
        got = rs.replay_sharded(cfg, shards, prep.params, states[2], *gins,
                                retries=grt)
        assert rs.LAUNCHES["replay_scan"] == before + 1
    else:
        assert lay.in_smem == ()
        err, got = rs.call_launch_sharded(
            lib, cfg, shards, prep.params, states[2], *gins, 0, lay,
            torch.cuda.current_stream().cuda_stream, retries=grt)
        assert err == 0
    torch.cuda.synchronize()
    for g, o, x in zip(got, one, want):
        assert torch.equal(g.cpu(), x) and torch.equal(o.cpu(), x)
    for part in ("media", "flash"):
        for k, x in (states[0][part] or {}).items():
            assert torch.equal(states[2][part][k].cpu(), x), (part, k)
            assert torch.equal(states[1][part][k].cpu(), x), (part, k)


@pytest.mark.parametrize("shards", [None, 1, 4, 8, 16])
def test_the_fleet_oracle_on_the_card(card, shards):
    """The results/BENCH_replay.json fleet (64 hosts x 1600 zipfian
    accesses on a 4 x 16 multi_pod, columns built on the card) through the
    sharded lane, and the repaired one-CTA lane (``None``)."""
    import json
    from pathlib import Path

    from repro_torch.core.fabric import Fabric
    from repro_torch.core.replay import (MetricsSpec, MultiHostReplay,
                                         ShardedMultiHostReplay)
    from repro_torch.data import WorkloadSpec, host_trace_np, host_trace_torch
    from repro_torch.kernels import replay_scan as rs

    root = Path(__file__).resolve().parents[1]
    want = json.loads((root / "results" / "BENCH_replay.json").read_text())[
        "fleet"]
    w = want["workload"]
    spec = WorkloadSpec(w["kind"], num_pages=w["num_pages"],
                        zipf_s=w["zipf_s"], write_frac=w["write_frac"])
    cols = [host_trace_torch(spec, w["seed"], h, want["accesses_per_host"])
            for h in range(want["hosts"])]
    for h, (a, wr) in enumerate(cols):
        na, nw = host_trace_np(spec, w["seed"], h, want["accesses_per_host"])
        assert np.array_equal(a.cpu().numpy(), na)
        assert np.array_equal(wr.cpu().numpy(), nw)
    addrs = torch.stack([a for a, _ in cols]).cpu().numpy()
    writes = torch.stack([x for _, x in cols]).cpu().numpy()
    fab = Fabric.build("multi_pod", forward_ns=10.0, rt_extra_ns=4.0,
                       num_pods=4, hosts_per_pod=16)
    tgts = [fab.mount(f"h{i}", f"d{i}", make_device("dram"))
            for i in range(64)]
    eng = (MultiHostReplay(tgts, outstanding=8, metrics=MetricsSpec())
           if shards is None else ShardedMultiHostReplay(
               tgts, outstanding=8, metrics=MetricsSpec(),
               devices=range(shards)))
    before = rs.LAUNCHES["replay_scan"]
    res = eng.run_arrays(addrs, writes)
    assert rs.LAUNCHES["replay_scan"] == before + 1
    assert res.elapsed_ticks == want["elapsed_ticks"]
    assert sum(r.sum_latency_ticks for r in res.per_host) == \
        want["sum_latency_ticks"]
    assert res.metrics.percentile_ticks(50) == want["p50_ticks"]
    assert res.metrics.percentile_ticks(99) == want["p99_ticks"]


def test_multi_host_lane_on_the_card_equals_the_python_lane(card):
    """Three Table I devices privately mounted, 3 x 4000 accesses: one
    launch, every host's latencies, the result and the metrics equal the
    python lane's; a pool view through TraceDriver's retry too."""
    from test_torch_scenarios import ServiceTap
    from repro_torch.core.fabric import Fabric, MemoryPool
    from repro_torch.core.replay.metrics import MetricsSpec
    from repro_torch.core.workloads.driver import MultiHostDriver, TraceDriver
    from repro_torch.core.workloads.traces import make_trace
    from repro_torch.kernels import replay_scan as rs

    def mounts():
        fab = Fabric.build("two_level", num_hosts=3, num_devices=3,
                           num_leaves=2)
        return [fab.mount(f"h{i}", f"d{i}", make_device("cxl-ssd-cache"))
                for i in range(3)]

    traces = [make_trace(30 + h, n=4000, pages=2048) for h in range(3)]
    taps = [ServiceTap(m) for m in mounts()]
    MultiHostDriver(taps).run(traces)
    want = MultiHostDriver(mounts(), metrics=MetricsSpec()).run(traces)
    before = rs.LAUNCHES["replay_scan"]
    got = MultiHostDriver(mounts(), engine="scan",
                          metrics=MetricsSpec()).run(traces)
    assert rs.LAUNCHES["replay_scan"] == before + 1
    for g, w, tap in zip(got.per_host, want.per_host, taps):
        assert g.latency_ticks.tolist() == tap.latencies
        assert (g.elapsed_ticks, g.end_tick) == (w.elapsed_ticks, w.end_tick)
    assert got.elapsed_ticks == want.elapsed_ticks
    assert got.metrics.to_jsonable() == want.metrics.to_jsonable()

    def view():
        fab = Fabric.build("two_level", num_hosts=2, num_devices=2,
                           num_leaves=2)
        return MemoryPool(fab, {"d0": make_device("dram"),
                                "d1": make_device("dram")}).view("h0")

    before = rs.LAUNCHES["replay_scan"]
    got = TraceDriver(view(), engine="scan").run(traces[0])
    assert rs.LAUNCHES["replay_scan"] == before + 1
    want = TraceDriver(view()).run(traces[0])
    assert (got.sum_latency_ticks, got.end_tick) == (want.sum_latency_ticks,
                                                     want.end_tick)


def test_assoc_lane_on_the_card_equals_the_host_solve(card):
    from repro_torch.core.maxplus import busy_until, port_busy_until
    from repro_torch.core.replay.assoc import AssocReplayEngine
    from repro_torch.core.workloads.traces import make_trace

    from repro_torch.core.replay.spec import ReplayUnsupported

    def outcome(**kw):
        try:
            res = AssocReplayEngine(make_device(device), **kw).run(trace)
        except ReplayUnsupported as e:
            return str(e)
        return res.latency_ticks.tolist(), res.end_tick

    trace = make_trace(5, n=20000, pages=4096)
    for device in ("dram", "cxl-dram", "pmem"):
        assert outcome() == outcome(torch_device="cpu"), device
    rng = np.random.default_rng(0)
    arr = np.sort(rng.integers(0, 10**6, 5000))
    svc = rng.integers(1, 500, 5000)
    act = rng.random(5000) < 0.6
    ports = rng.integers(0, 4, 5000)
    for fn, args in ((busy_until, (svc, act, 7)),
                     (port_busy_until, (svc, ports, 4))):
        want = fn(torch.from_numpy(arr), *[
            torch.from_numpy(x) if isinstance(x, np.ndarray) else x
            for x in args])
        got = fn(torch.from_numpy(arr).cuda(), *[
            torch.from_numpy(x).cuda() if isinstance(x, np.ndarray) else x
            for x in args])
        assert torch.equal(got.cpu(), want)


# ------------------------------------------------ the resumable replay
RESUMED = ["cxl-ssd-cache@direct", "dram@fabric", "ssd-gc@direct",
           "pmem@stream", "faults-nand-retry@direct",
           "faults-portdown-failover@mesh", "down-ecmp/dram",
           "qos-retry/cxl-ssd-cache", "nand-gc/cxl-ssd"]


def _target_and_trace(name):
    from torch_scenarios import (fault_case, make_target,
                                 scenario_outstanding, scenario_trace)

    if "@" in name:
        return (lambda: make_target(name)), scenario_trace(name), \
            scenario_outstanding(name)
    return (lambda: fault_case(name)[0]), fault_case(name)[1], 8


@pytest.mark.parametrize("placed", [None, False])
@pytest.mark.parametrize("chunk", [1, 37, 128])
@pytest.mark.parametrize("name", RESUMED)
def test_chunked_replay_scan_equals_one_launch_and_the_twin(card, name,
                                                            chunk, placed):
    """The trace in launches of ``chunk`` accesses through one carry (the
    wrapper, one counted launch each, or ``call_launch`` in the
    device-memory layout) equals the twin's one-call replay on every
    output and final state tensor, and the twin's chunked carry."""
    from repro_torch.core.replay import stack
    from repro_torch.core.replay.engine import ReplayEngine
    from repro_torch.core.replay.metrics import MetricsSpec
    from repro_torch.core.replay.spec import trace_to_arrays
    from repro_torch.kernels import _build
    from repro_torch.kernels import replay_scan as rs

    make, trace, outstanding = _target_and_trace(name)
    if chunk == 1:
        trace = trace[:150]
    addrs, writes, size = trace_to_arrays(trace)
    cfg, params, routes, retries, _ = ReplayEngine(
        make(), outstanding=outstanding,
        metrics=MetricsSpec()).prepare(addrs, size=size)
    cols = [None if x is None else torch.from_numpy(x)
            for x in (addrs, writes, routes, retries)]
    cpu_state = stack.init_state(cfg, "cpu")
    want = rs.replay_scan(cfg, params, cpu_state, *cols[:3],
                          retries=cols[3])
    twin_state = stack.init_state(cfg, "cpu")
    twin_carry = rs.new_carry(cfg, params, "cpu")
    gpu_state = stack.init_state(cfg, "cuda")
    carry = rs.new_carry(cfg, params, "cuda")
    lib = _build.library("replay_scan")
    lay = rs.layout(cfg, params, rs._smem_optin(lib, 0), placed=False)
    outs = []
    before = rs.LAUNCHES["replay_scan"]
    for lo in range(0, len(trace), chunk):
        part = [None if x is None else x[lo:lo + chunk].contiguous()
                for x in cols]
        gpart = [None if x is None else x.cuda() for x in part]
        if placed is None:
            outs.append(rs.replay_scan(cfg, params, gpu_state, *gpart[:3],
                                       retries=gpart[3], carry=carry))
        else:
            err, out = rs.call_launch(
                lib, cfg, params, gpu_state, *gpart[:3], 0, lay,
                torch.cuda.current_stream().cuda_stream, retries=gpart[3],
                carry=carry)
            assert err == 0
            outs.append(out)
        rs.replay_scan(cfg, params, twin_state, *part[:3], retries=part[3],
                       carry=twin_carry)
    if placed is None:
        assert rs.LAUNCHES["replay_scan"] - before == -(-len(trace) // chunk)
    torch.cuda.synchronize()
    for i in range(3):
        assert torch.equal(torch.cat([o[i] for o in outs]).cpu(), want[i])
    for i in (3, 4):
        assert torch.equal(outs[-1][i].cpu(), want[i])
    for part in ("media", "flash"):
        for k, x in (cpu_state[part] or {}).items():
            assert torch.equal(gpu_state[part][k].cpu(), x), (part, k)
    assert torch.equal(carry.words.cpu(), twin_carry.words)
    assert torch.equal(carry.maps.cpu(), twin_carry.maps)


@pytest.mark.parametrize("placed", [None, False])
@pytest.mark.parametrize("width", [1, 9, 64])
@pytest.mark.parametrize("name", MULTI)
def test_chunked_replay_multi_equals_one_launch(card, name, width, placed):
    """The multi-host instance over each host's window from its cursor,
    launch after launch through one carry, equals the twin's one-call
    replay on every output and final state tensor."""
    from torch_scenarios import make_multi_targets, multi_traces
    from repro_torch.core.replay import stack
    from repro_torch.core.replay.metrics import MetricsSpec
    from repro_torch.core.replay.multihost import MultiHostReplay
    from repro_torch.kernels import _build
    from repro_torch.kernels import replay_scan as rs

    prep = MultiHostReplay(make_multi_targets(name), outstanding=8,
                           metrics=MetricsSpec()).prepare(multi_traces(name))
    cfg = prep.cfg

    def t(x):
        return None if x is None else torch.from_numpy(x)

    cpu_state = stack.init_lanes(cfg.stack, cfg.num_devs, cfg.n_flash, "cpu")
    want = rs.replay_multi(cfg, prep.params, cpu_state, *(t(x) for x in (
        prep.addrs, prep.writes, prep.lens, prep.devs, prep.routes)),
        retries=t(prep.retries))
    gpu_state = stack.init_lanes(cfg.stack, cfg.num_devs, cfg.n_flash,
                                 "cuda")
    carry = rs.new_multi_carry(cfg, prep.params, "cuda")
    lib = _build.library("replay_scan")
    lay = rs.layout_multi(cfg, prep.params, rs._smem_optin(lib, 0),
                          placed=False)
    total, outs = int(prep.lens.sum()), []
    lens = t(prep.lens).cuda()
    while carry.seen < total:
        base = rs.cursors(carry, cfg.num_hosts)
        win = []
        for x in (prep.addrs, prep.writes, prep.devs, prep.routes,
                  prep.retries):
            if x is None:
                win.append(None)
                continue
            w = np.zeros((x.shape[0], width) + x.shape[2:], x.dtype)
            for i, b in enumerate(base):
                e = min(int(b) + width, int(prep.lens[i]))
                w[i, :max(e - int(b), 0)] = x[i, int(b):e]
            win.append(torch.from_numpy(w).cuda())
        a, w_, d, r, rt = win
        if placed is None:
            outs.append(rs.replay_multi(cfg, prep.params, gpu_state, a, w_,
                                        lens, d, r, retries=rt, carry=carry,
                                        base=base))
        else:
            n = rs._check_multi(cfg, prep.params, gpu_state, a, w_, lens, d,
                                r, rt, carry, base)
            err, out = rs.call_launch_multi(
                lib, cfg, prep.params, gpu_state, a, w_, lens, d, r, 0, lay,
                torch.cuda.current_stream().cuda_stream, retries=rt, n=n,
                carry=carry)
            assert err == 0
            outs.append(out)
    assert len(outs) == -(-total // width)
    torch.cuda.synchronize()
    for i in range(4):
        assert torch.equal(torch.cat([o[i] for o in outs]).cpu(), want[i])
    for part in ("media", "flash"):
        for k, x in (cpu_state[part] or {}).items():
            assert torch.equal(gpu_state[part][k].cpu(), x), (part, k)


def test_streamed_lanes_on_the_card_equal_the_one_shot(card, tmp_path):
    """run_arrays(chunk_size=), return_latencies=False, replay_stream (with
    a crash and a resume) and the chunked multi-host replay launch once a
    chunk on the card and equal the one-launch replay."""
    import json

    from torch_scenarios import make_multi_targets, multi_traces
    from repro_torch.core.replay import replay_stream
    from repro_torch.core.replay.engine import ReplayEngine
    from repro_torch.core.replay.metrics import MetricsSpec
    from repro_torch.core.replay.multihost import MultiHostReplay
    from repro_torch.core.workloads.traces import make_trace
    from repro_torch.data import TraceStore
    from repro_torch.kernels import replay_scan as rs

    def jm(b):
        return json.dumps(b.to_jsonable(), sort_keys=True)

    trace = make_trace(7, n=5000, pages=8192)
    spec = MetricsSpec()
    want = ReplayEngine(make_device("cxl-ssd-cache"), metrics=spec).run(trace)
    for chunk, lat in ((512, True), (1000, False)):
        before = rs.LAUNCHES["replay_scan"]
        got = ReplayEngine(make_device("cxl-ssd-cache"), metrics=spec).run(
            trace, chunk_size=chunk, return_latencies=lat)
        assert rs.LAUNCHES["replay_scan"] - before == -(-5000 // chunk)
        assert (got.sum_latency_ticks, got.end_tick) == (
            want.sum_latency_ticks, want.end_tick)
        assert jm(got.metrics) == jm(want.metrics)
        if lat:
            assert got.latency_ticks.tolist() == want.latency_ticks.tolist()
    store = TraceStore.from_trace(tmp_path / "t.store", trace)
    got = replay_stream(store, make_device("cxl-ssd-cache"), chunk_size=700,
                        metrics=spec, checkpoint_dir=str(tmp_path / "ck"),
                        checkpoint_every=2)
    assert got.latency_ticks.tolist() == want.latency_ticks.tolist()
    stats = {}
    got = replay_stream(store, make_device("cxl-ssd-cache"), chunk_size=700,
                        metrics=spec, checkpoint_dir=str(tmp_path / "ck"),
                        resume=True, stats=stats)
    assert stats["resumed_from"] == 4200
    assert got.latency_ticks.tolist() == want.latency_ticks.tolist()
    assert jm(got.metrics) == jm(want.metrics)
    name = "multihost-ssd-mounts"
    one, lat0 = MultiHostReplay(make_multi_targets(name),
                                metrics=spec).run_recorded(multi_traces(name))
    before = rs.LAUNCHES["replay_scan"]
    res, lat = MultiHostReplay(make_multi_targets(name),
                               metrics=spec).run_recorded(
        multi_traces(name), chunk_size=50)
    steps = sum(len(t) for t in multi_traces(name))
    assert rs.LAUNCHES["replay_scan"] - before == -(-steps // 50)
    assert [x.tolist() for x in lat] == [x.tolist() for x in lat0]
    bounded = MultiHostReplay(make_multi_targets(name), metrics=spec).run(
        multi_traces(name), chunk_size=50, return_latencies=False)
    assert jm(bounded.metrics) == jm(one.metrics)


# ------------------------------------------------------------- the sweeps
SWEEPS = ["sweep/table1", "sweep/per-lane", "sweep/nand-gc"]
MULTI_SWEEPS = ["hosts/multihost-qos-ecmp", "hosts/multihost-ssd-mounts",
                "hosts/multi/nand-shared", "seeds/spine-leaf"]


def _states_equal(got, want):
    for part in ("media", "flash"):
        for k, x in (want[part] or {}).items():
            assert torch.equal(got[part][k].cpu(), x), (part, k)


@pytest.mark.parametrize("placed", [None, False])
@pytest.mark.parametrize("name", SWEEPS)
def test_replay_sweep_equals_its_twin(card, name, placed):
    """The single-host sweep instance (one block a lane) against its twin
    on the emulation's cases: every lane's outputs and final state."""
    from test_torch_scan_emulate import _sweep_case

    from repro_torch.core.replay import stack
    from repro_torch.core.replay.sweep import cache_lanes
    from repro_torch.kernels import _build
    from repro_torch.kernels import replay_scan as rs

    dev, addrs, writes, caps, lrus, over = _sweep_case(name)
    cfg, lanes = cache_lanes(dev, addrs, writes, capacity_frames=caps,
                             is_lru=lrus, timing_overrides=over,
                             outstanding=8)
    a, w = torch.from_numpy(addrs), torch.from_numpy(writes)
    cpu = stack.init_sweep(cfg, caps)
    want = rs.replay_sweep(cfg, lanes, cpu, a, w)
    gpu = stack.init_sweep(cfg, caps, "cuda")
    if placed is None:
        before = rs.LAUNCHES["replay_scan"]
        got = rs.replay_sweep(cfg, lanes, gpu, a.cuda(), w.cuda())
        assert rs.LAUNCHES["replay_scan"] == before + 1
    else:
        lib = _build.library("replay_scan")
        lay = rs.sweep_layout(cfg, lanes, rs._smem_optin(lib, 0),
                              placed=False)
        assert lay.in_smem == ()
        err, got = rs.call_launch_sweep(
            lib, cfg, lanes, gpu, a.cuda(), w.cuda(), lay,
            torch.cuda.current_stream().cuda_stream)
        assert err == 0
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), x)
    _states_equal(gpu, cpu)


@pytest.mark.parametrize("placed", [None, False])
@pytest.mark.parametrize("name", MULTI_SWEEPS)
def test_replay_multi_sweep_equals_its_twin(card, name, placed):
    """The multi-host sweep instance against its twin: host-count lanes
    (an empty one among them) and fault-seed lanes over a union path
    table."""
    from test_torch_scan_emulate import _multi_sweep_inputs

    from repro_torch.core.replay import stack
    from repro_torch.kernels import _build
    from repro_torch.kernels import replay_scan as rs

    prep, params, lens, routes, retries, _ = _multi_sweep_inputs(name)
    cfg = prep.cfg

    def t(x, where="cpu"):
        return None if x is None else torch.from_numpy(
            np.ascontiguousarray(x)).to(where)

    cols = (prep.addrs, prep.writes, lens, prep.devs, routes)
    B = lens.shape[0]
    cpu = stack.init_multi_sweep(cfg.stack, B, cfg.num_devs, cfg.n_flash)
    want = rs.replay_multi_sweep(cfg, params, cpu, *(t(x) for x in cols),
                                 retries=t(retries))
    gpu = stack.init_multi_sweep(cfg.stack, B, cfg.num_devs, cfg.n_flash,
                                 "cuda")
    gins = [t(x, "cuda") for x in cols]
    if placed is None:
        before = rs.LAUNCHES["replay_scan"]
        got = rs.replay_multi_sweep(cfg, params, gpu, *gins,
                                    retries=t(retries, "cuda"))
        assert rs.LAUNCHES["replay_scan"] == before + 1
    else:
        lib = _build.library("replay_scan")
        lay = rs.layout_multi(cfg, params, rs._smem_optin(lib, 0),
                              placed=False)
        err, got = rs.call_launch_multi_sweep(
            lib, cfg, params, gpu, *gins, lay,
            torch.cuda.current_stream().cuda_stream,
            retries=t(retries, "cuda"))
        assert err == 0
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), x)
    _states_equal(gpu, cpu)


def test_sweeps_on_the_card_equal_their_cpu_runs(card):
    """``cache_design_sweep``, ``host_count_sweep`` and
    ``fault_seed_sweep`` on the card (one launch each) equal the same
    calls with ``torch_device="cpu"``, field for field."""
    import json

    from test_torch_sweep import (CACHE_ADDRS, CACHE_WRITES, CAPS,
                                  HOST_COUNTS, HOST_TRACES, LRUS, P,
                                  SEED_TRACES, SEEDS, cache_device,
                                  cached_pool, seed_targets)

    from repro_torch.core.replay import sweep as sw
    from repro_torch.kernels import replay_scan as rs

    def both(fn, *a, **kw):
        before = rs.LAUNCHES["replay_scan"]
        got = fn(*a, **kw)
        assert rs.LAUNCHES["replay_scan"] == before + 1
        return got, fn(*a, torch_device="cpu", **kw)

    got, want = both(lambda **kw: sw.cache_design_sweep(
        cache_device(P), CACHE_ADDRS, CACHE_WRITES, capacity_frames=CAPS,
        is_lru=LRUS, **kw))
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    got, want = both(lambda **kw: sw.host_count_sweep(
        cached_pool(P), HOST_TRACES["cached_pool"], HOST_COUNTS, **kw))
    assert [(g.elapsed_ticks, [vars(r) for r in g.per_host]) for g in got] \
        == [(x.elapsed_ticks, [vars(r) for r in x.per_host]) for x in want]
    got, want = both(lambda **kw: sw.fault_seed_sweep(
        lambda s: seed_targets(P, s), SEED_TRACES, SEEDS, outstanding=8,
        **kw))
    for g, x in zip(got, want):
        assert np.array_equal(g["latency_ticks"], x["latency_ticks"])
        assert json.dumps(g["availability"], sort_keys=True) == json.dumps(
            x["availability"], sort_keys=True)
        assert g["fault_stats"] == x["fault_stats"]
        assert g["result"].elapsed_ticks == x["result"].elapsed_ticks


# ------------------------------------------------- serving on a mesh
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("n_local", [0, 1, 17, 32])
def test_a_shards_partial_on_the_card_is_the_plain_partial(card, n_local,
                                                          int8):
    """The sequence-sharded decode's local partial: the kernel (float32 or
    its int8 instance) on the shard's first ``n_local`` slots against the
    reference's plain partial; an empty shard launches nothing and weighs
    0 in the merge."""
    from repro_torch.distributed import decode as D

    gen = torch.Generator(device=card).manual_seed(n_local)
    q = torch.randn((2, 32, 120), generator=gen, device=card)
    kc, vc = (torch.randn((2, 32, 8, 120), generator=gen, device=card)
              for _ in range(2))
    scales = ()
    if int8:
        ks, vs = (torch.rand((2, 32, 8), generator=gen, device=card)
                  .mul_(0.02).half() for _ in range(2))
        kc, vc = ((t * 40).round().clamp(-127, 127).to(torch.int8)
                  for t in (kc, vc))
        scales = (ks, vs)
    fd.reset_launches()
    out, m, l = D.local_partial(q, kc, vc, n_local, *scales)
    name = "flash_decode_int8" if int8 else "flash_decode"
    assert fd.LAUNCHES[name] == (1 if n_local else 0)
    if n_local == 0:
        assert not out.any() and not l.any() and bool((m == -1e30).all())
        return
    k_eff = fd.dequantize(kc, scales[0]) if int8 else kc
    v_eff = fd.dequantize(vc, scales[1]) if int8 else vc
    wo, wm, wl = D._partial_attn(q, k_eff, v_eff, n_local)
    torch.testing.assert_close(out, wo, atol=2e-5, rtol=0)
    torch.testing.assert_close(m, wm, atol=1e-5, rtol=0)
    torch.testing.assert_close(l, wl, atol=0, rtol=1e-4)


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "mixtral-8x7b"])
def test_sharded_serve_on_one_card_matches_the_one_device_decode(card, arch,
                                                                tmp_path):
    """Four ranks on the one card (gloo, a 2 x 2 mesh) serve a reduced
    model through the kernel: logits within 1e-4 x max(1, |logit|) of the
    one-device decode with equal argmax, launches only where a shard
    holds a valid slot."""
    import torch_mesh_ranks as R
    from repro_torch.distributed.decode import shard_fill
    from repro_torch.launch.mesh import run_local_ranks
    from repro_torch.models import transformer as T

    steps = 12
    cfg = get_arch(arch).reduced()
    params = init_params(cfg, 0)
    state = T.init_decode_state(params, cfg, R.SERVE["batch"],
                                R.SERVE["context"])
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (steps, R.SERVE["batch"])))
    want = []
    for t in range(steps):
        lg, state = T.decode_step(params, cfg, state, tokens[t].cuda())
        want.append(lg.cpu())
    want = torch.stack(want)
    ranks = {(r["coords"]["data"], r["coords"]["model"]): r
             for r in run_local_ranks(R.serve_card, 4, tmp_path,
                                      args=(arch, steps), timeout_s=300)}
    got = torch.cat([ranks[(d, 0)]["logits"] for d in range(2)], dim=1)
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, atol=tol, rtol=0)
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    ring = T.kv_cache_len(cfg, R.SERVE["context"])
    for (d, t), r in ranks.items():
        pairs = sum(shard_fill(c, ring, 2, t) >= 1 for c in range(steps))
        assert r["launches"]["flash_decode"] == pairs * cfg.n_layers


def test_mesh_train_on_one_card_matches_the_one_device_step(card, tmp_path):
    """``[mesh-train]`` (a) at two layers: four ranks on the one card
    (gloo, data 2 x model 2) train reduced minicpm-2b through the
    ``lse`` instance and the backward kernels on each rank's heads: step
    1's gathered gradients within 1e-4 of each leaf's largest |value| of
    the one-device gradients, three steps' losses within 1e-5 relative,
    ``lse`` 2 and each backward kernel 1 launch a layer a step a rank."""
    import torch_mesh_ranks as R
    from repro_torch.distributed import step as S
    from repro_torch.launch.mesh import run_local_ranks
    from repro_torch.optim import adamw as A
    from repro_torch.optim.schedules import wsd_schedule
    from repro_torch.tree import tree_paths

    torch.backends.cuda.matmul.allow_tf32 = False
    steps = 3
    cfg = R.case_config("minicpm-2b")
    params = init_params(cfg, 0)
    batch = {k: v.cuda() for k, v in R.pod_batch(cfg).items()}
    _, grads = S.make_grad_fn(cfg)(params, batch)
    step = S.make_train_step(cfg, lr_fn=wsd_schedule(1e-3, 2, 5, 5))
    opt, losses = A.adamw_init(params), []
    for t in range(steps):
        params, opt, loss = step(params, opt, batch, t)
        losses.append(float(loss))
    ranks = run_local_ranks(R.train_card, 4, tmp_path, args=(steps,),
                            timeout_s=300)
    for r in ranks:
        for (path, g), (_, w) in zip(tree_paths(r["grads"]),
                                     tree_paths(grads)):
            tol = 1e-4 * float(w.abs().max())
            assert float((g - w.cpu()).abs().max()) <= tol, path
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5, atol=0)
        per = steps * cfg.n_layers
        assert r["launches"] == {"flash_attention": 0,
                                 "flash_attention_lse": 2 * per,
                                 "flash_attention_bwd_delta": per,
                                 "flash_attention_bwd_dkdv": per,
                                 "flash_attention_bwd_dq": per}
