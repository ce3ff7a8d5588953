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
