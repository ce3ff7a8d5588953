"""The port's TieredStore against the JAX package's, on the CPU.

Both stores run the same seeded operations: the counters, the simulated
CXL-SSD clock (``sim_ticks``), every page returned and every capacity page
must be equal, exactly.  The port's store runs with
``torch_device="cpu"`` (its page kernels' plain versions), the JAX store
with its Pallas page kernels in interpret mode.  The last test computes,
with the JAX store, the tiered counters of ``chip_smoke.py``'s full-width
serving run, which depend on the archive schedule and the page size only,
and holds the script's pinned constants against them.
"""

import importlib.util

import numpy as np
import pytest

from repro.core.devices import make_device as jax_make_device
from repro.tiered.store import TieredStore as JaxStore
from repro.tiered.store import TieredStoreConfig as JaxConfig
from repro_torch.core.devices import make_device
from repro_torch.tiered.store import TieredStore, TieredStoreConfig
from test_torch_reference import REPO

POLICIES = ["lru", "fifo", "2q", "lfru", "direct"]
SHAPE = (2, 3, 4)


def _pair(policy, hbm=4, pages=24, backing=True):
    kw = dict(n_logical_pages=pages, page_shape=SHAPE, hbm_pages=hbm,
              policy=policy)
    ours = TieredStore(TieredStoreConfig(**kw),
                       backing=make_device("cxl-ssd") if backing else None,
                       torch_device="cpu")
    theirs = JaxStore(JaxConfig(**kw),
                      backing=jax_make_device("cxl-ssd") if backing else None)
    return ours, theirs


def _same(ours, theirs):
    assert ours.stats == theirs.stats
    assert ours.sim_ticks == theirs.sim_ticks
    assert ours.hit_rate == theirs.hit_rate
    for lpn in range(ours.cfg.n_logical_pages):
        np.testing.assert_array_equal(ours.capacity_page(lpn),
                                      theirs.capacity_page(lpn))


def _zipf_ops(seed, n_ops=120, pages=24):
    """A seeded mix of reads (with repeats inside one request), writes,
    write-through writes and dirty updates over Zipf-skewed pages."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, pages + 1) ** 1.1
    p = w / w.sum()
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(["read", "write", "through", "update"],
                          p=[0.55, 0.2, 0.1, 0.15])
        lpns = [int(x) for x in rng.choice(pages, size=rng.integers(1, 4),
                                           p=p)]
        data = rng.standard_normal(SHAPE).astype(np.float32)
        ops.append((kind, lpns, data))
    return ops


@pytest.mark.parametrize("policy", POLICIES)
def test_store_matches_jax_on_a_zipf_schedule(policy):
    ours, theirs = _pair(policy)
    for kind, lpns, data in _zipf_ops(11):
        if kind == "read":
            np.testing.assert_array_equal(
                ours.read_pages(lpns).numpy(),
                np.asarray(theirs.read_pages(lpns)))
        elif kind in ("write", "through"):
            ours.write_page(lpns[0], data, through=kind == "through")
            theirs.write_page(lpns[0], data, through=kind == "through")
        else:
            ours.update_page(lpns[0], data)
            theirs.update_page(lpns[0], data)
        assert ours.stats == theirs.stats
        assert ours.sim_ticks == theirs.sim_ticks
    ours.flush()
    theirs.flush()
    _same(ours, theirs)
    assert ours.stats["writebacks"] > 0 and ours.stats["hits"] > 0


def test_duplicate_slot_fills_keep_the_last_page():
    """With one pool page, both misses of one request land in slot 0 and
    the last fill wins: the reference returns page 1 for both."""
    ours, theirs = _pair("lru", hbm=1, pages=4)
    for store in (ours, theirs):
        store.write_page(0, np.full(SHAPE, 1.0, np.float32))
        store.write_page(1, np.full(SHAPE, 2.0, np.float32))
    got = ours.read_pages([0, 1]).numpy()
    want = np.asarray(theirs.read_pages([0, 1]))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.full((2,) + SHAPE, 2.0))
    _same(ours, theirs)


def test_dirty_page_evicted_by_a_fill_is_written_back_first():
    ours, theirs = _pair("lru", hbm=1, pages=4)
    for store in (ours, theirs):
        store.update_page(0, np.full(SHAPE, 5.0, np.float32))   # dirty
        store.write_page(2, np.full(SHAPE, 3.0, np.float32))
    np.testing.assert_array_equal(ours.read_pages([1, 2]).numpy(),
                                  np.asarray(theirs.read_pages([1, 2])))
    np.testing.assert_array_equal(ours.capacity_page(0),
                                  np.full(SHAPE, 5.0))
    _same(ours, theirs)


def test_store_without_backing_and_without_writeback():
    ours, theirs = _pair("fifo", hbm=2, backing=False)
    for kind, lpns, data in _zipf_ops(5, n_ops=40):
        if kind == "update":
            ours.update_page(lpns[0], data)
            theirs.update_page(lpns[0], data)
        else:
            np.testing.assert_array_equal(ours.read_pages(lpns).numpy(),
                                          np.asarray(theirs.read_pages(lpns)))
    _same(ours, theirs)
    assert ours.sim_ticks == 0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_tiered_pins_come_from_the_jax_store():
    """The archive schedule of the JAX serve driver (``repro.launch.serve``)
    at chip_smoke's full-width settings, with the JAX store at the real
    page shape; page contents do not move the counters, so zeros stand in
    for the K segments."""
    from repro.configs import get_arch

    smoke = _chip_smoke()
    s = smoke.SERVE
    cfg = get_arch(s["arch"])
    kpt, batch = s["kv_page_tokens"], s["batch"]
    ring = min(s["context"], cfg.swa_window)
    n_kv_pages = max(s["context"] // kpt * 4, 8)
    store = JaxStore(
        JaxConfig(n_logical_pages=n_kv_pages,
                  page_shape=(cfg.n_layers, batch, kpt, cfg.n_kv_heads,
                              cfg.resolved_head_dim),
                  hbm_pages=max(n_kv_pages // 4, 2), policy=s["policy"]),
        backing=jax_make_device("cxl-ssd"))
    page = np.zeros(store.cfg.page_shape, np.float32)
    rng = np.random.default_rng(s["seed"])
    rng.integers(0, cfg.vocab, (batch,))              # the first tokens
    for step in range(s["prompt_len"] + s["gen"]):
        if (step + 1) % kpt == 0:
            seg = (step + 1) // kpt - 1
            lo = (seg * kpt) % ring
            if lo + kpt <= ring:
                store.write_page(seg % n_kv_pages, page)
                if seg > 2:
                    picks = rng.integers(0, seg, size=2) % n_kv_pages
                    store.read_pages(list(picks))
    got = dict(store.stats, sim_ticks=store.sim_ticks)
    assert got == smoke.TIERED_PIN
    assert store.page_bytes == 5_898_240 and store.cfg.hbm_pages == 32
