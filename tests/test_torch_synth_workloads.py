"""The port's seeded synthetic fleet workloads
(``repro_torch.data.workloads``) against the JAX package's
``repro.data.workloads``, which imports cleanly and runs in-process.

The port's scalar oracle (``access_at``), numpy twin (``host_trace_np``)
and torch twin (``host_trace_torch``, on the CPU here) equal the
reference's ``access_at`` and ``host_trace_np`` bit for bit over the four
kinds, hypothesis-drawn seeds, hosts and shapes; ``traces_np`` and
``make_traces`` agree with each other and with the reference's; the CDF is
the reference's; and ``WorkloadSpec`` refuses what the reference refuses,
word for word."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.data import workloads as ref
from repro_torch.data import workloads as port

KINDS = list(port.WORKLOAD_KINDS)

specs = st.builds(
    dict,
    kind=st.sampled_from(KINDS),
    num_pages=st.integers(17, 5000),
    line_offsets=st.sampled_from([1, 7, 64]),
    write_frac=st.sampled_from([0.0, 0.3, 0.77, 1.0]),
    zipf_s=st.sampled_from([0.6, 1.0, 1.1, 2.0]),
    hot_frac=st.sampled_from([0.0, 0.5, 0.9, 1.0]),
    hot_pages=st.integers(0, 16),
    on_len=st.integers(1, 50),
    off_len=st.integers(0, 80),
    cold_stride=st.integers(1, 40),
    stride_pages=st.integers(1, 9))
seeds = st.integers(0, 2**63 - 1)
hosts = st.integers(0, 2**20)


def both(kw):
    return port.WorkloadSpec(**kw), ref.WorkloadSpec(**kw)


def test_the_constants_are_the_references():
    assert port.WORKLOAD_KINDS == ref.WORKLOAD_KINDS
    assert (port.SALT_PAGE, port.SALT_GATE, port.SALT_OFF,
            port.SALT_WRITE) == (ref.SALT_PAGE, ref.SALT_GATE, ref.SALT_OFF,
                                 ref.SALT_WRITE)


@pytest.mark.parametrize("n,s", [(2, 1.0), (1024, 1.1), (4096, 0.5)])
def test_the_zipf_cdf_is_the_references(n, s):
    np.testing.assert_array_equal(port.zipf_cdf(n, s), ref.zipf_cdf(n, s))


@settings(max_examples=40, deadline=None)
@given(specs, seeds, hosts, st.integers(1, 700))
def test_numpy_and_torch_twins_equal_the_references(kw, seed, host, n):
    p, r = both(kw)
    a, w = port.host_trace_np(p, seed, host, n)
    ra, rw = ref.host_trace_np(r, seed, host, n)
    assert a.dtype == ra.dtype == np.int64 and w.dtype == rw.dtype == bool
    np.testing.assert_array_equal(a, ra)
    np.testing.assert_array_equal(w, rw)
    ta, tw = port.host_trace_torch(p, seed, host, n, torch_device="cpu")
    assert ta.dtype == torch.int64 and tw.dtype == torch.bool
    np.testing.assert_array_equal(ta.numpy(), a)
    np.testing.assert_array_equal(tw.numpy(), w)


@settings(max_examples=25, deadline=None)
@given(specs, seeds, hosts, st.integers(0, 10**6))
def test_the_scalar_oracle_equals_the_references(kw, seed, host, i):
    p, r = both(kw)
    got = port.access_at(p, seed, host, i)
    assert got == ref.access_at(r, seed, host, i)
    a, w = port.host_trace_np(p, seed, host, i + 1)
    assert (int(a[i]), bool(w[i])) == got


@pytest.mark.parametrize("kind", KINDS)
def test_each_kind_at_the_fleet_oracles_shape(kind):
    # the BENCH_replay.json fleet workload's footprint and skew, 64 hosts
    p, r = both(dict(kind=kind, num_pages=1024, zipf_s=1.1))
    for host in (0, 1, 31, 63):
        a, w = port.host_trace_torch(p, 23, host, 1600, torch_device="cpu")
        ra, rw = ref.host_trace_np(r, 23, host, 1600)
        np.testing.assert_array_equal(a.numpy(), ra)
        np.testing.assert_array_equal(w.numpy(), rw)


def test_the_torch_twin_reaches_every_zipf_rank_edge():
    # a u of exactly a CDF value must take numpy's side="right" rank
    p = port.WorkloadSpec("zipfian", num_pages=3, zipf_s=1.0)
    cdf = torch.from_numpy(port.zipf_cdf(3, 1.0))
    u = cdf.clone()
    right = torch.searchsorted(cdf, u, right=True)
    np.testing.assert_array_equal(
        right.numpy(), np.searchsorted(cdf.numpy(), u.numpy(), side="right"))
    a, _ = port.host_trace_torch(p, 5, 0, 2000, torch_device="cpu")
    assert set((a.numpy() // 4096).tolist()) == {0, 1, 2}


@pytest.mark.parametrize("kind", KINDS)
def test_traces_np_and_make_traces_agree(kind):
    kw = dict(kind=kind, num_pages=96, hot_frac=0.8, hot_pages=12,
              zipf_s=1.1)
    p, r = both(kw)
    addrs, writes = port.traces_np(p, 7, 5, 130)
    ra, rw = ref.traces_np(r, 7, 5, 130)
    np.testing.assert_array_equal(addrs, ra)
    np.testing.assert_array_equal(writes, rw)
    tr = port.make_traces(p, 7, 5, 130, size=64)
    assert tr == ref.make_traces(r, 7, 5, 130, size=64)
    assert [[a for a, _, _ in h] for h in tr] == addrs.tolist()
    assert [[w for _, _, w in h] for h in tr] == writes.tolist()
    assert {s for h in tr for _, s, _ in h} == {64}


BAD_SPECS = [dict(kind="random", num_pages=8), dict(kind="scan", num_pages=1),
             dict(kind="scan", num_pages=8, line_offsets=65),
             dict(kind="scan", num_pages=8, line_offsets=0),
             dict(kind="hotspot", num_pages=8, hot_pages=8),
             dict(kind="bursty", num_pages=8, hot_pages=2, on_len=0),
             dict(kind="bursty", num_pages=8, hot_pages=2, off_len=-1),
             dict(kind="scan", num_pages=8, stride_pages=0)]


@pytest.mark.parametrize("kw", BAD_SPECS, ids=lambda kw: str(sorted(kw)))
def test_spec_errors_are_the_references_word_for_word(kw):
    with pytest.raises(ValueError) as want:
        ref.WorkloadSpec(**kw)
    with pytest.raises(ValueError) as got:
        port.WorkloadSpec(**kw)
    assert str(got.value) == str(want.value)


def test_the_package_exports_the_workloads():
    import repro_torch.data as data

    for name in ("WorkloadSpec", "access_at", "host_trace_np",
                 "host_trace_torch", "make_traces", "traces_np"):
        assert getattr(data, name) is getattr(port, name)
