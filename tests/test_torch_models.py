"""The port's serving-path layers, decode kernel and page kernels against
the JAX package, on the CPU.

On the CPU the kernel wrappers run their plain PyTorch versions, so this
file holds those versions against the Pallas kernels (in interpret mode)
and their jnp oracles, and the port's ``decode_step`` against JAX's
``decode_step``, on the same numpy inputs.  Tolerances: layers 1e-5
(float32 rounding of the same formula); ``flash_decode`` those of
``tests/test_kernels.py`` (out 2e-5, m 1e-5, l rtol 1e-4: the kernel's
online softmax sums in another order); logits and caches 1e-4 (two layers
of float32 matmuls summed in another order); page copies exact.  The CUDA
kernels are held against the same plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.convert import params_from_jax
from repro_torch.distributed.step import make_serve_step
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_configs_are_the_references(arch):
    ours, theirs = get_arch(arch), jax_get_arch(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.reduced().name == theirs.reduced().name
    assert ours.param_count() == theirs.param_count()
    assert (ours.padded_vocab, ours.resolved_head_dim) == \
        (theirs.padded_vocab, theirs.resolved_head_dim)


# ------------------------------------------------------------------- layers
def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 96)).astype(np.float32)
    w = rng.standard_normal(96).astype(np.float32)
    np.testing.assert_allclose(_np(L.rms_norm(_t(x), _t(w), 1e-5)),
                               np.asarray(JL.rms_norm(x, w, 1e-5)), **TOL)


@pytest.mark.parametrize("hd,theta", [(16, 100_000.0), (120, 100_000.0),
                                      (64, 500_000.0)])
def test_apply_rope_matches(hd, theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, hd)).astype(np.float32)
    pos = rng.integers(0, 700, (2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        _np(L.apply_rope(_t(x), _t(pos), theta)),
        np.asarray(JL.apply_rope(x, pos, theta)), **TOL)


def test_swiglu_matches():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    wg, wu = (rng.standard_normal((64, 128)).astype(np.float32) * 0.125
              for _ in range(2))
    wd = rng.standard_normal((128, 64)).astype(np.float32) * 0.09
    np.testing.assert_allclose(
        _np(L.swiglu(*map(_t, (x, wg, wu, wd)))),
        np.asarray(JL.swiglu(x, wg, wu, wd)), **TOL)


# -------------------------------------------------------------- flash_decode
def _decode_inputs(seed, B, Smax, H, KV, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, hd), (B, Smax, KV, hd), (B, Smax, KV, hd))]


def _close_decode(got, want):
    out, m, l = map(_np, got)
    wo, wm, wl = map(np.asarray, want)
    np.testing.assert_allclose(out, wo, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(m, wm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l, wl, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("Smax,H,KV,hd,n_valid", [
    (128, 8, 8, 32, 128), (128, 8, 2, 32, 77), (256, 4, 4, 16, 1),
    (96, 16, 4, 64, 50), (96, 32, 8, 120, 33),
    (96, 10, 2, 64, 70),                       # G 5 (hymba-1.5b's group)
])
def test_flash_decode_plain_matches_pallas_and_oracle(Smax, H, KV, hd,
                                                      n_valid):
    q, kc, vc = _decode_inputs(3, 2, Smax, H, KV, hd)
    got = fd.flash_decode(_t(q), _t(kc), _t(vc), n_valid)
    _close_decode(got, jops.flash_decode_op(q, kc, vc, n_valid, bk=32))
    _close_decode(got, ref.flash_decode_ref(q, kc, vc, n_valid))


def test_combine_partials_matches():
    q, kc, vc = _decode_inputs(4, 2, 128, 32, 8, 120)
    parts = [fd.flash_decode(_t(q), _t(kc[:, i:i + 32]), _t(vc[:, i:i + 32]),
                             32) for i in range(0, 128, 32)]
    outs, ms, ls = (torch.stack([p[j] for p in parts]) for j in range(3))
    merged = fd.combine_partials(outs, ms, ls)
    want = jops.combine_partials(*(jnp.asarray(_np(t)) for t in
                                   (outs, ms, ls)))
    np.testing.assert_allclose(_np(merged), np.asarray(want), **TOL)
    full, _, _ = fd.flash_decode(_t(q), _t(kc), _t(vc), 128)
    np.testing.assert_allclose(_np(merged), _np(full), rtol=2e-5, atol=2e-5)


def test_flash_decode_refuses_what_the_kernel_does_not_take():
    q, kc, vc = map(_t, _decode_inputs(5, 1, 16, 4, 2, 8))
    for bad in (0, 17):
        with pytest.raises(ValueError, match="n_valid"):
            fd.flash_decode(q, kc, vc, bad)
    with pytest.raises(ValueError, match="float32"):
        fd.flash_decode(q.double(), kc.double(), vc.double(), 4)
    with pytest.raises(ValueError, match="multiple of KV"):
        fd.flash_decode(q[:, :3], kc, vc, 4)


# ---------------------------------------------------------------- page ops
def _as_jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_page_ops_plain_match_pallas(dtype):
    rng = np.random.default_rng(6)
    shape = (9, 2, 3, 4, 5)                       # 5-D pages, as KV pages
    pool = rng.integers(-200, 200, shape).astype(np.float32)
    pages = rng.integers(-200, 200, (4,) + shape[1:]).astype(np.float32)
    table = np.asarray([7, 2, 7, 0], np.int32)    # slot 7 written twice
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)

    got = ops.page_gather_op(_t(pool).to(tdt), _t(table))
    want = jops.page_gather_op(_as_jax(pool, jdt), jnp.asarray(table))
    assert got.dtype == tdt and got.shape == want.shape
    np.testing.assert_array_equal(_np(got.float()),
                                  np.asarray(want.astype(jnp.float32)))

    tp = _t(pool).to(tdt)
    out = ops.page_scatter_op(tp, _t(table), _t(pages).to(tdt))
    assert out.data_ptr() == tp.data_ptr()        # written in place
    want = jops.page_scatter_op(_as_jax(pool, jdt), jnp.asarray(table),
                                _as_jax(pages, jdt))
    np.testing.assert_array_equal(_np(out.float()),
                                  np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(_np(out[7].float()), pages[2])  # last wins


def test_page_ops_refuse_out_of_range_slots():
    pool = torch.zeros(4, 2, 3)
    for table in ([4], [-1]):
        with pytest.raises(ValueError, match="outside"):
            ops.page_gather_op(pool, torch.tensor(table))
        with pytest.raises(ValueError, match="outside"):
            ops.page_scatter_op(pool, torch.tensor(table),
                                torch.zeros(1, 2, 3))


# ---------------------------------------------------------- decode_step
def _reduced():
    return jax_get_arch("h2o-danube-3-4b").reduced(), \
        get_arch("h2o-danube-3-4b").reduced()


def test_decode_step_matches_jax_through_the_ring_wrap():
    jcfg, cfg = _reduced()
    assert cfg.swa_window == 32 and cfg.resolved_head_dim == 16
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             torch_device="cpu")
    B, context, steps = 3, 64, 48                 # a 32-slot ring, wrapped
    jstate = JT.init_decode_state(jparams, jcfg, B, context)
    state = T.init_decode_state(params, cfg, B, context)
    assert state["k"].shape == jstate["k"].shape == (2, B, 32, 2, 16)
    jstep = jax.jit(lambda s, t: JT.decode_step(jparams, jcfg, s, t))
    step = make_serve_step(cfg)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (steps, B))
    for i in range(steps):
        jl, jstate = jstep(jstate, jnp.asarray(toks[i], jnp.int32))
        lg, state = step(params, state, _t(toks[i].astype(np.int32)))
        np.testing.assert_allclose(_np(lg), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {i}")
    assert state["cur"] == int(jstate["cur"]) == steps
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(state[name]), np.asarray(jstate[name]),
                                   rtol=1e-4, atol=1e-4)


def test_init_params_has_the_reference_layout_and_scales():
    jcfg, cfg = _reduced()
    params = T.init_params(cfg, 0, torch_device="cpu")
    want = jax.tree.map(lambda a: a.shape,
                        JT.init_params(jax.random.PRNGKey(0), jcfg))
    assert jax.tree.map(lambda a: tuple(a.shape), params) == want
    wq = params["blocks"]["wq"]
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.01
    assert torch.equal(params["blocks"]["ln1"], torch.ones(2, 64))
    again = T.init_params(cfg, 0, torch_device="cpu")
    assert torch.equal(again["embed"], params["embed"])      # seeded


def test_params_from_jax_refuses_a_wrong_tree():
    _, cfg = _reduced()
    good = jax.tree.map(np.zeros, T.param_shapes(cfg),
                        is_leaf=lambda x: isinstance(x, tuple))
    params_from_jax(good, cfg, torch_device="cpu")
    bad = dict(good, lm_head=np.zeros((3, 3)))
    with pytest.raises(ValueError, match="lm_head"):
        params_from_jax(bad, cfg, torch_device="cpu")
    with pytest.raises(ValueError, match="keys"):
        params_from_jax({k: v for k, v in good.items() if k != "embed"}, cfg,
                        torch_device="cpu")


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-2_7b",
                                  "hymba-1_5b", "musicgen-large",
                                  "llama-3_2-vision-90b"])
def test_other_families_are_refused(arch):
    cfg = get_arch(arch).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.init_params(cfg, 0, torch_device="cpu")


def test_int8_kv_and_a_mesh_are_refused():
    _, cfg = _reduced()
    with pytest.raises(NotImplementedError, match="int8"):
        T.param_shapes(dataclasses.replace(cfg, kv_dtype="int8"))
    with pytest.raises(NotImplementedError, match="mesh"):
        make_serve_step(cfg, mesh=object())
    params = T.init_params(cfg, 0, torch_device="cpu")
    state = T.init_decode_state(params, cfg, 1, 8)
    with pytest.raises(NotImplementedError, match="mesh"):
        T.decode_step(params, cfg, state, torch.zeros(1, dtype=torch.int32),
                      ctx=object())
