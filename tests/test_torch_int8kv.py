"""The port's int8 KV cache against the JAX package, on the CPU.

Under ``kv_dtype="int8"`` each decode step quantizes this token's K and V
per (batch row, KV head) to int8 with a float16 scale and writes them into
the ring; attention reads the dequantized rows.  The quantizer is held
bit-equal to JAX's ``_quantize_kv`` (``round`` is half to even in both,
and the quotient uses the float32 scale before its float16 cast), the
caches and scales of whole decode runs bit-equal to JAX's, and the logits
within 1e-4 (two layers of float32 matmuls summed in another order, as in
``tests/test_torch_models.py``).  ``flash_decode_int8``'s plain version
(dequantize, then ``flash_decode_plain``) is held against JAX's dequantize
and ``decode_attention`` at ``flash_decode``'s tolerances (out 2e-5, m
1e-5, l rtol 1e-4); on the card ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold the kernel against that plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels import ref
from repro.models import transformer as JT
from repro_torch.configs import get_arch
from repro_torch.convert import decode_state_from_jax, params_from_jax
from repro_torch.distributed.step import make_prefill_step, make_serve_step
from repro_torch.kernels import flash_decode as fd
from repro_torch.launch.serve import serve
from repro_torch.models import transformer as T

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().cpu().numpy()


def _int8(arch, **kw):
    jcfg = dataclasses.replace(jax_get_arch(arch).reduced(**kw),
                               kv_dtype="int8")
    cfg = dataclasses.replace(get_arch(arch).reduced(**kw), kv_dtype="int8")
    return jcfg, cfg


# -------------------------------------------------------------- quantizer
def _quant_inputs(seed):
    rng = np.random.default_rng(seed)
    t = (rng.standard_normal((4, 3, 16)) * rng.uniform(1e-3, 50, (4, 3, 1))
         ).astype(np.float32)
    t[0, 0] = 0.0                                  # the 1e-6 floor
    # exact halves of the scale: 127 * k / 254 rounds half to even
    t[1, 1] = np.float32(127.0) * np.arange(-8, 8) / np.float32(254.0)
    t[1, 1, 0] = np.float32(127.0)
    t[2, 2, :4] = [3e38, -3e38, 1e-30, -0.0]        # extremes
    return t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_kv_is_bit_equal(seed):
    t = _quant_inputs(seed)
    q, s = T._quantize_kv(_t(t))
    jq, js = JT._quantize_kv(jnp.asarray(t))
    assert q.dtype == torch.int8 and s.dtype == torch.float16
    np.testing.assert_array_equal(_np(q), np.asarray(jq))
    np.testing.assert_array_equal(_np(s).view(np.uint16),
                                  np.asarray(js).view(np.uint16))


# ------------------------------------------------------- flash_decode_int8
def _int8_inputs(seed, B, Smax, H, KV, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    caches = [rng.integers(-127, 128, (B, Smax, KV, hd)).astype(np.int8)
              for _ in range(2)]
    scales = [(rng.uniform(1e-3, 0.1, (B, Smax, KV))).astype(np.float16)
              for _ in range(2)]
    return q, caches, scales


@pytest.mark.parametrize("Smax,H,KV,hd,n_valid", [
    (64, 8, 2, 16, 64), (64, 8, 2, 16, 1), (96, 32, 8, 120, 33),
    (96, 10, 2, 64, 70), (128, 16, 16, 128, 100)])
def test_flash_decode_int8_plain_matches_jax_dequantized(Smax, H, KV, hd,
                                                         n_valid):
    q, (kc, vc), (ks, vs) = _int8_inputs(Smax + hd, 2, Smax, H, KV, hd)
    got = fd.flash_decode_int8(*map(_t, (q, kc, vc, ks, vs)), n_valid)
    # the reference's dequantization (transformer.py's _attn_decode)
    k_eff = jnp.asarray(kc).astype(jnp.float32) * \
        jnp.asarray(ks).astype(jnp.float32)[..., None]
    v_eff = jnp.asarray(vc).astype(jnp.float32) * \
        jnp.asarray(vs).astype(jnp.float32)[..., None]
    np.testing.assert_array_equal(
        _np(fd.dequantize(_t(kc), _t(ks))), np.asarray(k_eff))
    wo, wm, wl = ref.flash_decode_ref(q, k_eff, v_eff, n_valid)
    out, m, l = map(_np, got)
    np.testing.assert_allclose(out, np.asarray(wo), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(m, np.asarray(wm), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l, np.asarray(wl), rtol=1e-4, atol=1e-5)


def test_flash_decode_int8_refuses_what_it_does_not_take():
    q, (kc, vc), (ks, vs) = map(
        lambda x: [_t(a) for a in x] if isinstance(x, list) else _t(x),
        _int8_inputs(5, 1, 16, 4, 2, 8))
    with pytest.raises(ValueError, match="int8"):
        fd.flash_decode_int8(q, kc.float(), vc.float(), ks, vs, 4)
    with pytest.raises(ValueError, match="float16"):
        fd.flash_decode_int8(q, kc, vc, ks.float(), vs, 4)
    with pytest.raises(ValueError, match="float16"):
        fd.flash_decode_int8(q, kc, vc, ks, vs.bfloat16(), 4)
    with pytest.raises(ValueError, match="scales of shape"):
        fd.flash_decode_int8(q, kc, vc, ks[:, :8], vs, 4)
    with pytest.raises(ValueError, match="n_valid"):
        fd.flash_decode_int8(q, kc, vc, ks, vs, 17)
    with pytest.raises(ValueError, match="float32"):
        fd.flash_decode_int8(q.double(), kc, vc, ks, vs, 4)
    with pytest.raises(ValueError, match="float32 caches"):
        fd.flash_decode(q, kc, vc, 4)


# ---------------------------------------------------------------- models
@pytest.mark.parametrize("arch,context,steps", [
    ("glm4-9b", 16, 10), ("h2o-danube-3-4b", 16, 10),
    ("h2o-danube-3-4b", 64, 40),               # a 32-slot ring, wrapped
    ("hymba-1_5b", 16, 10), ("mixtral-8x7b", 16, 10)])
def test_int8_decode_steps_match_jax(arch, context, steps):
    """Caches and scales bit-equal to JAX's after every step, logits
    within 1e-4."""
    jcfg, cfg = _int8(arch)
    jparams = JT.init_params(jax.random.PRNGKey(5), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             torch_device="cpu")
    B = 3
    jstate = JT.init_decode_state(jparams, jcfg, B, context)
    state = decode_state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                  torch_device="cpu")
    assert state["k"].dtype == torch.int8
    assert state["k_scale"].dtype == torch.float16
    assert state["k_scale"].shape == state["k"].shape[:-1]
    jstep = jax.jit(lambda s, t: JT.decode_step(jparams, jcfg, s, t))
    step = make_serve_step(cfg)
    toks = np.random.default_rng(14).integers(0, cfg.vocab, (steps, B))
    for i in range(steps):
        jl, jstate = jstep(jstate, jnp.asarray(toks[i], jnp.int32))
        lg, state = step(params, state, _t(toks[i].astype(np.int32)))
        np.testing.assert_allclose(_np(lg), np.asarray(jl), **MODEL_TOL,
                                   err_msg=f"step {i}")
        for name in ("k", "v"):
            np.testing.assert_array_equal(_np(state[name]),
                                          np.asarray(jstate[name]),
                                          err_msg=f"{name}, step {i}")
            np.testing.assert_array_equal(
                _np(state[f"{name}_scale"]).view(np.uint16),
                np.asarray(jstate[f"{name}_scale"]).view(np.uint16),
                err_msg=f"{name}_scale, step {i}")


@pytest.mark.parametrize("arch", ["glm4-9b", "h2o-danube-3-4b"])
def test_int8_forward_matches_jax(arch):
    """Prefill holds no cache, so int8 leaves it as the float model's."""
    jcfg, cfg = _int8(arch)
    jparams = JT.init_params(jax.random.PRNGKey(6), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             torch_device="cpu")
    tokens = np.random.default_rng(15).integers(0, cfg.vocab, (2, 12))
    want, jaux = JT.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)},
                            remat=False)
    got, aux = T.forward(params, cfg, {"tokens": _t(tokens)})
    np.testing.assert_allclose(_np(got), np.asarray(want), **MODEL_TOL)
    assert aux == float(jaux) == 0.0
    np.testing.assert_array_equal(
        _np(make_prefill_step(cfg, torch_device="cpu")(
            params, {"tokens": tokens})), _np(got))


def test_int8_serve_archives_the_int8_segment():
    """The reference's serve loop archives ``np.asarray`` of the int8 K
    segment into the float32 capacity tier; the counters do not depend on
    the page data, so they equal the float cache's."""
    _, cfg = _int8("h2o-danube-3-4b")
    params = T.init_params(cfg, 3, torch_device="cpu")
    kw = dict(batch=2, prompt_len=4, gen=4, context=32, kv_page_tokens=4,
              seed=3)
    res = serve(params, cfg, **kw)
    ring = res.state["k"]
    assert ring.dtype == torch.int8 and ring.shape[2] == 32
    for seg in range(2):                           # still in the ring
        page = res.tiered.capacity_page(seg)
        assert page.dtype == np.float32
        np.testing.assert_array_equal(
            page, _np(ring[:, :, 4 * seg:4 * seg + 4]).astype(np.float32))
    flt = serve(params, dataclasses.replace(cfg, kv_dtype="model"), **kw)
    assert res.tiered.stats == flt.tiered.stats
    assert res.tiered.sim_ticks == flt.tiered.sim_ticks
