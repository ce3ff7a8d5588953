"""The port's prefill path against the JAX package, on the CPU.

On the CPU the ``flash_attention`` wrapper runs its plain PyTorch version,
so this file holds that version against the Pallas ``flash_attention_tpu``
(in interpret mode) and its jnp oracle ``flash_attention_ref`` within
2e-5 (``tests/test_kernels.py``'s float32 tolerance: the kernel's online
softmax sums in another order), and the port's ``forward`` and
``make_prefill_step`` against JAX's ``forward`` on the reduced
h2o-danube-3-4b within 1e-4 (two layers of float32 matmuls summed in
another order, as ``decode_step``'s check).  Prefill against decode within
the port is held within 1e-4: both run the same CPU float32 code, only
one token at a time.  The CUDA kernel is held against the same plain
version on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.distributed.step import make_prefill_step as jax_make_prefill_step
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention_tpu
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.distributed import make_prefill_step, make_serve_step
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ops import flash_attention_op
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return x.detach().cpu().numpy()


def _qkv(seed, B, S, Skv, KV, G, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, KV * G, hd), (B, Skv, KV, hd), (B, Skv, KV, hd))]


# (S, Skv, causal, window); no S is a multiple of the Pallas kernel's
# 128-row tile, and "ragged" is a multiple of neither its tiles nor the
# CUDA kernel's (128 query rows, 32 keys)
MODES = {"causal": (200, 200, True, 0), "window": (200, 200, True, 48),
         "cross": (72, 40, False, 0), "ragged": (133, 133, True, 0)}


# ------------------------------------------------------------- the kernel
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("G", [1, 4, 5])
@pytest.mark.parametrize("hd", [16, 120])
def test_flash_attention_plain_matches_pallas_and_oracle(hd, G, mode):
    S, Skv, causal, window = MODES[mode]
    q, k, v = _qkv(hd + G, 2, S, Skv, 2, G, hd)
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                             window=window)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(
        _np(got), np.asarray(flash_attention_tpu(
            q, k, v, causal=causal, window=window, interpret=True)),
        **ATTN_TOL)
    np.testing.assert_allclose(
        _np(got), np.asarray(ref.flash_attention_ref(q, k, v, causal=causal,
                                                     window=window)),
        **ATTN_TOL)
    assert torch.equal(
        fa.flash_attention_plain(_t(q), _t(k), _t(v), causal=causal,
                                 window=window), got)


def test_flash_attention_plain_in_chunks_equals_one_pass(monkeypatch):
    q, k, v = map(_t, _qkv(1, 2, 133, 133, 2, 4, 16))
    whole = fa.flash_attention_plain(q, k, v, window=40)
    monkeypatch.setattr(fa, "PLAIN_SCORES", 2 * 8 * 133 * 10)  # 10-row chunks
    np.testing.assert_allclose(_np(fa.flash_attention_plain(q, k, v,
                                                            window=40)),
                               _np(whole), rtol=1e-6, atol=1e-6)


def test_flash_attention_op_matches_the_jax_op():
    q, k, v = _qkv(2, 1, 96, 96, 2, 4, 32)
    np.testing.assert_allclose(
        _np(flash_attention_op(_t(q), _t(k), _t(v), window=24)),
        np.asarray(jops.flash_attention_op(q, k, v, window=24, bq=32,
                                           bk=32)), **ATTN_TOL)


@pytest.mark.parametrize("window", [0, 5])
def test_attention_ref_and_the_model_call_match_jax(window):
    q, k, v = _qkv(3, 2, 40, 40, 2, 2, 16)
    want = np.asarray(JL.attention_ref(q, k, v, causal=True, window=window))
    np.testing.assert_allclose(
        _np(L.attention_ref(_t(q), _t(k), _t(v), window=window)), want,
        **ATTN_TOL)
    np.testing.assert_allclose(
        _np(L.flash_attention(_t(q), _t(k), _t(v), window=window)),
        np.asarray(JL.flash_attention(q, k, v, causal=True, window=window,
                                      q_block=16, kv_block=16)), **ATTN_TOL)
    pos = np.arange(40)
    assert np.array_equal(
        _np(L._block_mask(_t(pos), _t(pos), window)),
        np.asarray(JL._block_mask(pos, pos, window)))


# ------------------------------------------------------------- the model
def _reduced():
    jcfg = jax_get_arch("h2o-danube-3-4b").reduced()
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_arch("h2o-danube-3-4b").reduced()
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             torch_device="cpu")
    return jcfg, jparams, cfg, params


def test_forward_and_prefill_step_match_jax_across_the_window():
    jcfg, jparams, cfg, params = _reduced()
    assert cfg.swa_window == 32
    tokens = np.random.default_rng(8).integers(0, cfg.vocab, (2, 96))
    jlogits, jaux = JT.forward(jparams, jcfg, {"tokens": tokens}, remat=False)
    logits, aux = T.forward(params, cfg, {"tokens": _t(tokens)})
    assert logits.shape == (2, 96, cfg.padded_vocab) and aux == 0.0
    assert float(jaux) == 0.0
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **LOGIT_TOL)
    step = make_prefill_step(cfg, torch_device="cpu")
    jstep = jax_make_prefill_step(jcfg, None)
    got = step(params, {"tokens": tokens.astype(np.int32)})   # numpy in
    assert not got.requires_grad
    np.testing.assert_allclose(_np(got), np.asarray(jstep(jparams,
                                                          {"tokens": tokens})),
                               **LOGIT_TOL)
    np.testing.assert_allclose(_np(got), _np(logits), rtol=0, atol=0)


def _decode_all(params, cfg, tokens, context):
    state = T.init_decode_state(params, cfg, tokens.shape[0], context)
    step = make_serve_step(cfg)
    outs = []
    for t in range(tokens.shape[1]):
        lg, state = step(params, state, tokens[:, t])
        outs.append(lg)
    return torch.stack(outs, dim=1), state


@pytest.mark.parametrize("arch", ["minicpm-2b", "glm4-9b", "codeqwen1_5-7b",
                                  "h2o-danube-3-4b"])
def test_prefill_decode_parity(arch):
    """Decoding token by token reproduces the full-sequence forward
    (``tests/test_models_smoke.py::test_prefill_decode_parity``)."""
    cfg = get_arch(arch).reduced()
    params = T.init_params(cfg, 1, torch_device="cpu")
    tokens = _t(np.random.default_rng(9).integers(0, cfg.vocab, (2, 10)))
    full, _ = T.forward(params, cfg, {"tokens": tokens})
    dec, _ = _decode_all(params, cfg, tokens.int(), 10)
    np.testing.assert_allclose(_np(dec), _np(full), **LOGIT_TOL)


def test_swa_ring_buffer_decode_matches_windowed_forward():
    """The ring-buffer decode equals the windowed forward past the window
    (``tests/test_models_smoke.py::test_swa_ring_buffer_decode_matches_
    windowed_forward``)."""
    cfg = get_arch("h2o-danube-3-4b").reduced(swa_window=6)
    params = T.init_params(cfg, 2, torch_device="cpu")
    tokens = _t(np.random.default_rng(10).integers(0, cfg.vocab, (1, 12)))
    full, _ = T.forward(params, cfg, {"tokens": tokens})
    dec, state = _decode_all(params, cfg, tokens.int(), 12)
    assert state["k"].shape[2] == 6                # ring limited to window
    np.testing.assert_allclose(_np(dec), _np(full), **LOGIT_TOL)


# -------------------------------------------------------------- refusals
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-2_7b", "hymba-1_5b",
                                  "musicgen-large", "llama-3_2-vision-90b"])
def test_forward_refuses_other_families(arch):
    cfg = get_arch(arch).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 14"):
        T.forward({}, cfg, {"tokens": torch.zeros(1, 4, dtype=torch.int32)})


def test_prefill_refuses_a_mesh_remat_and_cross_attention():
    _, _, cfg, params = _reduced()
    with pytest.raises(NotImplementedError, match="mesh"):
        make_prefill_step(cfg, mesh=object(), torch_device="cpu")
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.int32)}
    with pytest.raises(NotImplementedError,
                       match="remat.*ROADMAP Queue A item 14"):
        T.forward(params, cfg, batch, remat=True)
    with pytest.raises(NotImplementedError, match="mesh"):
        T.forward(params, cfg, batch, ctx=object())
    with pytest.raises(NotImplementedError, match="cross-attention"):
        T.forward(params, dataclasses.replace(cfg, cross_attn_every=2), batch)


def test_flash_attention_refuses_what_the_kernel_does_not_take():
    q, k, v = map(_t, _qkv(4, 1, 8, 8, 2, 2, 16))
    with pytest.raises(ValueError, match="gradient"):
        fa.flash_attention(q.clone().requires_grad_(), k, v)
    with pytest.raises(ValueError, match="gradient"):
        L.flash_attention(q, k, v.clone().requires_grad_())
    for hd in (18, 132):
        bad = [_t(a) for a in _qkv(5, 1, 8, 8, 2, 2, hd)]
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention(*bad)
    g3 = [_t(a) for a in _qkv(6, 1, 8, 8, 2, 3, 16)]
    with pytest.raises(ValueError, match="group size"):
        fa.flash_attention(*g3)
    with pytest.raises(ValueError, match="float32"):
        fa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="Skv == S"):
        fa.flash_attention(q, k[:, :5], v[:, :5])
    with pytest.raises(ValueError, match="multiple of KV"):
        fa.flash_attention(q[:, :, :3], k, v)
    assert fa.flash_attention(q, k[:, :5], v[:, :5], causal=False).shape == \
        q.shape
