"""The port's vlm family (llama-3.2-vision-90b, reduced) against the JAX
package, on the CPU.

The JAX weights are carried across by ``params_from_jax`` (the
super-block layout and the ``cross`` tree), with every cross-attention
gate set to 0.5 on both sides: the reference initialises the gates to
zero, and ``tanh(0) = 0`` would hide the cross layers from every
comparison.  The reduced config is cut to 4 self layers, two super-blocks
of 2 self layers and one cross layer.  Tolerances: logits, aux, caches
1e-4 (float32 matmuls summed in another order, as
``tests/test_torch_families.py``); the cross keys and values (one float32
product each) 1e-6; the port's prefill against its decode 2e-3
(``tests/test_models_smoke.py::test_prefill_decode_parity``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import transformer as JT
from repro_torch.configs import get_arch
from repro_torch.convert import decode_state_from_jax, params_from_jax
from repro_torch.distributed.step import make_prefill_step, make_serve_step
from repro_torch.launch.serve import serve
from repro_torch.models import transformer as T

ARCH = "llama-3_2-vision-90b"
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
KV_TOL = dict(rtol=1e-6, atol=1e-6)
PARITY_TOL = dict(rtol=2e-3, atol=2e-3)
STEPS = 16


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.fixture(scope="module")
def vlm():
    jcfg = jax_get_arch(ARCH).reduced(n_layers=4)
    cfg = get_arch(ARCH).reduced(n_layers=4)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    jparams["cross"]["gate"] = jnp.full_like(jparams["cross"]["gate"], 0.5)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             torch_device="cpu")
    rng = np.random.default_rng(1)
    frontend = (rng.standard_normal((2, cfg.n_frontend_tokens, cfg.d_model))
                * 0.1).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, (2, STEPS)).astype(np.int32)
    return jcfg, cfg, jparams, params, frontend, tokens


def test_parameters_keep_the_super_block_layout(vlm):
    jcfg, cfg, jparams, params, _, _ = vlm
    assert params["blocks"]["wq"].shape == (2, 2, 64, 64)
    assert params["cross"]["wk"].shape == (2, 64, 32)
    assert params["cross"]["gate"].shape == (2, 1)
    own = T.init_params(cfg, 3, torch_device="cpu")
    assert jax.tree.map(np.shape, jparams) == jax.tree.map(
        lambda t: tuple(t.shape), own)
    assert float(own["cross"]["gate"].abs().max()) == 0.0   # as the reference
    bad = jax.tree.map(np.asarray, jparams)
    bad["cross"] = dict(bad["cross"], gate=np.zeros((3, 1), np.float32))
    with pytest.raises(ValueError, match="cross/gate"):
        params_from_jax(bad, cfg, torch_device="cpu")


def test_forward_matches_jax(vlm):
    jcfg, cfg, jparams, params, frontend, tokens = vlm
    jlogits, jaux = JT.forward(jparams, jcfg, {
        "tokens": jnp.asarray(tokens), "frontend": jnp.asarray(frontend)},
        remat=False)
    with torch.no_grad():
        logits, aux = T.forward(params, cfg, {
            "tokens": torch.from_numpy(tokens),
            "frontend": torch.from_numpy(frontend)})
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **MODEL_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **MODEL_TOL)
    # the cross layers move the logits: with the gates shut they differ
    shut = dict(params, cross=dict(params["cross"],
                                   gate=torch.zeros_like(
                                       params["cross"]["gate"])))
    with torch.no_grad():
        other, _ = T.forward(shut, cfg, {
            "tokens": torch.from_numpy(tokens),
            "frontend": torch.from_numpy(frontend)})
    assert float((other - logits).abs().max()) > 1e-3


def test_decode_matches_jax(vlm):
    """The decode state with the frontend's keys and values, then 16
    teacher-forced decode steps: logits and caches against JAX's; the JAX
    state carried across by ``decode_state_from_jax`` goes on equally."""
    jcfg, cfg, jparams, params, frontend, tokens = vlm
    jstate = JT.init_decode_state(jparams, jcfg, 2, 32,
                                  frontend=jnp.asarray(frontend))
    state = T.init_decode_state(params, cfg, 2, 32,
                                frontend=torch.from_numpy(frontend))
    assert state["cross_k"].shape == (2, 2, 8, 2, 16)
    for k in ("cross_k", "cross_v"):
        np.testing.assert_allclose(_np(state[k]), np.asarray(jstate[k]),
                                   **KV_TOL)
    carried = decode_state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                    torch_device="cpu")
    jstep = jax.jit(lambda p, s, t: JT.decode_step(p, jcfg, s, t))
    step = make_serve_step(cfg)
    for i in range(STEPS):
        tok = tokens[:, i]
        jlogits, jstate = jstep(jparams, jstate, jnp.asarray(tok))
        with torch.no_grad():
            logits, state = step(params, state, torch.from_numpy(tok))
            again, carried = step(params, carried, torch.from_numpy(tok))
        np.testing.assert_allclose(_np(logits), np.asarray(jlogits),
                                   **MODEL_TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(_np(again), _np(logits), **MODEL_TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(state[k]), np.asarray(jstate[k]),
                                   **MODEL_TOL)
    assert state["cur"] == int(jstate["cur"]) == STEPS


def test_prefill_matches_decode(vlm):
    _, cfg, _, params, frontend, tokens = vlm
    logits = make_prefill_step(cfg, torch_device="cpu")(
        params, {"tokens": tokens, "frontend": frontend})
    state = T.init_decode_state(params, cfg, 2, 32, frontend=frontend)
    step = make_serve_step(cfg)
    with torch.no_grad():
        for i in range(STEPS):
            dec, state = step(params, state, torch.from_numpy(tokens[:, i]))
            np.testing.assert_allclose(_np(dec), _np(logits[:, i]),
                                       **PARITY_TOL, err_msg=f"step {i}")


def test_serve_refuses_a_vlm_and_decode_needs_the_frontend(vlm):
    _, cfg, _, params, _, _ = vlm
    with pytest.raises(ValueError, match="frontend"):
        serve(params, cfg, batch=2, prompt_len=2, gen=2, context=16)
    state = T.init_decode_state(params, cfg, 2, 16)
    assert "cross_k" not in state
    with pytest.raises(ValueError, match="frontend"):
        T.decode_step(params, cfg, state, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="int8"):
        T.init_params(dataclasses.replace(cfg, kv_dtype="int8"), 0,
                      torch_device="cpu")
