"""The port's training path against the JAX package, on the CPU.

The same JAX weights (carried across by ``params_from_jax``, with every
vlm cross-attention gate set to 0.5 on both sides: the reference
initialises them to zero, and ``tanh(0) = 0`` would hide the cross layers
from every comparison) and the same seeded numpy batch go through the JAX
functions under ``jax.jit`` and their ports, for the reduced config of
every family.  Tolerances:

- loss and every gradient of ``make_loss_fn`` within 1e-4 (absolute and
  relative): two layers of float32 matmuls, softmaxes and their
  transposes, summed in another order (the forward's logits are held at
  1e-4 in ``tests/test_torch_models.py``);
- after a whole ``make_train_step`` step from one state on both sides,
  parameters and float32 moments within 1e-5, at a peak lr of 1e-4:
  AdamW's first steps move a parameter by about ``lr * g / (|g| +
  1e-8)``, so where a gradient is within float32 rounding of zero the two
  frameworks' roundings move it apart by a share of lr (2.3e-5 at lr 1e-3
  on the reduced vlm, at 2 of its elements);
- int8 moment codes equal but at under 0.2% of the elements, one apart
  there (a quotient a float32 rounding away from a ``.5`` tie rounds either
  way; under compression a gradient's own int8 quantum can flip too, and
  then a moment's code moves by more), their float16 scales within 1e-3;
  compression residuals within 1e-5 but at under 0.1% of the elements
  (the same flips, one quantum each).  Only the first int8 step is
  compared: later ones decode a second moment at its bottom code as 0,
  and the reference's update then divides by ``|g|`` alone, so rounding
  noise in a gradient near zero moves a parameter arbitrarily far (the
  reference's own int8-against-f32 test,
  ``tests/test_optim_data_ckpt.py::TestInt8Moments``, fails on the seed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.distributed import step as JSTEP
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.optim import compression as JC
from repro.optim import schedules as JSCH
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.distributed import step as STEP
from repro_torch.optim import adamw as A
from repro_torch.optim import compression as C
from repro_torch.optim import schedules as SCH

ARCHS = ["minicpm-2b", "llama-3_2-vision-90b", "mixtral-8x7b",
         "mamba2-2_7b", "hymba-1_5b", "musicgen-large", "kimi-k2-1t-a32b"]
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
GATE = 0.5


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close_tree(got, want, tol, where=""):
    """``got`` (the port's nested dicts) against ``want`` (JAX's dicts and
    named tuples), leaf by leaf."""
    want = want._asdict() if hasattr(want, "_asdict") else want
    assert set(got) == set(want), where
    for k, g in got.items():
        if isinstance(g, dict):
            _close_tree(g, want[k], tol, f"{where}{k}/")
        else:
            np.testing.assert_allclose(_np(g), np.asarray(want[k]), **tol,
                                       err_msg=f"{where}{k}")


def _leaves(tree):
    """Leaves in sorted-key order (JAX's dicts and the port's may hold
    their keys in other orders)."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def models(arch, seed=0, **over):
    """(jcfg, cfg, jax params, port params) of the reduced config, gates
    at 0.5 on both sides."""
    jcfg = jax_get_arch(arch).reduced(**over)
    cfg = get_arch(arch).reduced(**over)
    jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    if "cross" in jparams:
        jparams["cross"]["gate"] = jnp.full_like(jparams["cross"]["gate"],
                                                 GATE)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             torch_device="cpu")
    return jcfg, cfg, jparams, params


def batch_for(cfg, seed, B=4, S=16):
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    batch = {"tokens": rng.integers(0, cfg.vocab, shape).astype(np.int32)}
    if cfg.cross_attn_every:
        batch["frontend"] = (rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jcfg, cfg, jparams, params = models(arch)
    batch = batch_for(cfg, 1)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        JSTEP.make_loss_fn(jcfg, None, remat=False)))(jparams,
                                                       _jax_batch(batch))
    loss, grads = STEP.value_and_grad(
        STEP.make_loss_fn(cfg, remat=False), params, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), **GRAD_TOL)
    _close_tree(grads, jgrads, GRAD_TOL)
    if cfg.cross_attn_every:       # the cross layers do reach the loss
        assert float(grads["cross"]["wv"].abs().max()) > 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_and_accumulation_match_jax(arch):
    """``remat=True`` (each block, and each vlm super-block, recomputed)
    and two microbatches: the reference's accumulation (the mean of
    ``value_and_grad`` over consecutive halves of the batch)."""
    jcfg, cfg, jparams, params = models(arch, seed=2)
    batch = batch_for(cfg, 3)
    vg = jax.jit(jax.value_and_grad(
        JSTEP.make_loss_fn(jcfg, None, remat=True)))
    halves = [vg(jparams, _jax_batch({k: v[i * 2:(i + 1) * 2]
                                      for k, v in batch.items()}))
              for i in range(2)]
    jloss = (halves[0][0] + halves[1][0]) * 0.5
    jgrads = jax.tree.map(lambda a, b: (a + b) * 0.5, halves[0][1],
                          halves[1][1])
    loss, grads = STEP.make_grad_fn(cfg, remat=True, accum_steps=2)(
        params, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), **GRAD_TOL)
    _close_tree(grads, jgrads, GRAD_TOL)


def test_remat_policy_dots_gives_the_same_gradients():
    _, cfg, _, params = models("hymba-1_5b", seed=4)
    batch = _torch_batch(batch_for(cfg, 5))
    plain = STEP.value_and_grad(STEP.make_loss_fn(cfg, remat=False), params,
                                batch)
    dots = STEP.value_and_grad(
        STEP.make_loss_fn(cfg, remat=True, remat_policy="dots"), params,
        batch)
    assert torch.equal(plain[0], dots[0])
    for a, b in zip(_leaves(plain[1]), _leaves(dots[1])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="remat_policy"):
        STEP.make_loss_fn(cfg, remat=True, remat_policy="all")(params, batch)


def _few_differ(got, want, tol, share, most=None):
    """All leaves of two trees within ``tol`` but at under ``share`` of
    their elements (and within ``most`` there, if given)."""
    diff = np.concatenate([
        np.abs(_np(g).astype(np.float64) - np.asarray(w).astype(np.float64))
        .ravel() for g, w in zip(_leaves(got), _leaves(want))])
    assert (diff > tol).mean() < share, ((diff > tol).mean(), diff.max())
    if most is not None:
        assert diff.max() <= most, diff.max()


def _to_torch(tree):
    """A JAX state tree (dicts, named tuples) as the port's dicts."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("arch", ["minicpm-2b"])
@pytest.mark.parametrize("moments,compress", [("f32", False), ("int8", True),
                                              ("f32", True), ("int8", False)])
def test_train_steps_match_jax(arch, moments, compress):
    """Whole steps of ``make_train_step`` (the WSD schedule, clipping,
    decay, the moments, compression with its residual), each from one
    state on both sides: the float32 runs take a warm step and a decaying
    one (the second from JAX's state after the first), the int8 runs their
    first step."""
    jcfg, cfg, jparams, params = models(arch, seed=6)
    jacfg = JA.AdamWConfig(moment_dtype=moments)
    acfg = A.AdamWConfig(moment_dtype=moments)
    jstep = jax.jit(JSTEP.make_train_step(
        jcfg, None, lr_fn=JSCH.wsd_schedule(1e-4, 2, 4, 4), adamw_cfg=jacfg,
        compress_grads=compress))
    step = STEP.make_train_step(
        cfg, lr_fn=SCH.wsd_schedule(1e-4, 2, 4, 4), adamw_cfg=acfg,
        compress_grads=compress)
    jopt = JA.adamw_init(jparams, moments)
    opt = A.adamw_init(params, moments)
    jcomp = JC.compress_init(jparams) if compress else None
    comp = C.compress_init(params) if compress else None
    for s in ((3, 7) if moments == "f32" else (3,)):
        batch = batch_for(cfg, 10 + s)
        jout = jstep(jparams, jopt, _jax_batch(batch), jnp.int32(s), jcomp)
        out = step(params, opt, batch, s, comp)
        np.testing.assert_allclose(float(out[2]), float(jout[2]),
                                   **GRAD_TOL)
        _close_tree(out[0], jout[0], STEP_TOL)
        assert int(out[1]["count"]) == int(jout[1]["count"])
        if moments == "f32":
            _close_tree(out[1]["mu"], jout[1]["mu"], STEP_TOL)
            _close_tree(out[1]["nu"], jout[1]["nu"], STEP_TOL)
        else:
            for k in ("mu_q", "nu_q"):
                assert all(g.dtype == torch.int8 for g in _leaves(out[1][k]))
                _few_differ(out[1][k], jout[1][k], 0, 2e-3,
                            None if compress else 1)
            for k in ("mu_s", "nu_s"):
                for g, w in zip(_leaves(out[1][k]), _leaves(jout[1][k])):
                    assert g.dtype == torch.float16
                    np.testing.assert_allclose(_np(g).astype(np.float32),
                                               np.asarray(w, np.float32),
                                               rtol=1e-3, atol=0)
        if compress:
            _few_differ(out[3].residual, jout[3].residual, 1e-5, 1e-3)
        # both go on from JAX's state
        jparams, jopt = jout[:2]
        params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                 torch_device="cpu")
        opt = _to_torch(jopt)
        if compress:
            jcomp = jout[3]
            comp = C.CompressionState(residual=_to_torch(jcomp.residual))


def test_train_step_refuses_a_mesh_and_uneven_microbatches():
    """The train step runs on a mesh for the dense and moe families
    (``tests/test_torch_mesh_train.py``); a mesh that is not one, and a
    family not yet ported to a mesh, are refused; so are microbatches
    that do not split the batch."""
    _, cfg, _, params = models("minicpm-2b")
    with pytest.raises(TypeError, match="mesh"):
        STEP.make_train_step(cfg, object(), lr_fn=lambda s: 1e-3)

    class Mesh:
        shape = {"data": 2, "model": 2}
        axis_names = ("data", "model")

    with pytest.raises(NotImplementedError, match="mesh.*item 14d iii-b"):
        STEP.make_train_step(get_arch("hymba-1_5b").reduced(), Mesh(),
                             lr_fn=lambda s: 1e-3)
    step = STEP.make_train_step(cfg, lr_fn=lambda s: 1e-3, accum_steps=3)
    with pytest.raises(ValueError, match="microbatches"):
        step(params, A.adamw_init(params), batch_for(cfg, 0), 0)
