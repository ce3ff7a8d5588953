"""The port's mesh forward, loss, gradients, AdamW and gradient
compression (dense and moe families), run by four gloo ranks on a
``data 2 x model 2`` CPU mesh (``tests/torch_mesh_ranks.py::train``) with
the JAX package's weights cut to each rank's blocks, held to the JAX
package's one-device functions on the same weights and batch:

* the forward's logits (gathered over data and the vocab) against JAX's
  ``forward``, within 1e-5 of the largest |logit|, equal argmax: reduced
  minicpm-2b, h2o-danube-3-4b, mixtral-8x7b (``tp`` experts) and kimi-k2
  (``ep``) at 8 experts and capacity factor 8, and minicpm-2b with one KV
  head, whose cut over two model ranks falls inside the head;
* the loss (1e-5 relative) and every gathered gradient (1e-4 of the
  leaf's largest |value|) against ``jax.value_and_grad`` of JAX's
  one-device ``make_loss_fn``, under the train rules' specs and the fully
  sharded ones, with ``accum_steps=2`` (dense: the gradient of the
  global batch does not depend on the microbatches) and under
  ``remat_policy="dots"``;
* two steps of the mesh AdamW (float32 and int8 moments, ZeRO-1) fed the
  JAX gradients' blocks, gathered, against the port's one-device update
  within 1e-6 (float32 also against JAX's ``adamw_update``), and two of
  ``compressed_gradients`` against the one-device transfer function.  An
  int8 moment's code may land 1 off where its value sits on a rounding
  edge: the mesh sums the global norm (the clip factor) in another order,
  so the moments differ by ulps; at most 1 code in 1000 may differ, by 1;
  scales within 1e-6 relative;
* three train steps on ``pod 2 x data 1 x model 2`` against the port's
  one-device steps (losses 1e-5 relative, parameters 1e-5).

The JAX package's own sharded step is not a reference: its vocab-sharded
embedding gather raises on the installed JAX
(``tests/test_distributed.py``)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from repro.configs import get_arch as jax_get_arch
from repro.distributed import step as JS
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.optim import compression as JC
from repro_torch.convert import params_from_jax
from repro_torch.distributed import step as S
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A
from repro_torch.optim import compression as C
from repro_torch.tree import tree_paths

SEED = 0
LOSS_RTOL = 1e-5
GRAD_SHARE = 1e-4
FORWARD_SHARE = 1e-5
UPDATE_TOL = 1e-6


def _flat(tree, prefix: str, out: dict) -> dict:
    """``out[prefix/a/b] = array`` for each leaf of a JAX tree (named
    tuples by field name)."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}/{k}", out)
    else:
        out[prefix] = np.asarray(tree)
    return out


def _jax_config(case):
    arch, over, moe = R.FORWARD_CASES[case]
    cfg = jax_get_arch(arch).reduced(**over)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references, the port's one-device references and the four
    ranks' results by (data, model) coordinates.  The ranks run while the
    references compute."""
    work = tmp_path_factory.mktemp("mesh_train")
    tokens = np.random.default_rng(SEED).integers(
        0, 256, (R.TRAIN["batch"], R.TRAIN["seq"])).astype(np.int32)
    arrays, jparams = {"tokens": tokens}, {}
    init = jax.jit(JT.init_params, static_argnums=1)
    for case in R.FORWARD_CASES:
        jparams[case] = init(jax.random.PRNGKey(SEED), _jax_config(case))
        _flat(jparams[case], f"{case}/params", arrays)
    batch = {"tokens": jnp.asarray(tokens)}
    jgrads = {}
    for case in {c for c, _, _, _ in R.GRAD_CASES.values()}:
        loss_fn = JS.make_loss_fn(_jax_config(case), None)
        jgrads[case] = jax.jit(jax.value_and_grad(loss_fn))(jparams[case],
                                                            batch)
    for case in R.ADAMW_CASES:
        _flat(jparams[case], f"adamw/{case}/params", arrays)
        _flat(jgrads[case][1], f"adamw/{case}/grads", arrays)
    np.savez(work / "in.npz", **arrays)
    join = R.start(R.train, work / "in.npz", work / "ranks", timeout_s=600)

    ref = {"forward": {}, "grads": jgrads, "adamw": {}}
    for case in R.FORWARD_CASES:
        cfg = _jax_config(case)
        ref["forward"][case] = np.asarray(jax.jit(
            lambda p, b: JT.forward(p, cfg, b, ctx=None, remat=False)[0])(
                jparams[case], batch))
    for case in R.ADAMW_CASES:
        ref["adamw"][case] = _updates(case, jparams[case], jgrads[case][1])
    ref["pod"] = _pod_one_device()
    return ref, join()


def _updates(case, jparams, jgrads):
    """The one-device updates of ``case``: the port's (float32, int8
    moments) and JAX's (float32) AdamW, and the compressed gradients."""
    cfg = R.case_config(case)
    out = {}
    grads = params_from_jax(_np_tree(jgrads), cfg, torch_device="cpu")
    for moments in ("f32", "int8"):
        params = params_from_jax(_np_tree(jparams), cfg, torch_device="cpu")
        state = A.adamw_init(params, moments)
        for _ in range(R.ADAMW_STEPS):
            A.adamw_update(grads, state, params, R.TRAIN["lr"],
                           A.AdamWConfig(moment_dtype=moments))
        out[moments] = {"params": params, "opt": state}
    jp, js = jparams, JA.adamw_init(jparams)
    update = jax.jit(lambda g, s, p: JA.adamw_update(
        g, s, p, jnp.float32(R.TRAIN["lr"]), JA.AdamWConfig()))
    for _ in range(R.ADAMW_STEPS):
        jp, js = update(jgrads, js, jp)
    out["jax_f32"] = params_from_jax(_np_tree(jp), cfg, torch_device="cpu")
    comp = C.compress_init(grads)
    jcomp = JC.compress_init(jparams)
    for _ in range(2):
        deq, comp = C.compressed_gradients(grads, comp)
        jdeq, jcomp = JC.compressed_gradients(jgrads, jcomp)
    out["compressed"] = {"grads": deq, "residual": comp.residual,
                         "jax": params_from_jax(_np_tree(jdeq), cfg,
                                                torch_device="cpu")}
    return out


def _pod_one_device():
    from repro_torch.optim.schedules import wsd_schedule

    cfg = R.case_config("minicpm-2b")
    params = T.init_params(cfg, 3, torch_device="cpu")
    opt = A.adamw_init(params)
    step = S.make_train_step(cfg, lr_fn=wsd_schedule(1e-3, 2, 5, 5))
    losses = []
    for t in range(R.POD_STEPS):
        params, opt, loss = step(params, opt, R.pod_batch(cfg), t)
        losses.append(float(loss))
    return {"losses": losses, "params": params}


def _close(got, want, share, what):
    """Every leaf of ``got`` within ``share`` of its ``want`` leaf's
    largest |value|."""
    for (path, g), (_, w) in zip(tree_paths(got), tree_paths(want)):
        g = np.asarray(g, np.float64)
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, path)
        tol = share * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= tol, f"{what} {path}: {err:.3e} > {tol:.3e}"


def _same_on_every_rank(ranks, get):
    first = get(ranks[(0, 0)])
    for r in ranks.values():
        for (_, a), (_, b) in zip(tree_paths(get(r)), tree_paths(first)):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    return first


@pytest.mark.parametrize("case", list(R.FORWARD_CASES))
def test_mesh_forward_matches_the_jax_forward(runs, case):
    ref, ranks = runs
    got = _same_on_every_rank(ranks, lambda r: {"l": r["forward"][case]})
    got = got["l"].numpy()
    want = ref["forward"][case]
    assert got.shape == want.shape
    tol = FORWARD_SHARE * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("label", list(R.GRAD_CASES))
def test_mesh_loss_and_gradients_match_jax(runs, label):
    ref, ranks = runs
    case = R.GRAD_CASES[label][0]
    jloss, jgrads = ref["grads"][case]
    got = _same_on_every_rank(ranks, lambda r: r["grads"][label])
    np.testing.assert_allclose(float(got["loss"]), float(jloss),
                               rtol=LOSS_RTOL, atol=0)
    want = params_from_jax(_np_tree(jgrads), R.case_config(case),
                           torch_device="cpu")
    _close(got["grads"], want, GRAD_SHARE, label)


@pytest.mark.parametrize("moments", ["f32", "int8"])
@pytest.mark.parametrize("case", R.ADAMW_CASES)
def test_mesh_adamw_matches_the_one_device_update(runs, case, moments):
    ref, ranks = runs
    got = _same_on_every_rank(ranks, lambda r: r["adamw"][case][moments])
    want = ref["adamw"][case][moments]
    for (path, g), (_, w) in zip(tree_paths(got["params"]),
                                 tree_paths(want["params"])):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=UPDATE_TOL,
                                   rtol=0, err_msg=path)
    assert int(got["count"]) == int(want["opt"]["count"]) == R.ADAMW_STEPS
    for k, tree in got["opt"].items():
        for (path, g), (_, w) in zip(tree_paths(tree),
                                     tree_paths(want["opt"][k])):
            assert g.dtype == w.dtype, (k, path)
            g, w = g.double().numpy(), w.double().numpy()
            if k in ("mu_q", "nu_q"):            # int8 codes
                diff = np.abs(g - w)
                assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, \
                    (k, path, int((diff > 0).sum()), diff.size)
            elif k in ("mu_s", "nu_s"):          # float16 row scales
                np.testing.assert_allclose(g, w, rtol=UPDATE_TOL, atol=0,
                                           err_msg=f"{k}/{path}")
            else:
                np.testing.assert_allclose(g, w, atol=UPDATE_TOL, rtol=0,
                                           err_msg=f"{k}/{path}")


@pytest.mark.parametrize("case", R.ADAMW_CASES)
def test_mesh_adamw_matches_the_jax_update(runs, case):
    ref, ranks = runs
    got = ranks[(0, 0)]["adamw"][case]["f32"]["params"]
    for (path, g), (_, w) in zip(tree_paths(got),
                                 tree_paths(ref["adamw"][case]["jax_f32"])):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=UPDATE_TOL,
                                   rtol=0, err_msg=path)


@pytest.mark.parametrize("case", R.ADAMW_CASES)
def test_mesh_compression_matches_the_one_device_transfer(runs, case):
    ref, ranks = runs
    got = _same_on_every_rank(ranks,
                              lambda r: r["adamw"][case]["compressed"])
    want = ref["adamw"][case]["compressed"]
    for key in ("grads", "residual"):
        for (path, g), (_, w) in zip(tree_paths(got[key]),
                                     tree_paths(want[key])):
            np.testing.assert_allclose(g.numpy(), w.numpy(),
                                       atol=UPDATE_TOL, rtol=0,
                                       err_msg=f"{key}/{path}")
    for (path, g), (_, w) in zip(tree_paths(got["grads"]),
                                 tree_paths(want["jax"])):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=UPDATE_TOL,
                                   rtol=0, err_msg=path)


def test_zero1_cuts_the_moments_over_data(runs):
    """The dense moments take the dp cut on their first free dimension
    (ZeRO-1: the layer axis here), the embedding on its free one; the
    experts, already cut over data, keep their spec."""
    _, ranks = runs
    dense = ranks[(0, 0)]["adamw"]["minicpm-2b"]["opt_specs"]
    assert "'wq': P('data', None, 'model')" in dense
    assert "'embed': P('model', 'data')" in dense
    moe = ranks[(0, 0)]["adamw"]["mixtral-8x7b"]["opt_specs"]
    assert "'w_gate': P(None, None, 'data', 'model')" in moe


def test_pod_mesh_train_steps_match_one_device(runs):
    """``make_train_step`` on pod 2 x data 1 x model 2 (dp = ("pod",
    "data")), as ``tests/test_distributed.py``'s multipod step: the loss
    falls on one batch, and every step's loss and the final parameters
    match the port's one-device steps."""
    ref, ranks = runs
    pod = {(r["pod"]["coords"]["pod"], r["pod"]["coords"]["model"]): r["pod"]
           for r in ranks.values()}
    losses = pod[(0, 0)]["losses"].numpy()
    for r in pod.values():
        assert torch.equal(r["losses"], pod[(0, 0)]["losses"])
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, ref["pod"]["losses"], rtol=LOSS_RTOL,
                               atol=0)
    for (path, g), (_, w) in zip(tree_paths(pod[(0, 0)]["params"]),
                                 tree_paths(ref["pod"]["params"])):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=0,
                                   err_msg=path)


class _Mesh:
    def __init__(self, shape_map):
        self.shape = shape_map
        self.axis_names = tuple(shape_map)


@pytest.mark.parametrize("moments", ["f32", "int8"])
def test_a_jax_opt_state_converts_to_each_ranks_blocks(moments):
    """``convert.shard_opt_state_from_jax`` gives every rank of data 2 x
    model 2 its ZeRO-1 blocks of the JAX package's AdamW state (after a
    step, so that no moment is zero), bit-equal to ``shard_leaf`` of the
    whole state."""
    from repro_torch.convert import shard_opt_state_from_jax
    from repro_torch.distributed.sharding import shard_leaf

    case = "mixtral-8x7b"
    cfg, jcfg = R.case_config(case), _jax_config(case)
    jparams = jax.jit(JT.init_params, static_argnums=1)(
        jax.random.PRNGKey(SEED), jcfg)
    acfg = JA.AdamWConfig(moment_dtype=moments)

    def one_step(p):
        grads = jax.tree.map(lambda x: jnp.full_like(x, 0.01) * (1 + x), p)
        return JA.adamw_update(grads, JA.adamw_init(p, moments), p,
                               jnp.float32(1e-3), acfg)[1]

    state = _np_tree(jax.jit(one_step)(jparams))
    mesh = _Mesh({"data": 2, "model": 2})
    specs = S.train_param_specs(cfg, mesh)
    ospecs = S.train_opt_specs(cfg, mesh, specs, moments)
    for d in range(2):
        for t in range(2):
            coords = {"data": d, "model": t}
            got = shard_opt_state_from_jax(state, cfg, mesh, specs,
                                           coords=coords, torch_device="cpu")
            assert int(got["count"]) == 1
            for k in got:
                if k == "count":
                    continue
                whole = _flat(state[k], "", {})
                for path, block in tree_paths(got[k]):
                    spec = dict(tree_paths(ospecs[k]))[path]
                    want = shard_leaf(whole[f"/{path}"], spec, mesh, coords)
                    assert torch.equal(block, torch.from_numpy(
                        np.array(want))), (k, path)
