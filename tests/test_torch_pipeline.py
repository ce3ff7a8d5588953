"""The port's ``pipeline_forward`` (GPipe over a 4-stage ``pod`` mesh of
four gloo ranks, ``tests/torch_mesh_ranks.py::pipeline``) and its elastic
re-mesh restore (``restore(mesh=, specs=)`` on two ranks,
``tests/torch_mesh_ranks.py::restore``).

* The reference's own case (8 ``tanh(h @ w)`` blocks, x (8, 16), 4
  microbatches) against the JAX package's ``pipeline_forward`` in a
  forced-4-device child (as ``tests/test_distributed.py`` sets it up)
  and against the sequential loop, at rtol = atol = 2e-5; reduced
  minicpm-2b's 8 decoder blocks (2 a stage) against the port's and the
  JAX package's sequential loops at the same tolerance.  Each stage calls
  its blocks once a microbatch (no call on a tick without one), and the
  call under grad is refused naming item 14d iii-c.
* A checkpoint written by the JAX package's ``CheckpointManager`` and
  one written by the port's four ranks (``save(mesh=, specs=)``: one
  writer, a barrier) restore onto ``data 1 x model 2`` and ``data 2 x
  model 1``: every rank's block bit-equal to ``shard_leaf`` of the saved
  leaf."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from repro.checkpoint.manager import CheckpointManager as JaxCheckpoint
from repro.models import transformer as JT
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import params_from_jax
from repro_torch.distributed.sharding import shard_leaf
from repro_torch.models import transformer as T
from repro_torch.tree import tree_paths
from test_torch_reference import run_reference

TOL = dict(rtol=2e-5, atol=2e-5)

CHILD = """
import jax, jax.numpy as jnp
from repro.distributed.pipeline import pipeline_forward
assert len(jax.devices()) == 4
mesh = jax.make_mesh((4,), ("pod",))
def block_fn(h, blk):
    return jnp.tanh(h @ blk["w"])
fn = pipeline_forward(block_fn, mesh, stage_axis="pod", microbatches=4)
with mesh:
    OUT["y"] = np.asarray(jax.jit(fn)(jnp.asarray(IN["x"]),
                                      {"w": jnp.asarray(IN["w"])}))
"""


class _Mesh:
    def __init__(self, shape_map):
        self.shape = shape_map
        self.axis_names = tuple(shape_map)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    P_ = R.PIPE
    inputs = {
        "x": rng.standard_normal((P_["batch"], P_["d"])).astype(np.float32),
        "w": (rng.standard_normal((P_["layers"], P_["d"], P_["d"]))
              * 0.2).astype(np.float32),
        "hidden": (rng.standard_normal((P_["batch"], P_["seq"], 64))
                   ).astype(np.float32),
        "tokens": rng.integers(0, 256, (4, 16)).astype(np.int32),
        "ckpt": np.array(str(work / "port_ckpt")),
        "jax_ckpt": np.array(str(work / "jax_ckpt"))}
    np.savez(work / "in.npz", **inputs)
    join = R.start(R.pipeline, work / "in.npz", work / "ranks",
                   key=lambda r: r["stage"])
    ref = run_reference(CHILD, work, {"x": inputs["x"], "w": inputs["w"]},
                        env={"XLA_FLAGS":
                             "--xla_force_host_platform_device_count=4"})
    # the sequential loops
    seq = inputs["x"]
    for w in inputs["w"]:
        seq = np.tanh(seq @ w)
    ref["sequential"] = seq
    cfg = R.pipe_config()
    params = T.init_params(cfg, 0, torch_device="cpu")
    positions = torch.arange(P_["seq"])[None, :]
    h = torch.from_numpy(inputs["hidden"])
    with torch.no_grad():
        for i in range(cfg.n_layers):
            h = T._block_forward(h, T.layer(params["blocks"], i), cfg,
                                 positions)[0]
    ref["blocks"] = h.numpy()
    jblocks = {k: jnp.asarray(v.numpy()) for k, v in params["blocks"].items()}
    from repro.configs import get_arch as jax_get_arch
    import dataclasses
    jcfg = dataclasses.replace(jax_get_arch("minicpm-2b").reduced(),
                               n_layers=P_["layers"])
    jh = jnp.asarray(inputs["hidden"])
    for i in range(cfg.n_layers):
        jh = JT._block_forward(jh, {k: v[i] for k, v in jblocks.items()},
                               jcfg, jnp.asarray(positions.numpy()), None)[0]
    ref["jax_blocks"] = np.asarray(jh)
    pipe = join()
    # the JAX package's checkpoint of reduced minicpm-2b's parameters
    jparams = JT.init_params(jax.random.PRNGKey(1),
                             jax_get_arch("minicpm-2b").reduced())
    JaxCheckpoint(str(inputs["jax_ckpt"])).save(1, jparams)
    ref["jax_params"] = jparams
    ref["ckpt"] = str(inputs["ckpt"])
    join2 = R.start(R.restore, work / "in.npz", work / "restore", world=2,
                    key=lambda r: r["rank"])
    return ref, pipe, join2()


def test_pipeline_matches_jax_and_the_sequential_loop(runs):
    ref, pipe, _ = runs
    for r in pipe.values():
        got = r["tanh"].numpy()
        np.testing.assert_allclose(got, ref["y"], **TOL)
        np.testing.assert_allclose(got, ref["sequential"], **TOL)


def test_pipeline_of_decoder_blocks_matches_the_sequential_loops(runs):
    ref, pipe, _ = runs
    for r in pipe.values():
        got = r["block"].numpy()
        np.testing.assert_allclose(got, ref["blocks"], **TOL)
        np.testing.assert_allclose(got, ref["jax_blocks"], **TOL)
    assert all(torch.equal(r["block"], pipe[0]["block"])
               for r in pipe.values())


def test_each_stage_runs_its_blocks_once_a_microbatch(runs):
    _, pipe, _ = runs
    per = R.PIPE["microbatches"] * R.PIPE["layers"] // R.PIPE["stages"]
    for r in pipe.values():
        assert r["calls"] == {"tanh": per, "block": per}


def test_pipeline_under_grad_is_refused(runs):
    _, pipe, _ = runs
    for r in pipe.values():
        assert "item 14d iii-c" in r["grad_refusal"]


def _specs(mesh):
    """A duck-typed mesh of the restore's shape, and the train specs of
    reduced minicpm-2b's parameters and moments on it."""
    from repro_torch.distributed import step as S

    n_d, n_m = R.RESTORE_MESHES[mesh]
    fake = _Mesh({"data": n_d, "model": n_m})
    cfg = R.case_config("minicpm-2b")
    specs = S.train_param_specs(cfg, fake)
    return fake, specs, S.train_opt_specs(cfg, fake, specs)


def _blocks_equal(tree, full, specs, mesh, coords):
    for (path, got), (_, spec) in zip(tree_paths(tree), tree_paths(specs)):
        want = shard_leaf(torch.as_tensor(np.asarray(full[path])), spec,
                          mesh, coords)
        assert got.shape == want.shape, path
        assert torch.equal(got, want), path


@pytest.mark.parametrize("mesh", list(R.RESTORE_MESHES))
def test_a_jax_checkpoint_restores_onto_a_new_mesh(runs, mesh):
    ref, _, restored = runs
    cfg = R.case_config("minicpm-2b")
    full = dict(tree_paths(params_from_jax(
        jax.tree.map(np.asarray, ref["jax_params"]), cfg,
        torch_device="cpu")))
    fake, specs, _ = _specs(mesh)
    for r in restored.values():
        res = r[mesh]
        _blocks_equal(res["jax"], full, specs, fake, res["coords"])


@pytest.mark.parametrize("mesh", list(R.RESTORE_MESHES))
def test_a_four_rank_checkpoint_restores_onto_a_new_mesh(runs, mesh):
    ref, _, restored = runs
    any_rank = restored[0][mesh]
    assert any_rank["step"] == 1 and any_rank["extra"] == {"note": "4 ranks"}
    saved, _, _ = CheckpointManager(ref["ckpt"]).restore_flat()
    fake, specs, ospecs = _specs(mesh)
    for r in restored.values():
        res = r[mesh]
        _blocks_equal(res["port"]["params"],
                      {k[len("params/"):]: v for k, v in saved.items()
                       if k.startswith("params/")},
                      specs, fake, res["coords"])
        opt = {k: v for k, v in res["port"]["opt"].items() if k != "count"}
        _blocks_equal(opt, {k[len("opt/"):]: v for k, v in saved.items()
                            if k.startswith("opt/")},
                      {k: v for k, v in ospecs.items() if k != "count"},
                      fake, res["coords"])
        assert int(res["port"]["opt"]["count"]) == 1
