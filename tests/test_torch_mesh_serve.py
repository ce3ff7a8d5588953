"""The port's sharded serve step (``make_serve_step(cfg, mesh)``), run by
four gloo ranks on a ``data 2 x model 2`` CPU mesh
(``tests/torch_mesh_ranks.py::serve``) with the JAX package's weights cut
to each rank's blocks (``convert.shard_params_from_jax``), held to the
port's one-device decode and to the JAX one-device decode of the same
weights and tokens: within 1e-4 x max(1, the largest |logit|), with equal
argmax, over 12 steps of an 8-slot ring (steps with an empty second
shard, and after the ring wraps).  Reduced h2o-danube-3-4b (also with the
batch replicated), glm4-9b, mixtral-8x7b (``tp`` experts) and kimi-k2
(``ep`` experts, with and without ``resident_experts``).  The JAX decode
runs in-process (it needs one device); the JAX package's whole sharded
serve step is not a reference (its vocab-sharded embedding gather raises
on the installed JAX).

The families the port does not run on a mesh yet are refused naming the
item that brings them (14d iii-b), in decode, prefill, training and the
forward; prefill, training and the elastic restore of the dense and moe
families run on a mesh (``tests/test_torch_mesh_train.py``,
``tests/test_torch_pipeline.py``), and a malformed mesh or specs are
refused."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from repro.configs import get_arch as jax_get_arch
from repro.models import transformer as JT
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.convert import decode_state_from_jax, params_from_jax
from repro_torch.distributed import step as S
from repro_torch.distributed.sharding import P
from repro_torch.models import transformer as T

ARCHS = sorted({arch for arch, _, _ in R.SERVE_CASES.values()})
SEED = 0


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


def _jax_decode(arch, jparams, jstate, tokens):
    jcfg = jax_get_arch(arch).reduced()
    step = jax.jit(lambda p, s, t: JT.decode_step(p, jcfg, s, t))
    out = []
    for t in tokens:
        logits, jstate = step(jparams, jstate, t)
        out.append(np.asarray(logits))
    return np.stack(out)


def _port_decode(arch, params_np, state_np, tokens):
    cfg = get_arch(arch).reduced()
    params = params_from_jax(params_np, cfg, torch_device="cpu")
    state = decode_state_from_jax(state_np, cfg, torch_device="cpu")
    out = []
    for t in tokens:
        logits, state = T.decode_step(params, cfg, state, torch.from_numpy(t))
        out.append(logits.numpy())
    return np.stack(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's and the port's one-device logits by arch, and the ranks'
    results by (data, model) coordinates.  The ranks run while the JAX
    decode compiles."""
    work = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(SEED)
    arrays, jax_trees = {}, {}
    for arch in ARCHS:
        jcfg = jax_get_arch(arch).reduced()
        jparams = JT.init_params(jax.random.PRNGKey(SEED), jcfg)
        jstate = JT.init_decode_state(jparams, jcfg, R.SERVE["batch"],
                                      R.SERVE["context"])
        tokens = rng.integers(0, jcfg.vocab, (R.SERVE["steps"],
                                              R.SERVE["batch"])
                              ).astype(np.int32)
        _flat(jparams, f"{arch}/params", arrays)
        _flat(jstate, f"{arch}/state", arrays)
        arrays[f"{arch}/tokens"] = tokens
        jax_trees[arch] = (jparams, jstate, tokens)
    np.savez(work / "in.npz", **arrays)
    join = R.start(R.serve, work / "in.npz", work / "ranks")
    ref = {}
    for arch, (jparams, jstate, tokens) in jax_trees.items():
        ref[arch] = {
            "jax": _jax_decode(arch, jparams, jstate, tokens),
            "port": _port_decode(arch, R.unflatten(arrays, f"{arch}/params"),
                                 R.unflatten(arrays, f"{arch}/state"),
                                 tokens)}
    return ref, join()


def _gathered(ranks, case, replicated):
    """The case's logits (steps, batch, V): the data ranks' rows (each
    data rank's whole batch when replicated), the model ranks equal."""
    for d in range(2):
        assert torch.equal(ranks[(d, 0)][case]["logits"],
                           ranks[(d, 1)][case]["logits"])
    if replicated:
        assert torch.equal(ranks[(0, 0)][case]["logits"],
                           ranks[(1, 0)][case]["logits"])
        return ranks[(0, 0)][case]["logits"].numpy()
    return torch.cat([ranks[(d, 0)][case]["logits"] for d in range(2)],
                     dim=1).numpy()


@pytest.mark.parametrize("against", ["port", "jax"])
@pytest.mark.parametrize("case", list(R.SERVE_CASES))
def test_sharded_serve_matches_the_one_device_decode(runs, case, against):
    ref, ranks = runs
    arch, _, replicated = R.SERVE_CASES[case]
    got = _gathered(ranks, case, replicated)
    want = ref[arch][against]
    assert got.shape == want.shape
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("case", list(R.SERVE_CASES))
def test_the_ranks_state_starts_as_a_fresh_one_and_advances(runs, case):
    _, ranks = runs
    for r in ranks.values():
        assert r[case]["state_as_fresh"]
        assert r[case]["cur"] == R.SERVE["steps"]


def test_a_ring_that_does_not_split_is_refused(runs):
    _, ranks = runs
    for r in ranks.values():
        assert "does not split" in r["indivisible_ring"]


class _FakeMesh:
    def __init__(self, shape_map):
        self.shape = shape_map
        self.axis_names = tuple(shape_map)


MESH = _FakeMesh({"data": 2, "model": 2})


@pytest.mark.parametrize("arch", ["mamba2-2_7b", "hymba-1_5b",
                                  "musicgen-large", "llama-3_2-vision-90b"])
def test_families_not_ported_to_a_mesh_are_refused(arch):
    cfg = get_arch(arch).reduced()
    with pytest.raises(NotImplementedError, match="item 14d iii-b"):
        S.make_serve_step(cfg, MESH)
    with pytest.raises(NotImplementedError, match="item 14d iii-b"):
        S.serve_param_specs(cfg, MESH)
    with pytest.raises(NotImplementedError, match="item 14d iii-b"):
        S.init_local_decode_state(cfg, MESH, 4, 8, torch_device="cpu")
    params = T.init_params(cfg, 0, torch_device="cpu")
    frontend = (torch.zeros(1, 8, cfg.d_model) if cfg.cross_attn_every
                else None)
    state = T.init_decode_state(params, cfg, 1, 8, frontend=frontend)
    tokens = torch.zeros((1, cfg.n_codebooks) if cfg.n_codebooks else (1,),
                         dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="item 14d iii-b"):
        T.decode_step(params, cfg, state, tokens,
                      ctx=S.make_mesh_ctx(MESH))


def test_prefill_training_and_restore_on_a_mesh_are_refused(tmp_path):
    """Prefill, training, the loss and the forward on a mesh run for the
    dense and moe families (``tests/test_torch_mesh_train.py``) and still
    refuse the four other families, naming item 14d iii-b; the elastic
    restore runs (``tests/test_torch_pipeline.py``) and refuses specs
    without a mesh, and a mesh that is not one."""
    dense = get_arch("h2o-danube-3-4b").reduced()
    assert S.make_loss_fn(dense, S.make_mesh_ctx(MESH)) is not None
    assert S.train_param_specs(dense, MESH)["blocks"]["wq"] == \
        P(None, None, "model")
    for arch in ("mamba2-2_7b", "hymba-1_5b", "musicgen-large",
                 "llama-3_2-vision-90b"):
        cfg = get_arch(arch).reduced()
        for make in (
                lambda: S.make_prefill_step(cfg, MESH, torch_device="cpu"),
                lambda: S.make_train_step(cfg, MESH, lr_fn=lambda s: 1e-3),
                lambda: S.make_loss_fn(cfg, S.make_mesh_ctx(MESH)),
                lambda: S.train_param_specs(cfg, MESH)):
            with pytest.raises(NotImplementedError, match="item 14d iii-b"):
                make()
        with pytest.raises(NotImplementedError, match="item 14d iii-b"):
            T.forward({}, cfg, {"tokens": torch.zeros((1, 4),
                                                      dtype=torch.long)},
                      ctx=S.make_mesh_ctx(MESH))
    params = T.init_params(dense, 0, torch_device="cpu")
    with pytest.raises(TypeError, match="MeshCtx"):
        T.forward(params, dense,
                  {"tokens": torch.zeros((1, 4), dtype=torch.long)},
                  ctx=MESH)
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"w": torch.zeros(2)})
    with pytest.raises(TypeError, match="not a device mesh"):
        mgr.restore({"w": torch.zeros(2)}, mesh=object())
    with pytest.raises(ValueError, match="mesh="):
        mgr.restore_latest_good({"w": torch.zeros(2)}, specs={"w": None})


def test_a_one_ulp_nudge_moves_int8_codes(tmp_path):
    """``tools/int8_drift.py``, the measurement behind how ``[mesh]`` holds
    its int8 run, at the reduced size on the CPU: nudging every embedding
    one ulp moves float32 logits by rounding only, while int8 caches take
    other codes."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    tool = Path(__file__).resolve().parents[1] / "tools" / "int8_drift.py"
    proc = subprocess.run([sys.executable, str(tool), "--device", "cpu",
                           "--reduced"], capture_output=True, text=True,
                          cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rows = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [r["kv"] for r in rows] == ["model", "int8"]
    assert rows[0]["rel"] < 1e-5 and rows[0]["argmax_agree"] == 1.0
    assert rows[1]["codes_differing"] >= 1 and rows[1]["max_code_diff"] >= 1
    assert rows[1]["rel"] > 100 * rows[0]["rel"]
