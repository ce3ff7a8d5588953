"""The port's sharding rules (``repro_torch.distributed.sharding``) held
spec for spec against the JAX package's (``repro.distributed.sharding``),
for all ten configurations on duck-typed 16 x 16 and 2 x 16 x 16 meshes
(axis names and sizes only, as ``tests/test_sharding_rules.py`` does: no
ranks), leaf paths included; the cut of a tensor to a rank's block; the
configs' shapes and cells; and ``launch/mesh.py``'s refusals.  The
shapes come from ``jax.eval_shape`` and the port's shape tables: nothing
full-size is allocated."""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import base as jbase
from repro.configs import get_arch as jax_get_arch
from repro.distributed import sharding as JS
from repro.models.transformer import init_decode_state as jax_init_state
from repro.models.transformer import init_params as jax_init_params
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro_torch.configs import base as tbase
from repro_torch.configs import ARCH_IDS, SHAPES, cell_applicable, get_arch
from repro_torch.distributed import sharding as TS
from repro_torch.distributed.step import plan_shardings
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import adamw_init
from repro_torch.tree import tree_map

KEY = jax.random.PRNGKey(0)


class _FakeMesh:
    """Duck-typed mesh: axis sizes and names, no devices."""

    def __init__(self, shape_map):
        self.shape = shape_map
        self.axis_names = tuple(shape_map)


MESHES = {"16x16": _FakeMesh({"data": 16, "model": 16}),
          "2x16x16": _FakeMesh({"pod": 2, "data": 16, "model": 16})}
CASES = [(a, m) for a in ARCH_IDS for m in MESHES]
DECODE = dict(batch=128, context=32_768)      # SHAPES["decode_32k"]


def _flat_ref(tree) -> dict:
    """{``_path_str``: spec tuple} of a JAX spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {JS._path_str(p): tuple(s) for p, s in leaves}


def _flat_port(tree) -> dict:
    out = {}
    TS.map_with_path(lambda p, s: out.__setitem__(p, tuple(s)), tree)
    return out


@functools.lru_cache(maxsize=None)
def _shapes(arch: str):
    """(JAX parameter shapes, the port's) of one full-size config."""
    jcfg = jax_get_arch(arch)
    jshapes = jax.eval_shape(lambda k: jax_init_params(k, jcfg, jnp.float32),
                             KEY)
    return jshapes, T.param_shapes(get_arch(arch))


@functools.lru_cache(maxsize=None)
def _opt(arch: str, moments: str):
    """(JAX AdamW state shapes, the port's, on meta tensors)."""
    jshapes, shapes = _shapes(arch)
    jopt = jax.eval_shape(lambda p: jax_adamw_init(p, moments), jshapes)
    meta = tree_map(lambda s: torch.empty(s, device="meta"), shapes)
    return jopt, adamw_init(meta, moments)


def _no_dtypes(layout):
    return {k: _no_dtypes(v) if isinstance(v, dict) else v[0]
            for k, v in layout.items()}


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch,mesh", CASES)
def test_param_specs_equal_the_reference(arch, mesh, kind):
    jshapes, shapes = _shapes(arch)
    m = MESHES[mesh]
    want = _flat_ref(JS.param_specs(jshapes, jax_get_arch(arch), m,
                                    kind=kind))
    got = _flat_port(TS.param_specs(shapes, get_arch(arch), m, kind=kind))
    assert got == want


@pytest.mark.parametrize("arch,mesh", CASES)
def test_fsdp_param_specs_equal_the_reference(arch, mesh):
    jshapes, shapes = _shapes(arch)
    m = MESHES[mesh]
    want = _flat_ref(JS.fsdp_param_specs(jshapes, jax_get_arch(arch), m))
    got = _flat_port(TS.fsdp_param_specs(shapes, get_arch(arch), m))
    assert got == want
    # the axes subset of the reference's own test
    want = _flat_ref(JS.fsdp_param_specs(jshapes, jax_get_arch(arch), m,
                                         axes=("model",)))
    got = _flat_port(TS.fsdp_param_specs(shapes, get_arch(arch), m,
                                         axes=("model",)))
    assert got == want


@pytest.mark.parametrize("moments", ["f32", "int8"])
@pytest.mark.parametrize("arch,mesh", CASES)
def test_opt_state_specs_equal_the_reference(arch, mesh, moments):
    jshapes, shapes = _shapes(arch)
    jopt, opt = _opt(arch, moments)
    m = MESHES[mesh]
    jps = JS.param_specs(jshapes, jax_get_arch(arch), m)
    ps = TS.param_specs(shapes, get_arch(arch), m)
    want = _flat_ref(JS.opt_state_specs(jopt, jps, m))
    got = _flat_port(TS.opt_state_specs(opt, ps, m))
    assert got == want
    assert (_flat_port(TS.opt_state_specs(opt, ps, m, zero1=False))
            == _flat_ref(JS.opt_state_specs(jopt, jps, m, zero1=False)))


@pytest.mark.parametrize("arch,mesh", CASES)
def test_batch_specs_equal_the_reference(arch, mesh):
    m = MESHES[mesh]
    for kind in ("train", "prefill", "decode"):
        for rep in (False, True):
            want = JS.batch_spec(jax_get_arch(arch), JS.MeshAxes.for_mesh(m),
                                 kind, rep)
            got = TS.batch_spec(get_arch(arch), TS.MeshAxes.for_mesh(m), kind,
                                rep)
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("arch,mesh", CASES)
def test_decode_state_specs_equal_the_reference(arch, mesh):
    """float32 and int8 caches, batch over dp or replicated, a ring that
    splits over the model axis and one that does not (and a vlm's cross
    keys and values over a frontend)."""
    jcfg, cfg = jax_get_arch(arch), get_arch(arch)
    m = MESHES[mesh]
    jshapes, _ = _shapes(arch)
    T_f = 1600 if cfg.cross_attn_every else 0
    for kv in ("model", "int8"):
        if kv == "int8" and (cfg.cross_attn_every or not cfg.n_heads):
            continue
        jc, c = (dataclasses.replace(x, kv_dtype=kv) for x in (jcfg, cfg))
        for context in (DECODE["context"], 1000):       # 1000 % 16 != 0
            if T_f:
                front = jax.ShapeDtypeStruct((DECODE["batch"], T_f,
                                              cfg.d_model), jnp.float32)
                jstate = jax.eval_shape(
                    lambda p, f: jax_init_state(p, jc, DECODE["batch"],
                                                context, frontend=f),
                    jshapes, front)
            else:
                jstate = jax.eval_shape(
                    lambda: jax_init_state(None, jc, DECODE["batch"],
                                           context))
            state = _no_dtypes(T.decode_state_layout(
                c, DECODE["batch"], context, frontend_tokens=T_f))
            for rep in (False, True):
                want = _flat_ref(JS.decode_state_specs(jstate, jc, m,
                                                       batch_replicated=rep))
                got = _flat_port(TS.decode_state_specs(
                    {"cur": (), **state}, c, m, batch_replicated=rep))
                assert got == want, (kv, context, rep)


def test_plan_shardings_matches_the_reference():
    cfg, jcfg = get_arch("kimi-k2-1t-a32b"), jax_get_arch("kimi-k2-1t-a32b")
    m = MESHES["2x16x16"]
    jshapes, shapes = _shapes("kimi-k2-1t-a32b")
    jopt, opt = _opt("kimi-k2-1t-a32b", "f32")
    from repro.distributed.step import plan_shardings as jax_plan
    want = jax_plan(jcfg, m, jshapes, jopt, kind="decode")
    got = plan_shardings(cfg, m, shapes, opt, kind="decode")
    assert _flat_port(got.params) == _flat_ref(want.params)
    assert _flat_port(got.opt_state) == _flat_ref(want.opt_state)
    assert got.decode_state is None and want.decode_state is None
    assert {k: tuple(v) for k, v in got.batch.items()} == \
        {k: tuple(v) for k, v in want.batch.items()}


def test_the_plans_local_cut_is_each_leafs_block():
    """``ShardingPlan.local`` (the reference's ``named`` + ``device_put``)
    gives every leaf of a parameter tree its block under the plan's spec,
    and the blocks of the four ranks of a 2 x 2 mesh put the leaf back."""
    cfg = get_arch("mixtral-8x7b").reduced()
    mesh = _FakeMesh({"data": 2, "model": 2})
    params = T.init_params(cfg, 0, torch_device="cpu")
    plan = plan_shardings(cfg, mesh, params, kind="decode")
    blocks = {(d, t): plan.local(mesh, plan.params, params,
                                 {"data": d, "model": t})
              for d in range(2) for t in range(2)}
    cut = 0
    for path, spec in _flat_port(plan.params).items():
        keys = path.strip(".").split(".")
        full = functools.reduce(lambda n, k: n[k], keys, params)
        for (d, t), tree in blocks.items():
            got = functools.reduce(lambda n, k: n[k], keys, tree)
            want = TS.shard_leaf(full, spec, mesh, {"data": d, "model": t})
            assert torch.equal(got, want), path
        cut += spec != TS.P(*(None,) * full.dim())
    assert cut >= 4            # wq / wk / wv / wo at least are cut


def test_spec_normalises_as_jax_does():
    assert tuple(TS.P(None, ("data",), (), ("pod", "data"), "model")) == \
        tuple(JP(None, ("data",), (), ("pod", "data"), "model"))
    assert TS.P("model", None) == ("model", None)


@pytest.mark.parametrize("spec", [TS.P("data", "model"),
                                  TS.P(None, ("data", "model")),
                                  TS.P(("model", "data"), None), TS.P()])
def test_blocks_tile_the_tensor(spec):
    """Every rank's block of a 2 x 2 mesh, put back by its slices, gives
    the whole tensor once; axes listed together cut row-major."""
    mesh = _FakeMesh({"data": 2, "model": 2})
    full = np.arange(8 * 12).reshape(8, 12)
    seen = np.zeros_like(full)
    for d in range(2):
        for t in range(2):
            coords = {"data": d, "model": t}
            sl = TS.block_slices(full.shape, spec, mesh, coords)
            block = TS.shard_leaf(full, spec, mesh, coords)
            np.testing.assert_array_equal(block, full[sl])
            seen[sl] += 1
            assert block.shape == TS.local_shape(full.shape, spec, mesh)
    # replicated: every rank holds it all; cut: each element once
    assert (seen == (4 if spec == TS.P() else 1)).all()
    if spec == TS.P(None, ("data", "model")):
        # rank (d, t) holds the (2 d + t)-th quarter of the columns
        block = TS.shard_leaf(full, spec, mesh, {"data": 1, "model": 0})
        np.testing.assert_array_equal(block, full[:, 6:9])


def test_a_spec_that_does_not_divide_is_refused():
    mesh = _FakeMesh({"data": 2, "model": 4})
    with pytest.raises(ValueError, match="does not split"):
        TS.block_slices((6, 8), TS.P("model", None), mesh,
                        {"data": 0, "model": 0})


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_shapes_and_cells_equal_the_reference(arch):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.sub_quadratic == jcfg.sub_quadratic
    assert cfg.is_attention_free == jcfg.is_attention_free
    assert set(SHAPES) == set(jbase.SHAPES)
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            jbase.SHAPES[name])
        assert cell_applicable(cfg, shape) == jbase.cell_applicable(
            jcfg, jbase.SHAPES[name])
    assert tbase.ShapeConfig("x", 1, 1, "decode").kind == "decode"


def test_meshes_need_a_process_group_of_their_size(tmp_path):
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        launch_mesh.make_debug_mesh(2, 2, device_type="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 4 ranks.*has 1"):
            launch_mesh.make_debug_mesh(2, 2, device_type="cpu")
        with pytest.raises(ValueError, match="needs 256 ranks"):
            launch_mesh.make_production_mesh(device_type="cpu")
        with pytest.raises(ValueError, match="needs 512 ranks"):
            launch_mesh.make_production_mesh(multi_pod=True,
                                             device_type="cpu")
        mesh = launch_mesh.make_debug_mesh(1, 1, device_type="cpu")
        assert TS.mesh_shape(mesh) == {"data": 1, "model": 1}
        assert TS.MeshAxes.for_mesh(mesh) == TS.MeshAxes(("data",), "model")
        assert TS.mesh_coords(mesh) == {"data": 0, "model": 0}
    finally:
        dist.destroy_process_group()
