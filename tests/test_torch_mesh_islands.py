"""The port's sequence-sharded decode attention and sharded MoE, run by
four gloo ranks on a ``data 2 x model 2`` CPU mesh
(``tests/torch_mesh_ranks.py::islands``), held within 1e-5 of the JAX
package's ``shard_map`` islands on a forced 4-device CPU mesh (one child
process, ``XLA_FLAGS`` set there only).

Attention runs 12 steps of an 8-slot ring (4 slots a model rank): steps
0-3 leave the second shard empty, step 8 wraps; float32 and int8 caches;
the caches the ranks wrote are held to the reference's too.  The MoE runs
its ``ep``, resident-expert and ``tp`` bodies with 8 experts and capacity
factor 8.  The plain partial and the empty-shard rule are checked
in-process."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from repro.distributed import decode as JD
from repro_torch.distributed import decode as D
from repro_torch.kernels.flash_decode import combine_partials, flash_decode
from test_torch_reference import run_reference

TOL = dict(atol=1e-5, rtol=0)
B, D_MODEL, RING, STEPS = 4, 64, 8, 12
MOE_X = (4, 3, 64)                 # (batch, seq, d_model)

CHILD = """
import jax, jax.numpy as jnp
from repro.configs.base import ArchConfig, MoEConfig
from repro.distributed.decode import decode_attn_sharded
from repro.launch.mesh import make_debug_mesh
from repro.models.moe import MoEParams, moe_ffn_sharded
from repro.models.transformer import MeshCtx
assert len(jax.devices()) == 4
mesh = make_debug_mesh(2, 2)
ctx = MeshCtx(mesh=mesh, dp_axes=("data",), tp_axis="model")
blk = {k: jnp.asarray(IN[k]) for k in ("wq", "wk", "wv", "wo")}
for kv in ("model", "int8"):
    cfg = ArchConfig(name="island", family="dense", n_layers=1, d_model=64,
                     n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                     head_dim=16, kv_dtype=kv)
    k = v = jnp.asarray(IN["k0"])
    sc = ()
    if kv == "int8":
        k = v = k.astype(jnp.int8)
        sc = (jnp.asarray(IN["s0"], jnp.float16),) * 2
    step = jax.jit(lambda x, k, v, cur, *sc: decode_attn_sharded(
        x, blk, cfg, k, v, cur, ctx, *sc))
    ys = []
    for t, x in enumerate(IN["attn_x"]):
        res = step(jnp.asarray(x), k, v, jnp.int32(t), *sc)
        ys.append(res[0])
        k, v = res[1], res[2]
        sc = tuple(res[3:])
    OUT[f"attn_{kv}_y"] = np.stack([np.asarray(y) for y in ys])
    OUT[f"attn_{kv}_k"], OUT[f"attn_{kv}_v"] = np.asarray(k), np.asarray(v)
    for i, s in enumerate(sc):
        OUT[f"attn_{kv}_s{i}"] = np.asarray(s).astype(np.float32)
p = MoEParams(*(jnp.asarray(IN[f"moe_{n}"])
                for n in ("router", "w_gate", "w_up", "w_down")))
for case, (sharding, resident) in CASES.items():
    mcfg = MoEConfig(n_experts=8, top_k=2, d_expert=32, sharding=sharding,
                     capacity_factor=8.0)
    y, aux = moe_ffn_sharded(jnp.asarray(IN["moe_x"]), p, mcfg, mesh,
                             ("data",), "model", resident_experts=resident)
    OUT[f"moe_{case}_y"], OUT[f"moe_{case}_aux"] = np.asarray(y), float(aux)
"""


def _inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)

    def normal(shape, std=1.0):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    hd, H, KV, E, F = 16, 4, 2, 8, 32
    return {"attn_x": normal((STEPS, B, D_MODEL)),
            "wq": normal((D_MODEL, H * hd), D_MODEL ** -0.5),
            "wk": normal((D_MODEL, KV * hd), D_MODEL ** -0.5),
            "wv": normal((D_MODEL, KV * hd), D_MODEL ** -0.5),
            "wo": normal((H * hd, D_MODEL), (H * hd) ** -0.5),
            "k0": np.zeros((B, RING, KV, hd), np.float32),
            "s0": np.zeros((B, RING, KV), np.float32),
            "moe_x": normal(MOE_X),
            "moe_router": normal((D_MODEL, E), D_MODEL ** -0.5),
            "moe_w_gate": normal((E, D_MODEL, F), D_MODEL ** -0.5),
            "moe_w_up": normal((E, D_MODEL, F), D_MODEL ** -0.5),
            "moe_w_down": normal((E, F, D_MODEL), F ** -0.5)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX islands' outputs, the four ranks' results by (data, model)
    coordinates); the ranks run while the JAX child does."""
    work = tmp_path_factory.mktemp("islands")
    inputs = _inputs()
    np.savez(work / "in.npz", **inputs)
    join = R.start(R.islands, work / "in.npz", work / "ranks")
    ref = run_reference(f"CASES = {R.MOE_CASES!r}\n" + CHILD, work, inputs,
                        env={"XLA_FLAGS":
                             "--xla_force_host_platform_device_count=4"})
    return ref, join()


def _rows(ranks, key, field):
    """A result's rows (batch over data) from the model-rank-0 ranks, after
    checking that the model ranks agree bit for bit."""
    for d in range(2):
        assert torch.equal(ranks[(d, 0)][key][field], ranks[(d, 1)][key][field])
    return torch.cat([ranks[(d, 0)][key][field] for d in range(2)],
                     dim=1 if key.startswith("attn") else 0).numpy()


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("kv", ["model", "int8"])
def test_decode_attn_sharded_matches_the_jax_island(runs, kv, step):
    """Steps 0-3 have an empty second shard, 8-11 come after the wrap."""
    ref, ranks = runs
    got = _rows(ranks, f"attn_{kv}", "y")[step]
    np.testing.assert_allclose(got, ref[f"attn_{kv}_y"][step], **TOL)


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_the_owning_shards_wrote_the_reference_caches(runs, kv):
    ref, ranks = runs
    for i, name in enumerate(("k", "v")):
        full = torch.cat([torch.cat([ranks[(d, t)][f"attn_{kv}"][name]
                                     for t in range(2)], dim=1)
                          for d in range(2)], dim=0).float().numpy()
        np.testing.assert_allclose(full, ref[f"attn_{kv}_{name}"].astype(
            np.float32), **TOL)
        if kv == "int8":
            scales = torch.cat([torch.cat(
                [ranks[(d, t)][f"attn_{kv}"]["scales"][i] for t in range(2)],
                dim=1) for d in range(2)], dim=0).float().numpy()
            np.testing.assert_array_equal(scales, ref[f"attn_{kv}_s{i}"])


@pytest.mark.parametrize("case", list(R.MOE_CASES))
def test_moe_ffn_sharded_matches_the_jax_island(runs, case):
    ref, ranks = runs
    assert ranks[(0, 0)][f"moe_{case}"]["mode"] == {
        "ep": "ep", "ep_resident": "resident", "tp": "tp"}[case]
    np.testing.assert_allclose(_rows(ranks, f"moe_{case}", "y"),
                               ref[f"moe_{case}_y"], **TOL)
    for r in ranks.values():
        np.testing.assert_allclose(float(r[f"moe_{case}"]["aux"]),
                                   float(ref[f"moe_{case}_aux"]), **TOL)


# ------------------------------------------------ in-process, no ranks
@pytest.mark.parametrize("n_valid", [0, 1, 3, 4])
def test_partial_attn_matches_the_reference(n_valid):
    rng = np.random.default_rng(n_valid)
    q = rng.standard_normal((2, 4, 16)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 4, 2, 16)).astype(np.float32)
              for _ in range(2))
    got = D._partial_attn(torch.from_numpy(q), torch.from_numpy(kc),
                          torch.from_numpy(vc), n_valid)
    want = JD._partial_attn(q, kc, vc, n_valid)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    if n_valid:       # the kernel's path gives the same partial
        for g, k in zip(got, D.local_partial(
                torch.from_numpy(q), torch.from_numpy(kc),
                torch.from_numpy(vc), n_valid)):
            np.testing.assert_allclose(k.numpy(), g.numpy(), rtol=1e-6,
                                       atol=1e-6)


def test_an_empty_shard_runs_no_kernel_and_weighs_nothing(monkeypatch):
    """n_local = 0 never reaches the kernel (which refuses n_valid < 1):
    its partial merges with weight exactly 0, so a full shard merged with
    an empty one gives, bit for bit, the full shard merged alone."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((2, 4, 16)).astype(np.float32))
    kc, vc = (torch.from_numpy(rng.standard_normal((2, 4, 2, 16)).astype(
        np.float32)) for _ in range(2))
    full = flash_decode(q, kc, vc, 3)

    def refuse(*args, **kwargs):
        raise AssertionError("the kernel was called for an empty shard")

    monkeypatch.setattr(D, "flash_decode", refuse)
    monkeypatch.setattr(D, "flash_decode_int8", refuse)
    out, m, l = D.local_partial(q, kc, vc, 0)
    assert not out.any() and not l.any() and bool((m == -1e30).all())
    merged = combine_partials(torch.stack([full[0], out]),
                              torch.stack([full[1], m]),
                              torch.stack([full[2], l]))
    alone = combine_partials(*(t[None] for t in full))
    assert torch.equal(merged, alone)
    with pytest.raises(AssertionError, match="empty shard"):
        D.local_partial(q, kc, vc, 1)


@pytest.mark.parametrize("cur", range(10))
def test_shard_fill_is_the_reference_clip(cur):
    ring, n_tp = 8, 2
    for tpi in range(n_tp):
        want = int(np.clip(min(cur + 1, ring) - tpi * (ring // n_tp), 0,
                           ring // n_tp))
        assert D.shard_fill(cur, ring, n_tp, tpi) == want
