"""Rank functions of the port's mesh tests (no pytest, no JAX): each runs
in a process of ``repro_torch.launch.mesh.run_local_ranks`` on a gloo
``data 2 x model 2`` CPU mesh, reads its inputs from an ``.npz`` file,
cuts its blocks and returns its results as tensors.

``islands`` runs ``decode_attn_sharded`` (float32 and int8 caches) over
the steps of a ring and ``moe_ffn_sharded`` in its three bodies;
``serve`` runs ``make_serve_step`` on the weights of the JAX package's
``init_params``."""

from __future__ import annotations

import threading

import numpy as np
import torch

MESH_SHAPE = (2, 2)


def start(fn, path, workdir, timeout_s: float = 300):
    """Run ``fn`` on four ranks in a thread of this process (so that the
    caller computes its reference meanwhile); the returned ``join()``
    gives the ranks' results by (data, model) coordinates, or raises what
    the ranks raised."""
    from repro_torch.launch.mesh import run_local_ranks

    box: dict = {}

    def run():
        try:
            box["out"] = run_local_ranks(fn, 4, workdir, args=(str(path),),
                                         timeout_s=timeout_s)
        except BaseException as exc:        # re-raised by join()
            box["error"] = exc

    thread = threading.Thread(target=run)
    thread.start()

    def join():
        thread.join(timeout_s + 60)
        assert not thread.is_alive(), "the mesh ranks did not finish"
        if "error" in box:
            raise box["error"]
        return {(r["coords"]["data"], r["coords"]["model"]): r
                for r in box["out"]}

    return join


def _mesh():
    from repro_torch.distributed.sharding import mesh_coords
    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh(*MESH_SHAPE, device_type="cpu")
    return mesh, mesh_coords(mesh)


def unflatten(arrays: dict, prefix: str) -> dict:
    """The nested dict of the ``prefix/a/b`` keys of ``arrays``."""
    out: dict = {}
    for key, a in arrays.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        *parents, leaf = key[len(prefix) + 1:].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = a
    return out


def attn_config(kv_dtype: str = "model"):
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(name="island", family="dense", n_layers=1, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                      head_dim=16, kv_dtype=kv_dtype)


def moe_config(sharding: str):
    from repro_torch.configs.base import MoEConfig

    return MoEConfig(n_experts=8, top_k=2, d_expert=32, sharding=sharding,
                     capacity_factor=8.0)


MOE_CASES = {"ep": ("ep", False), "ep_resident": ("ep", True),
             "tp": ("tp", False)}


def islands(rank: int, path: str) -> dict:
    from repro_torch.distributed.decode import decode_attn_sharded
    from repro_torch.distributed.sharding import P, shard_leaf
    from repro_torch.distributed.step import make_mesh_ctx
    from repro_torch.models.moe import expert_specs, moe_ffn_sharded, moe_mode

    mesh, coords = _mesh()
    ctx = make_mesh_ctx(mesh)
    IN = dict(np.load(path))

    def cut(a, spec):
        return torch.from_numpy(np.array(shard_leaf(a, spec, mesh, coords)))

    out: dict = {"coords": coords}
    blk = {k: cut(IN[k], spec) for k, spec in
           (("wq", P(None, "model")), ("wk", P(None, "model")),
            ("wv", P(None, "model")), ("wo", P("model", None)))}
    cache = P("data", "model", None, None)
    for kv in ("model", "int8"):
        cfg = attn_config(kv)
        k = cut(IN["k0"], cache)
        v = cut(IN["k0"], cache)
        scales = ()
        if kv == "int8":
            k, v = k.to(torch.int8), v.to(torch.int8)
            scales = tuple(cut(IN["s0"], P("data", "model", None)).half()
                           for _ in range(2))
        ys = []
        for t, x in enumerate(IN["attn_x"]):
            ys.append(decode_attn_sharded(cut(x, P("data", None)), blk, cfg,
                                          k, v, t, ctx, *scales))
        out[f"attn_{kv}"] = {"y": torch.stack(ys), "k": k, "v": v,
                             "scales": list(scales)}
    for case, (sharding, resident) in MOE_CASES.items():
        mcfg = moe_config(sharding)
        mode = moe_mode(mcfg, MESH_SHAPE[1], resident)
        specs = expert_specs(mode, ("data",), "model")
        p = {name: cut(IN[f"moe_{name}"], spec)
             for name, spec in specs.items()}
        y, aux = moe_ffn_sharded(cut(IN["moe_x"], P("data", None, None)), p,
                                 mcfg, mesh, ("data",), "model",
                                 resident_experts=resident)
        out[f"moe_{case}"] = {"y": y, "aux": aux, "mode": mode}
    return out


SERVE_CASES = {"h2o-danube-3-4b": ("h2o-danube-3-4b", False, False),
               "h2o-danube-3-4b-batch-replicated": ("h2o-danube-3-4b",
                                                    False, True),
               "glm4-9b": ("glm4-9b", False, False),
               "mixtral-8x7b": ("mixtral-8x7b", False, False),
               "kimi-k2": ("kimi-k2-1t-a32b", False, False),
               "kimi-k2-resident": ("kimi-k2-1t-a32b", True, False)}
SERVE = dict(batch=4, context=8, steps=12)


def serve(rank: int, path: str) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.convert import (shard_decode_state_from_jax,
                                     shard_params_from_jax)
    from repro_torch.distributed import step as S

    mesh, coords = _mesh()
    IN = dict(np.load(path))
    out: dict = {"coords": coords}
    b_loc = SERVE["batch"] // MESH_SHAPE[0]
    for case, (arch, resident, replicated) in SERVE_CASES.items():
        cfg = get_arch(arch).reduced()
        specs = S.serve_param_specs(cfg, mesh, resident_experts=resident,
                                    batch_replicated=replicated)
        params = shard_params_from_jax(unflatten(IN, f"{arch}/params"), cfg,
                                       mesh, specs, torch_device="cpu")
        state = shard_decode_state_from_jax(
            unflatten(IN, f"{arch}/state"), cfg, mesh,
            batch_replicated=replicated, torch_device="cpu")
        fresh = S.init_local_decode_state(cfg, mesh, SERVE["batch"],
                                          SERVE["context"],
                                          batch_replicated=replicated,
                                          torch_device="cpu")
        same = all(torch.equal(state[k], fresh[k]) for k in fresh
                   if k != "cur")
        step = S.make_serve_step(cfg, mesh, batch_replicated=replicated,
                                 resident_experts=resident)
        tokens = torch.from_numpy(IN[f"{arch}/tokens"])
        if not replicated:
            d = coords["data"]
            tokens = tokens[:, d * b_loc:(d + 1) * b_loc]
        logits = []
        for t in range(SERVE["steps"]):
            lg, state = step(params, state, tokens[t])
            logits.append(lg)
        out[case] = {"logits": torch.stack(logits), "state_as_fresh": same,
                     "cur": state["cur"]}
    # a ring that does not split over the model axis is refused, not laid
    # out another way (the reference's shard_map refuses it)
    try:
        S.init_local_decode_state(get_arch("glm4-9b").reduced(), mesh,
                                  SERVE["batch"], 7, torch_device="cpu")
        out["indivisible_ring"] = ""
    except ValueError as exc:
        out["indivisible_ring"] = str(exc)
    return out




def serve_card(rank: int, arch: str, steps: int) -> dict:
    """The sharded serve step of a reduced ``arch`` on the card (every
    rank on ``cuda:0``), seeded weights: logits and kernel launches."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import step as S
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch.mesh import make_debug_mesh

    torch.cuda.set_device(0)
    mesh = make_debug_mesh(*MESH_SHAPE)
    cfg = get_arch(arch).reduced()
    params = S.init_local_params(cfg, 0, mesh)
    state = S.init_local_decode_state(cfg, mesh, SERVE["batch"],
                                      SERVE["context"])
    step = S.make_serve_step(cfg, mesh)
    b_loc = SERVE["batch"] // MESH_SHAPE[0]
    d = mesh.get_local_rank("data")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (steps, SERVE["batch"])))[:, d * b_loc:(d + 1) * b_loc]
    fd.reset_launches()
    logits = []
    for t in range(steps):
        lg, state = step(params, state, tokens[t].cuda())
        logits.append(lg.cpu())
    return {"coords": {"data": d, "model": mesh.get_local_rank("model")},
            "logits": torch.stack(logits), "launches": dict(fd.LAUNCHES)}
