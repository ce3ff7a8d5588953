"""Rank functions of the port's mesh tests (no pytest, no JAX): each runs
in a process of ``repro_torch.launch.mesh.run_local_ranks`` on a gloo
``data 2 x model 2`` CPU mesh, reads its inputs from an ``.npz`` file,
cuts its blocks and returns its results as tensors.

``islands`` runs ``decode_attn_sharded`` (float32 and int8 caches) over
the steps of a ring and ``moe_ffn_sharded`` in its three bodies;
``serve`` runs ``make_serve_step`` on the weights of the JAX package's
``init_params``; ``train`` runs the mesh forward, loss and gradients on
those weights, the mesh AdamW and compression, and train steps on a pod
mesh; ``pipeline`` runs ``pipeline_forward`` over a 4-stage ``pod`` mesh
and saves a sharded checkpoint; ``restore`` (two ranks) restores
checkpoints onto ``data 1 x model 2`` and ``data 2 x model 1``."""

from __future__ import annotations

import threading

import numpy as np
import torch

MESH_SHAPE = (2, 2)


def start(fn, path, workdir, timeout_s: float = 300, world: int = 4,
          key=None):
    """Run ``fn`` on ``world`` ranks in a thread of this process (so that
    the caller computes its reference meanwhile); the returned ``join()``
    gives the ranks' results by ``key(result)`` (their (data, model)
    coordinates when not given), or raises what the ranks raised."""
    from repro_torch.launch.mesh import run_local_ranks

    box: dict = {}

    def run():
        try:
            box["out"] = run_local_ranks(fn, world, workdir,
                                         args=(str(path),),
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
        if key is not None:
            return {key(r): r for r in box["out"]}
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


# ------------------------------------------------------------ training
TRAIN = dict(batch=4, seq=16, lr=3e-3)
MOE8 = dict(n_experts=8, capacity_factor=8.0)
# (arch, overrides of reduced(), MoE overrides) of the mesh forward
FORWARD_CASES = {"minicpm-2b": ("minicpm-2b", {}, {}),
                 "h2o-danube-3-4b": ("h2o-danube-3-4b", {}, {}),
                 "mixtral-8x7b": ("mixtral-8x7b", {}, MOE8),
                 "kimi-k2": ("kimi-k2-1t-a32b", {}, MOE8),
                 # one KV head over two model ranks: the cut falls in it
                 "minicpm-2b-kv1": ("minicpm-2b", {"n_kv_heads": 1}, {})}
# (forward case, fully sharded specs, accum_steps, remat_policy) of the
# gradients
GRAD_CASES = {"minicpm-2b": ("minicpm-2b", False, 1, None),
              "minicpm-2b/fsdp": ("minicpm-2b", True, 1, None),
              "minicpm-2b/accum2": ("minicpm-2b", False, 2, None),
              "minicpm-2b/dots": ("minicpm-2b", False, 1, "dots"),
              "minicpm-2b-kv1": ("minicpm-2b-kv1", False, 1, None),
              "h2o-danube-3-4b/accum2": ("h2o-danube-3-4b", False, 2, None),
              "mixtral-8x7b": ("mixtral-8x7b", False, 1, None),
              "mixtral-8x7b/fsdp": ("mixtral-8x7b", True, 1, None),
              "kimi-k2": ("kimi-k2", False, 1, None),
              "kimi-k2/fsdp": ("kimi-k2", True, 1, None)}
ADAMW_CASES = ("minicpm-2b", "mixtral-8x7b")
ADAMW_STEPS = 2
POD_STEPS = 3


def case_config(case: str):
    """The port's config of a forward case."""
    import dataclasses

    from repro_torch.configs import get_arch

    arch, over, moe = FORWARD_CASES[case]
    cfg = get_arch(arch).reduced(**over)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


def _unshard(tree, specs, mesh):
    from repro_torch.distributed.sharding import unshard_tree
    return unshard_tree(tree, specs, mesh)


def _train_mesh(rank: int, path: str) -> dict:
    """The data 2 x model 2 part of ``train``."""
    from repro_torch.convert import shard_params_from_jax
    from repro_torch.distributed import step as S
    from repro_torch.distributed.sharding import P, unshard_leaf
    from repro_torch.optim import adamw as A
    from repro_torch.optim import compression as C

    mesh, coords = _mesh()
    IN = dict(np.load(path))
    tokens = S.local_batch({"tokens": torch.from_numpy(IN["tokens"])},
                           mesh)
    out: dict = {"coords": coords, "forward": {}, "grads": {}, "adamw": {}}
    for case in FORWARD_CASES:
        cfg = case_config(case)
        specs = S.train_param_specs(cfg, mesh)
        params = shard_params_from_jax(unflatten(IN, f"{case}/params"), cfg,
                                       mesh, specs, torch_device="cpu")
        logits = S.make_prefill_step(cfg, mesh, torch_device="cpu")(params,
                                                                     tokens)
        out["forward"][case] = unshard_leaf(logits, P(("data",), None,
                                                      "model"), mesh)
    for label, (case, fsdp, accum, policy) in GRAD_CASES.items():
        cfg = case_config(case)
        specs = S.train_param_specs(cfg, mesh, fsdp=fsdp)
        params = shard_params_from_jax(unflatten(IN, f"{case}/params"), cfg,
                                       mesh, specs, torch_device="cpu")
        loss, grads = S.make_grad_fn(cfg, mesh, specs=specs,
                                     accum_steps=accum,
                                     remat_policy=policy)(params, tokens)
        out["grads"][label] = {"loss": loss,
                               "grads": _unshard(grads, specs, mesh)}
    for case in ADAMW_CASES:
        cfg = case_config(case)
        specs = S.train_param_specs(cfg, mesh)
        whole = unflatten(IN, f"adamw/{case}/params")
        grads = shard_params_from_jax(unflatten(IN, f"adamw/{case}/grads"),
                                      cfg, mesh, specs, torch_device="cpu")
        res = {}
        for moments in ("f32", "int8"):
            params = shard_params_from_jax(whole, cfg, mesh, specs,
                                           torch_device="cpu")
            state = S.init_local_opt_state(cfg, mesh, specs, moments,
                                           torch_device="cpu")
            ospecs = S.train_opt_specs(cfg, mesh, specs, moments)
            acfg = A.AdamWConfig(moment_dtype=moments)
            for _ in range(ADAMW_STEPS):
                A.adamw_update(grads, state, params, TRAIN["lr"], acfg,
                               mesh=mesh, specs=specs, opt_specs=ospecs)
            res[moments] = {"params": _unshard(params, specs, mesh),
                            "opt": {k: _unshard(v, ospecs[k], mesh)
                                    for k, v in state.items()
                                    if k != "count"},
                            "count": state["count"]}
        comp = C.compress_init(grads)
        for _ in range(2):
            deq, comp = C.compressed_gradients(grads, comp, mesh=mesh,
                                               specs=specs)
        res["compressed"] = {"grads": _unshard(deq, specs, mesh),
                             "residual": _unshard(comp.residual, specs,
                                                  mesh)}
        res["opt_specs"] = repr(S.train_opt_specs(cfg, mesh, specs, "f32"))
        out["adamw"][case] = res
    return out


def _train_pod(rank: int) -> dict:
    """3 train steps of reduced minicpm-2b on pod 2 x data 1 x model 2,
    seeded weights and batch."""
    from repro_torch.distributed import step as S
    from repro_torch.distributed.sharding import mesh_coords
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim.schedules import wsd_schedule

    mesh = make_debug_mesh(1, 2, n_pod=2, device_type="cpu")
    cfg = case_config("minicpm-2b")
    specs = S.train_param_specs(cfg, mesh)
    params = S.init_local_params(cfg, 3, mesh, specs, torch_device="cpu")
    opt = S.init_local_opt_state(cfg, mesh, specs, torch_device="cpu")
    step = S.make_train_step(cfg, mesh, lr_fn=wsd_schedule(1e-3, 2, 5, 5))
    batch = S.local_batch(pod_batch(cfg), mesh)
    losses = []
    for t in range(POD_STEPS):
        params, opt, loss = step(params, opt, batch, t)
        losses.append(loss)
    return {"coords": mesh_coords(mesh), "losses": torch.stack(losses),
            "params": _unshard(params, specs, mesh)}


def pod_batch(cfg) -> dict:
    return {"tokens": torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (TRAIN["batch"] * 2, TRAIN["seq"])))}


def train(rank: int, path: str) -> dict:
    out = _train_mesh(rank, path)
    out["pod"] = _train_pod(rank)
    return out


# ------------------------------------------------- pipeline and restore
PIPE = dict(stages=4, microbatches=4, layers=8, batch=8, d=16, seq=16)


def pipe_config():
    """Reduced minicpm-2b at 8 layers: 2 a stage."""
    import dataclasses

    return dataclasses.replace(case_config("minicpm-2b"),
                               n_layers=PIPE["layers"])


def pipeline(rank: int, path: str) -> dict:
    """``pipeline_forward`` over a 4-stage ``pod`` mesh: the reference's
    ``tanh(h @ w)`` blocks and reduced minicpm-2b's decoder blocks (the
    flash-attention kernel's plain version on the CPU), its refusal under
    grad; then one train step of reduced minicpm-2b on ``data 2 x model
    2`` and a sharded save of its parameters and moments."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import step as S
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.launch.mesh import make_stage_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim.schedules import wsd_schedule

    IN = dict(np.load(path))
    stages = make_stage_mesh(PIPE["stages"], device_type="cpu")
    calls = {"tanh": 0, "block": 0}

    def tanh_block(h, blk):
        calls["tanh"] += 1
        return torch.tanh(h @ blk["w"])

    cfg = pipe_config()
    positions = torch.arange(PIPE["seq"])[None, :]

    def decoder_block(h, blk):
        calls["block"] += 1
        return T._block_forward(h, blk, cfg, positions)[0]

    out: dict = {"stage": stages.get_local_rank("pod")}
    with torch.no_grad():
        out["tanh"] = pipeline_forward(tanh_block, stages,
                                       microbatches=PIPE["microbatches"])(
            torch.from_numpy(IN["x"]), {"w": torch.from_numpy(IN["w"])})
        params = T.init_params(cfg, 0, torch_device="cpu")
        out["block"] = pipeline_forward(decoder_block, stages,
                                        microbatches=PIPE["microbatches"])(
            torch.from_numpy(IN["hidden"]), params["blocks"])
    out["calls"] = dict(calls)
    w = torch.from_numpy(IN["w"]).requires_grad_()
    try:
        pipeline_forward(tanh_block, stages)(torch.from_numpy(IN["x"]),
                                             {"w": w})
        out["grad_refusal"] = ""
    except NotImplementedError as exc:
        out["grad_refusal"] = str(exc)

    mesh, coords = _mesh()
    cfg = case_config("minicpm-2b")
    specs = S.train_param_specs(cfg, mesh)
    params = S.init_local_params(cfg, 5, mesh, specs, torch_device="cpu")
    opt = S.init_local_opt_state(cfg, mesh, specs, torch_device="cpu")
    step = S.make_train_step(cfg, mesh, lr_fn=wsd_schedule(1e-3, 1, 5, 5))
    tokens = torch.from_numpy(IN["tokens"])
    params, opt, _ = step(params, opt, S.local_batch({"tokens": tokens},
                                                     mesh), 0)
    CheckpointManager(str(IN["ckpt"])).save(
        1, {"params": params, "opt": opt}, {"note": "4 ranks"}, mesh=mesh,
        specs={"params": specs,
               "opt": S.train_opt_specs(cfg, mesh, specs)})
    out["coords"] = coords
    return out


RESTORE_MESHES = {"data1_model2": (1, 2), "data2_model1": (2, 1)}


def restore(rank: int, path: str) -> dict:
    """Two ranks restore the JAX package's checkpoint of reduced
    minicpm-2b's parameters and the port's four-rank checkpoint
    (parameters and moments) onto ``data 1 x model 2`` and ``data 2 x
    model 1``: each rank's blocks."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import step as S
    from repro_torch.distributed.sharding import mesh_coords
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.transformer import param_shapes
    from repro_torch.tree import tree_map

    IN = dict(np.load(path))
    cfg = case_config("minicpm-2b")

    def meta(shapes):
        return tree_map(lambda s: torch.empty(s, device="meta"), shapes)

    out: dict = {"rank": rank}
    for label, shape in RESTORE_MESHES.items():
        mesh = make_debug_mesh(*shape, device_type="cpu")
        specs = S.train_param_specs(cfg, mesh)
        ospecs = S.train_opt_specs(cfg, mesh, specs)
        jax_tree, _, _ = CheckpointManager(str(IN["jax_ckpt"])).restore(
            meta(param_shapes(cfg)), mesh=mesh, specs=specs)
        tree = {"params": meta(param_shapes(cfg)),
                "opt": S.meta_opt_state(cfg)}
        port_tree, extra, step = CheckpointManager(
            str(IN["ckpt"])).restore_latest_good(
            tree, mesh=mesh, specs={"params": specs, "opt": ospecs})
        out[label] = {"coords": mesh_coords(mesh), "jax": jax_tree,
                      "port": port_tree, "extra": extra, "step": step}
    return out


def train_card(rank: int, steps: int) -> dict:
    """[mesh-train] (a) at the reduced size on the card (every rank on
    ``cuda:0``, TF32 off): reduced minicpm-2b's two layers on data 2 x
    model 2, seeded weights and batch, step 1's gathered gradients, then
    ``steps`` train steps; losses and kernel launches."""
    from repro_torch.distributed import step as S
    from repro_torch.distributed.sharding import mesh_coords
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim.schedules import wsd_schedule
    from repro_torch.tree import tree_map

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_debug_mesh(*MESH_SHAPE)
    cfg = case_config("minicpm-2b")
    specs = S.train_param_specs(cfg, mesh)
    params = S.init_local_params(cfg, 0, mesh, specs)
    opt = S.init_local_opt_state(cfg, mesh, specs)
    batch = S.local_batch({k: v.cuda() for k, v in pod_batch(cfg).items()},
                          mesh)
    _, grads = S.make_grad_fn(cfg, mesh, specs=specs)(params, batch)
    grads = tree_map(lambda t: t.cpu(), _unshard(grads, specs, mesh))
    step = S.make_train_step(cfg, mesh, lr_fn=wsd_schedule(1e-3, 2, 5, 5))
    fa.reset_launches()
    losses = []
    for t in range(steps):
        params, opt, loss = step(params, opt, batch, t)
        losses.append(float(loss))
    return {"coords": mesh_coords(mesh), "grads": grads, "losses": losses,
            "launches": dict(fa.LAUNCHES)}
