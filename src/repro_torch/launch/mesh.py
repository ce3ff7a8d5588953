"""Device meshes over ``torch.distributed``.

``make_production_mesh`` and ``make_debug_mesh`` are functions, not
module-level constants, so importing this module builds nothing.  Each
returns a :class:`~torch.distributed.device_mesh.DeviceMesh` with the JAX
package's axis names (``data``, ``model``; ``pod``, ``data``, ``model``;
a pipeline's 1-D ``pod`` stage axis),
over the default process group, which the caller initialises first
(``torch.distributed.init_process_group`` with its own rank and world
size; several processes may share one card, over gloo).  The world size
must equal the mesh's device count.  ``device_type`` is explicit and
defaults to the card; the CPU tests pass ``"cpu"``.

:func:`run_local_ranks` starts the ranks of such a mesh as processes of
this host (spawned by ``torch.multiprocessing``), each in a gloo process
group met through a ``file://`` rendezvous: no network.
"""

from __future__ import annotations

import datetime
import math
import time
from pathlib import Path


def _mesh(shape, axes, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs an initialised "
            "default process group: call "
            "torch.distributed.init_process_group(...) on every rank first")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(
            f"a {' x '.join(f'{a} {n}' for a, n in zip(axes, shape))} mesh "
            f"needs {math.prod(shape)} ranks, but the process group has "
            f"{world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: 16 x 16 = 256 ranks (data, model).  Multi-pod: 2 x 16 x
    16 = 512 (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, n_pod: int = 0,
                    device_type: str = "cuda"):
    """A small mesh for tests and one-card runs: (data, model), or (pod,
    data, model) when ``n_pod``."""
    if n_pod:
        return _mesh((n_pod, n_data, n_model), ("pod", "data", "model"),
                     device_type)
    return _mesh((n_data, n_model), ("data", "model"), device_type)


def make_stage_mesh(n_stages: int = 4, axis: str = "pod",
                    device_type: str = "cuda"):
    """A 1-D mesh of ``n_stages`` pipeline stages (the reference's
    ``jax.make_mesh((4,), ("pod",))``)."""
    return _mesh((n_stages,), (axis,), device_type)


def _rank_main(rank: int, fn, world: int, workdir: str, args, timeout_s):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)        # ranks share the host's cores
    dist.init_process_group(
        "gloo", init_method=f"file://{workdir}/rendezvous", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, *args)
        torch.save(out, Path(workdir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_local_ranks(fn, world: int, workdir, args=(), timeout_s: float = 600):
    """Run ``fn(rank, *args)`` in ``world`` (any count: 2 for a data 1 x
    model 2 restore, 4 for a 2 x 2 mesh) spawned processes, each a rank
    of a gloo default process group (rendezvous in ``workdir``, which must
    hold no earlier rendezvous file).  ``fn`` must be importable by the
    child (a module-level function) and return tensors, numbers or
    strings in dicts and lists.  Returns their results in rank order.  A
    rank that raises fails the call (the others are stopped), and so does
    a call that outlasts ``timeout_s``."""
    import torch
    import torch.multiprocessing as mp

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(_rank_main, args=(fn, world, str(workdir), args,
                                               timeout_s),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks ran past {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return [torch.load(workdir / f"rank{r}.pt") for r in range(world)]
