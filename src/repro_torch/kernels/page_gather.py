"""Page gather / scatter for the tiered KV store, as CUDA kernels for
Hopper beside their plain PyTorch versions.

The card-side half of the paper's DRAM-cache fill path at the model level:
given a page table (from the replacement policies of
:mod:`repro_torch.tiered`), ``page_gather`` copies the referenced pages of
the resident pool into a dense output and ``page_scatter`` writes dense
pages into pool slots, in place, returning the pool (the reference's
``pallas_call`` aliases the pool input to its output).  Pages are
``(P, R, C)`` of any dtype.  Duplicate slots in a scatter table end last
writer wins, as the reference's sequential grid leaves them.

For CUDA tensors the wrappers launch ``csrc/page_gather.cu``; for CPU
tensors they run the plain versions.  Nothing falls back from one to the
other.  Slots outside ``[0, P)`` raise before any launch.

``LAUNCHES`` counts kernel launches only, so a run can show that it went
through the kernels.
"""

from __future__ import annotations

import math

import torch

LAUNCHES = {"page_gather": 0, "page_scatter": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _table(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    if pool.dim() != 3:
        raise ValueError(f"pool must be (P, R, C), got {tuple(pool.shape)}")
    table = torch.as_tensor(table)
    if table.dim() != 1 or table.dtype.is_floating_point \
            or table.dtype == torch.bool:
        raise ValueError(f"table must be a 1-D integer tensor, got "
                         f"{table.dtype} {tuple(table.shape)}")
    if table.numel():
        lo, hi = int(table.min()), int(table.max())
        if lo < 0 or hi >= pool.shape[0]:
            raise ValueError(f"page slots [{lo}, {hi}] outside the pool's "
                             f"[0, {pool.shape[0]})")
    return table.to(device=pool.device, dtype=torch.int32).contiguous()


def page_gather(pool: torch.Tensor, table) -> torch.Tensor:
    """pool: (P, R, C) resident pages; table: (n,) slots.
    Returns (n, R, C) gathered pages."""
    table = _table(pool, table)
    if pool.device.type == "cpu":
        return page_gather_plain(pool, table)
    out = torch.empty((table.shape[0],) + tuple(pool.shape[1:]),
                      dtype=pool.dtype, device=pool.device)
    if table.numel():
        _launch("page_gather", out, pool.contiguous(), table)
    return out


def page_scatter(pool: torch.Tensor, table, pages: torch.Tensor
                 ) -> torch.Tensor:
    """Write pages (n, R, C) into pool slots table (n,), in place; returns
    the pool.  The last entry wins a slot named twice."""
    table = _table(pool, table)
    want = (table.shape[0],) + tuple(pool.shape[1:])
    if tuple(pages.shape) != want or pages.dtype != pool.dtype \
            or pages.device != pool.device:
        raise ValueError(f"pages must be {want} {pool.dtype} on "
                         f"{pool.device}, got {tuple(pages.shape)} "
                         f"{pages.dtype} on {pages.device}")
    if not pool.is_contiguous():
        raise ValueError("page_scatter writes the pool in place and needs "
                         "it contiguous")
    if pool.device.type == "cpu":
        return page_scatter_plain(pool, table, pages)
    if table.numel():
        _launch("page_scatter", pool, pages.contiguous(), table)
    return pool


def page_gather_plain(pool: torch.Tensor, table: torch.Tensor
                      ) -> torch.Tensor:
    """The reference's ``jnp.take(pool, table, axis=0)``."""
    return pool[table.long()]


def page_scatter_plain(pool: torch.Tensor, table: torch.Tensor,
                       pages: torch.Tensor) -> torch.Tensor:
    """The reference's ``pool.at[table].set(pages)``, in place, one page at
    a time in table order, so a slot named twice keeps the last page."""
    for i, slot in enumerate(table.tolist()):
        pool[slot] = pages[i]
    return pool


def _unit_bytes(page_bytes: int, *tensors) -> int:
    """16 when every page starts on a 16-byte boundary, else 1."""
    aligned = page_bytes % 16 == 0 and all(t.data_ptr() % 16 == 0
                                           for t in tensors)
    return 16 if aligned else 1


def _launch(name: str, dst: torch.Tensor, src: torch.Tensor,
            table: torch.Tensor) -> None:
    """Launch kernel ``name`` on the tensors' card, on PyTorch's current
    stream: gather reads ``src[table[i]]`` into ``dst[i]``, scatter writes
    ``src[i]`` into ``dst[table[i]]``."""
    from repro_torch.kernels import _build

    dev = dst.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    page_bytes = math.prod(dst.shape[1:]) * dst.element_size()
    lib = _build.library("page_gather")
    with torch.cuda.device(dev):
        err = getattr(lib, f"{name}_launch")(
            dst.data_ptr(), src.data_ptr(), table.data_ptr(), page_bytes,
            table.shape[0],
            _unit_bytes(page_bytes, dst, src),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            msg = lib.page_gather_error_string(err).decode()
            raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                               f"{err} ({msg})")
        LAUNCHES[name] += 1
