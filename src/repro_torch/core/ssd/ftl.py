"""FTL — page-level flash translation layer with greedy garbage collection.

LPN→PPN page mapping; writes are log-structured (next free page, striped
across channels/dies by PPN layout in :mod:`repro_torch.core.ssd.pal`).  GC
triggers when the free-block pool drops below a watermark: the block with the
fewest valid pages is victimized, its valid pages migrated (read+program),
then erased.  Write amplification is tracked explicitly — the DRAM cache in
front of the SSD exists precisely to cut this traffic (paper §II-C) and to
extend endurance (paper §IV).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.ssd.pal import PAL

FREE = 0xFFFFFFFF

# GC policy constants — shared with the fused replay's scan twin
# (repro_torch.core.replay.stack mirrors the greedy discipline these define, so
# keep the two in sync through these names rather than re-deriving them):
# * victim = the non-free, non-write-pointer block with the fewest valid
#   pages, ties to the lowest block id (Python ``min`` == ``argmin``);
# * GC triggers at block allocation when the free pool has at most
#   ``gc_watermark_blocks`` entries;
# * the free-block pool is a FIFO (pop from the front, erased victims
#   append at the back).
DEFAULT_OP_RATIO = 0.07          # physical over-provisioning: phys/logical - 1
DEFAULT_GC_WATERMARK = 0.05      # watermark as a fraction of num_blocks
MIN_GC_WATERMARK_BLOCKS = 2      # floor of the watermark
MIN_NUM_BLOCKS = 4               # smallest device the FTL will lay out


class FTL:
    def __init__(self, pal: PAL, total_pages: int, pages_per_block: int = 256,
                 op_ratio: float = DEFAULT_OP_RATIO,
                 gc_watermark: float = DEFAULT_GC_WATERMARK) -> None:
        self.pal = pal
        self.pages_per_block = pages_per_block
        # over-provisioning: physical > logical
        self.logical_pages = total_pages
        phys_pages = int(total_pages * (1 + op_ratio))
        self.num_blocks = max(
            MIN_NUM_BLOCKS,
            (phys_pages + pages_per_block - 1) // pages_per_block)
        self.phys_pages = self.num_blocks * pages_per_block
        self.gc_watermark_blocks = max(MIN_GC_WATERMARK_BLOCKS,
                                       int(self.num_blocks * gc_watermark))

        self.l2p: dict[int, int] = {}
        self.p2l: dict[int, int] = {}
        self.valid_count = [0] * self.num_blocks        # valid pages per block
        self.write_ptr_block = 0
        self.write_ptr_page = 0
        self.free_blocks = list(range(1, self.num_blocks))
        self.stats = {"host_writes": 0, "host_reads": 0, "gc_writes": 0,
                      "gc_erases": 0, "gc_runs": 0}
        # deterministic fault injection (repro_torch.core.faults.install): a
        # failed erase grows the victim bad — it is retired from both the
        # free pool and future GC candidacy, shrinking over-provisioning
        self.fault_plan = None
        self._erase_seq = 0
        self.retired_blocks: set[int] = set()

    # -------------------------------------------------------------- mapping
    def _block_of(self, ppn: int) -> int:
        return ppn // self.pages_per_block

    def _next_ppn(self, now: int, allow_gc: bool = True) -> tuple[int, int]:
        """Allocate the next physical page; may trigger GC. Returns (ppn, gc_done_tick).

        ``allow_gc=False`` is the migration-path allocator: GC destination
        pages draw straight from the (watermark-reserved) free pool, because
        re-entering ``_collect`` from inside ``_collect`` would recurse on
        the same victim forever — the watermark exists precisely to reserve
        blocks for in-flight collections.
        """
        gc_done = now
        if self.write_ptr_page >= self.pages_per_block:
            if allow_gc and len(self.free_blocks) <= self.gc_watermark_blocks:
                gc_done = self._collect(now)
            if not self.free_blocks:
                raise RuntimeError("FTL out of space — device overfilled")
            self.write_ptr_block = self.free_blocks.pop(0)
            self.write_ptr_page = 0
        ppn = self.write_ptr_block * self.pages_per_block + self.write_ptr_page
        self.write_ptr_page += 1
        return ppn, gc_done

    def _invalidate(self, lpn: int) -> None:
        old = self.l2p.get(lpn)
        if old is not None:
            self.valid_count[self._block_of(old)] -= 1
            self.p2l.pop(old, None)

    def _collect(self, now: int) -> int:
        """Greedy GC: victimize the fullest-of-invalid block."""
        self.stats["gc_runs"] += 1
        candidates = [b for b in range(self.num_blocks)
                      if b != self.write_ptr_block
                      and b not in self.free_blocks
                      and b not in self.retired_blocks]
        if not candidates:
            return now
        victim = min(candidates, key=lambda b: self.valid_count[b])
        t = now
        base = victim * self.pages_per_block
        for off in range(self.pages_per_block):
            ppn = base + off
            lpn = self.p2l.get(ppn)
            if lpn is None:
                continue
            # migrate valid page
            t = self.pal.read_page(t, ppn)
            new_ppn, _ = self._next_ppn(t, allow_gc=False)
            t = self.pal.program_page(t, new_ppn)
            self.p2l.pop(ppn)
            self.l2p[lpn] = new_ppn
            self.p2l[new_ppn] = lpn
            self.valid_count[self._block_of(new_ppn)] += 1
            self.valid_count[victim] -= 1
            self.stats["gc_writes"] += 1
        t = self.pal.erase_block(t, base)
        self.stats["gc_erases"] += 1
        fail = False
        if self.fault_plan is not None:
            fail = self.fault_plan.erase_fails(self._erase_seq)
            self._erase_seq += 1
        if fail:
            # grown bad block: retire instead of returning to the pool —
            # the device degrades (less over-provisioning) rather than
            # serving corrupt data; running out entirely surfaces as the
            # existing "out of space" error
            self.retired_blocks.add(victim)
        else:
            self.free_blocks.append(victim)
        return t

    # ------------------------------------------------------------------ ops
    def read(self, now: int, lpn: int) -> int:
        """Read a logical page; returns completion tick."""
        self.stats["host_reads"] += 1
        ppn = self.l2p.get(lpn)
        if ppn is None:
            # unwritten page: served from the mapping table (no NAND access);
            # charge one channel transfer for the all-zeros response.
            return now + self.pal.timing.xfer_ticks(self.pal.page_bytes)
        return self.pal.read_page(now, ppn)

    def write(self, now: int, lpn: int) -> int:
        """Write (update) a logical page; returns completion tick."""
        self.stats["host_writes"] += 1
        self._invalidate(lpn)
        ppn, t = self._next_ppn(now)
        done = self.pal.program_page(t, ppn)
        self.l2p[lpn] = ppn
        self.p2l[ppn] = lpn
        self.valid_count[self._block_of(ppn)] += 1
        return done

    @property
    def write_amplification(self) -> float:
        hw = self.stats["host_writes"]
        return (hw + self.stats["gc_writes"]) / hw if hw else 1.0
