"""PAL — Parallelism Abstraction Layer (SimpleSSD terminology).

Models the NAND flash backend: ``channels × packages(dies)`` with per-die
array occupancy and per-channel bus occupancy.  Timing defaults follow
SimpleSSD's MLC profile (officially validated, which is what the paper leans
on for accuracy): ``tR = 45 µs``, ``tPROG = 660 µs``, ``tBERS = 3.5 ms``,
channel bus at 1.2 GB/s (ONFI 4-class NV-DDR3).

A page operation occupies its die for the array time and its channel for the
data-transfer time; the PAL serializes conflicting operations by keeping
``busy_until`` ticks per resource — an analytic queueing model that matches
event-driven behavior for FCFS scheduling without simulating every DMA beat.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.engine import ns, us


@dataclass
class NANDTiming:
    t_read_us: float = 45.0         # tR: array read
    t_prog_us: float = 660.0        # tPROG: array program
    t_erase_us: float = 3500.0      # tBERS: block erase
    channel_mbps: float = 1200.0    # channel bus MB/s (10^6 B/s)
    t_suspend_us: float = 10.0      # program-suspend latency (reads preempt
                                    # in-flight programs, standard NAND feature)

    def xfer_ticks(self, nbytes: int) -> int:
        return ns(nbytes / self.channel_mbps * 1e3)  # bytes / (MB/s) -> ns

    @property
    def read_ticks(self) -> int:
        return us(self.t_read_us)

    @property
    def prog_ticks(self) -> int:
        return us(self.t_prog_us)

    @property
    def erase_ticks(self) -> int:
        return us(self.t_erase_us)

    @classmethod
    def mlc(cls) -> "NANDTiming":
        """SimpleSSD's validated MLC profile (storage-class SSD)."""
        return cls()

    @classmethod
    def low_latency(cls) -> "NANDTiming":
        """Z-NAND / XL-Flash class low-latency NAND — what memory-semantic
        CXL-SSDs (Samsung MS-SSD, paper refs [7], [16]) are built from.
        Keeps uncached access in the paper's 'microseconds to tens of
        microseconds' band instead of MLC's ~100 µs."""
        return cls(t_read_us=3.0, t_prog_us=100.0, t_erase_us=1000.0,
                   channel_mbps=1200.0)


@dataclass
class _DieState:
    busy_until: int = 0        # array busy for same-class ops
    program_until: int = 0     # in-flight program window (suspendable)
    reads: int = 0
    programs: int = 0
    erases: int = 0
    suspends: int = 0


class PAL:
    """NAND backend with explicit channel/die occupancy."""

    def __init__(self, channels: int = 8, dies_per_channel: int = 4,
                 page_bytes: int = 4096, timing: NANDTiming | None = None) -> None:
        self.channels = channels
        self.dies_per_channel = dies_per_channel
        self.page_bytes = page_bytes
        self.timing = timing or NANDTiming()
        self._dies = [[_DieState() for _ in range(dies_per_channel)]
                      for _ in range(channels)]
        self._channel_busy_until = [0] * channels
        self.stats = {"reads": 0, "programs": 0, "erases": 0,
                      "bytes_read": 0, "bytes_programmed": 0,
                      "die_wait_ticks": 0, "channel_wait_ticks": 0,
                      "read_retries": 0}
        # deterministic NAND fault injection (repro_torch.core.faults.install):
        # read-retry decisions key on the per-PAL read sequence number,
        # which the fused scan's flash state mirrors exactly
        self.fault_plan = None
        self._rd_seq = 0

    # -------------------------------------------------------------- helpers
    def locate(self, ppn: int) -> tuple[int, int]:
        """Physical page number → (channel, die).  Pages stripe channel-first
        so sequential PPNs exploit channel-level parallelism."""
        ch = ppn % self.channels
        die = (ppn // self.channels) % self.dies_per_channel
        return ch, die

    def _schedule(self, now: int, ch: int, die: int, array_ticks: int,
                  xfer_first: bool, rounds: int = 1) -> int:
        """Reserve die + channel; return completion tick.

        Reads: array sense first, then channel transfer out.  ``rounds``
        charges that many full sense+transfer passes (NAND read-retry with
        shifted reference voltages; 1 = clean read).
        Programs: channel transfer in first, then array program.
        """
        d = self._dies[ch][die]
        xfer = self.timing.xfer_ticks(self.page_bytes)
        if not xfer_first and rounds > 1:
            array_ticks = array_ticks * rounds
            xfer = xfer * rounds
        if xfer_first:  # program: bus in, then array
            die_start = max(now, d.busy_until, d.program_until)
            self.stats["die_wait_ticks"] += die_start - now
            bus_start = max(die_start, self._channel_busy_until[ch])
            self.stats["channel_wait_ticks"] += bus_start - die_start
            bus_done = bus_start + xfer
            done = bus_done + array_ticks
            self._channel_busy_until[ch] = bus_done
            d.busy_until = bus_done      # array handed to (suspendable) program
            d.program_until = done
        else:  # read: array, then bus out. Reads may SUSPEND an in-flight
            # program: wait at most t_suspend, and push the program out by
            # the time stolen.
            die_start = max(now, d.busy_until)
            if d.program_until > die_start:
                suspend_done = die_start + us(self.timing.t_suspend_us)
                resume_at = min(d.program_until, suspend_done)
                d.suspends += 1
                die_start = resume_at
            self.stats["die_wait_ticks"] += die_start - now
            array_done = die_start + array_ticks
            if d.program_until > die_start:
                d.program_until += array_ticks  # stolen array time
            bus_start = max(array_done, self._channel_busy_until[ch])
            self.stats["channel_wait_ticks"] += bus_start - array_done
            done = bus_start + xfer
            self._channel_busy_until[ch] = done
            d.busy_until = done
        return done

    # ------------------------------------------------------------------ ops
    def read_page(self, now: int, ppn: int) -> int:
        ch, die = self.locate(ppn)
        self._dies[ch][die].reads += 1
        self.stats["reads"] += 1
        self.stats["bytes_read"] += self.page_bytes
        retries = 0
        if self.fault_plan is not None:
            retries = self.fault_plan.nand_read_retries(self._rd_seq)
            self._rd_seq += 1
            self.stats["read_retries"] += retries
        return self._schedule(now, ch, die, self.timing.read_ticks,
                              xfer_first=False, rounds=1 + retries)

    def program_page(self, now: int, ppn: int) -> int:
        ch, die = self.locate(ppn)
        self._dies[ch][die].programs += 1
        self.stats["programs"] += 1
        self.stats["bytes_programmed"] += self.page_bytes
        return self._schedule(now, ch, die, self.timing.prog_ticks, xfer_first=True)

    def erase_block(self, now: int, ppn_of_block: int) -> int:
        ch, die = self.locate(ppn_of_block)
        d = self._dies[ch][die]
        d.erases += 1
        self.stats["erases"] += 1
        start = max(now, d.busy_until, d.program_until)
        done = start + self.timing.erase_ticks
        d.busy_until = done
        return done

    @property
    def total_dies(self) -> int:
        return self.channels * self.dies_per_channel
