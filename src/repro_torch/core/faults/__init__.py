"""Deterministic fault injection and graceful degradation.

:class:`FaultPlan` is a pure function of ``(seed, FaultConfig)`` that
schedules four fault classes — link flit CRC-retry bursts, port/link down
windows, NAND read-retry + grown bad blocks, and poison propagation —
injected tick-identically into the interpreted drivers and the fused
replay lanes.  See :mod:`repro_torch.core.faults.plan`.
"""

from repro_torch.core.faults.plan import (
    DeviceUnreachable,
    FaultConfig,
    FaultPlan,
    erase_fails_torch,
    fault_hash,
    fault_hash_np,
    install,
    nand_read_retries_torch,
    str_salt,
)

__all__ = [
    "DeviceUnreachable",
    "FaultConfig",
    "FaultPlan",
    "erase_fails_torch",
    "fault_hash",
    "fault_hash_np",
    "install",
    "nand_read_retries_torch",
    "str_salt",
]
