"""repro_torch.core.fabric — CXL switch-fabric subsystem.

Multi-host switch topologies (direct / single-switch / two-level tree /
mesh), deterministic shortest-path routing, per-port bandwidth occupancy,
and pooled-memory scenarios.  ``Fabric.traverse`` mirrors
``CXLLink.traverse`` so every existing ``MemDevice`` mounts behind the
fabric unchanged via ``FabricAttachedDevice`` / ``MemoryPool``.

The vectorized congestion estimator lives in
:mod:`repro_torch.core.fabric.link_sim` (imported lazily — it pulls in torch).
"""

from repro_torch.core.fabric.fabric import Fabric, FabricAttachedDevice
from repro_torch.core.fabric.pool import HostPortView, MemoryPool, PoolAddressMapper
from repro_torch.core.fabric.routing import RoutingTable, flow_choices, flow_hash
from repro_torch.core.fabric.switch import SwitchPort
from repro_torch.core.fabric.topology import (
    TOPOLOGY_BUILDERS,
    Topology,
    build_topology,
    direct,
    mesh,
    single_switch,
    spine_leaf,
    two_level,
)

__all__ = [
    "Fabric", "FabricAttachedDevice",
    "MemoryPool", "HostPortView", "PoolAddressMapper",
    "RoutingTable", "SwitchPort", "flow_hash", "flow_choices",
    "Topology", "build_topology", "TOPOLOGY_BUILDERS",
    "direct", "single_switch", "two_level", "spine_leaf", "mesh",
]
