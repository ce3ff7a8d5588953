"""CXL fabric topology: a static graph of hosts, switches, and devices.

A :class:`Topology` is pure structure — node names, node kinds, and links
with per-link bandwidth/propagation parameters.  Timing state (per-port
busy-until occupancy) lives in :class:`repro_torch.core.fabric.switch.SwitchPort`,
instantiated by :class:`repro_torch.core.fabric.fabric.Fabric` from this graph.

Builders cover the shapes evaluated in multi-host CXL studies
(CXL-ClusterSim, OpenCXD):

``direct``         host_i — dev_i point-to-point (degenerate fabric; must
                   reproduce bare :class:`~repro_torch.core.devices.CXLLink`
                   timing exactly)
``single_switch``  all hosts and devices on one switch (star)
``two_level``      leaf switches holding hosts, root switch holding devices
``spine_leaf``     two-tier Clos (every leaf uplinks to every spine) — the
                   canonical ECMP shape: ``num_spines`` equal-cost paths
                   between endpoints on different leaves
``mesh``           2-D grid of switches, hosts/devices attached round-robin
``multi_pod``      datacenter fabric: ``num_pods`` spine_leaf pods joined by
                   a core switch tier (every pod spine uplinks to every core
                   switch).  Hosts are block-assigned to pods; each host's
                   private device lives one pod over, so ``h_i -> d_i``
                   traffic always crosses the core tier and ECMP fans out
                   over ``spines x cores x spines`` pod-egress paths.

Node names are ``h<i>`` (hosts), ``s<i>`` / ``s<r>_<c>`` / ``p<k>s<j>`` /
``c<j>`` (switches), and ``d<i>`` (devices).  Topologies are immutable once
handed to a ``Fabric``; routing results are cached under that assumption.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

HOST = "host"
SWITCH = "switch"
DEVICE = "device"

DEFAULT_LINK_BW_GBPS = 16.0   # PCIe 4.0 x8-class CXL link, per direction


@dataclass(frozen=True)
class LinkSpec:
    """One *directed* link (an egress port): serialization bandwidth plus a
    fixed propagation delay."""
    bw_gbps: float = DEFAULT_LINK_BW_GBPS
    prop_ns: float = 0.0


@dataclass
class Topology:
    name: str = "custom"
    kinds: Dict[str, str] = field(default_factory=dict)           # node -> kind
    links: Dict[Tuple[str, str], LinkSpec] = field(default_factory=dict)
    _adj: Dict[str, List[str]] = field(default_factory=dict)

    # ------------------------------------------------------------- building
    def _add_node(self, node: str, kind: str) -> str:
        if node in self.kinds:
            raise ValueError(f"duplicate node {node!r}")
        self.kinds[node] = kind
        self._adj[node] = []
        return node

    def add_host(self, node: str) -> str:
        return self._add_node(node, HOST)

    def add_switch(self, node: str) -> str:
        return self._add_node(node, SWITCH)

    def add_device(self, node: str) -> str:
        return self._add_node(node, DEVICE)

    def connect(self, u: str, v: str, bw_gbps: float = DEFAULT_LINK_BW_GBPS,
                prop_ns: float = 0.0) -> None:
        """Add a full-duplex link ``u <-> v`` (two directed LinkSpecs)."""
        for node in (u, v):
            if node not in self.kinds:
                raise ValueError(f"unknown node {node!r}")
        if (u, v) in self.links:
            raise ValueError(f"duplicate link {u!r} <-> {v!r}")
        if bw_gbps <= 0:
            raise ValueError(f"link {u!r} <-> {v!r}: bandwidth must be > 0")
        spec = LinkSpec(bw_gbps=bw_gbps, prop_ns=prop_ns)
        self.links[(u, v)] = spec
        self.links[(v, u)] = spec
        self._adj[u].append(v)
        self._adj[v].append(u)
        self._adj[u].sort()
        self._adj[v].sort()

    # -------------------------------------------------------------- queries
    def neighbors(self, node: str) -> List[str]:
        return self._adj[node]

    def kind(self, node: str) -> str:
        return self.kinds[node]

    def nodes_of_kind(self, kind: str) -> List[str]:
        return sorted(n for n, k in self.kinds.items() if k == kind)

    @property
    def hosts(self) -> List[str]:
        return self.nodes_of_kind(HOST)

    @property
    def switches(self) -> List[str]:
        return self.nodes_of_kind(SWITCH)

    @property
    def devices(self) -> List[str]:
        return self.nodes_of_kind(DEVICE)

    def validate(self) -> None:
        for node, kind in self.kinds.items():
            if not self._adj[node]:
                raise ValueError(f"{kind} {node!r} is disconnected")
            if kind != SWITCH and len(self._adj[node]) > 1:
                # Endpoints own exactly one port; fan-out belongs to switches.
                raise ValueError(
                    f"{kind} {node!r} has {len(self._adj[node])} links; "
                    "endpoints attach to exactly one fabric port")


# ------------------------------------------------------------------ builders
def _check_counts(num_hosts: int, num_devices: int) -> None:
    if num_hosts < 1 or num_devices < 1:
        raise ValueError("topology needs at least one host and one device")


def direct(num_pairs: int = 1, bw_gbps: float = DEFAULT_LINK_BW_GBPS) -> Topology:
    """``h_i — d_i`` point-to-point links, no switches.  With one pair this is
    exactly the paper's single-host CXLLink configuration."""
    _check_counts(num_pairs, num_pairs)
    topo = Topology(name="direct")
    for i in range(num_pairs):
        h = topo.add_host(f"h{i}")
        d = topo.add_device(f"d{i}")
        topo.connect(h, d, bw_gbps=bw_gbps)
    topo.validate()
    return topo


def single_switch(num_hosts: int, num_devices: int,
                  bw_gbps: float = DEFAULT_LINK_BW_GBPS) -> Topology:
    """Star: every host and device hangs off one switch ``s0``."""
    _check_counts(num_hosts, num_devices)
    topo = Topology(name="single_switch")
    sw = topo.add_switch("s0")
    for i in range(num_hosts):
        topo.connect(topo.add_host(f"h{i}"), sw, bw_gbps=bw_gbps)
    for i in range(num_devices):
        topo.connect(topo.add_device(f"d{i}"), sw, bw_gbps=bw_gbps)
    topo.validate()
    return topo


def two_level(num_hosts: int, num_devices: int, num_leaves: int = 2,
              bw_gbps: float = DEFAULT_LINK_BW_GBPS,
              uplink_bw_gbps: float | None = None) -> Topology:
    """Two-level tree: hosts round-robin onto leaf switches, leaves uplink to
    a root switch, devices on the root.  The leaf->root uplink is the shared
    bottleneck (defaults to the same bandwidth as edge links)."""
    _check_counts(num_hosts, num_devices)
    if num_leaves < 1:
        raise ValueError("need at least one leaf switch")
    topo = Topology(name="two_level")
    root = topo.add_switch("s_root")
    leaves = [topo.add_switch(f"s{i}") for i in range(num_leaves)]
    for leaf in leaves:
        topo.connect(leaf, root, bw_gbps=(uplink_bw_gbps if uplink_bw_gbps
                                          is not None else bw_gbps))
    for i in range(num_hosts):
        topo.connect(topo.add_host(f"h{i}"), leaves[i % num_leaves],
                     bw_gbps=bw_gbps)
    for i in range(num_devices):
        topo.connect(topo.add_device(f"d{i}"), root, bw_gbps=bw_gbps)
    topo.validate()
    return topo


def spine_leaf(num_hosts: int, num_devices: int, num_leaves: int = 2,
               num_spines: int = 2, bw_gbps: float = DEFAULT_LINK_BW_GBPS,
               uplink_bw_gbps: float | None = None) -> Topology:
    """Two-tier Clos: every leaf uplinks to every spine, hosts round-robin
    onto the first leaves, devices round-robin onto the last ones.  Any
    host->device pair on different leaves has ``num_spines`` equal-cost
    paths — the canonical ECMP shape (with ECMP off, deterministic
    single-path routing leaves all but one spine idle)."""
    _check_counts(num_hosts, num_devices)
    if num_leaves < 1 or num_spines < 1:
        raise ValueError("spine_leaf needs at least one leaf and one spine")
    topo = Topology(name="spine_leaf")
    spines = [topo.add_switch(f"sp{i}") for i in range(num_spines)]
    leaves = [topo.add_switch(f"s{i}") for i in range(num_leaves)]
    up = uplink_bw_gbps if uplink_bw_gbps is not None else bw_gbps
    for leaf in leaves:
        for spine in spines:
            topo.connect(leaf, spine, bw_gbps=up)
    for i in range(num_hosts):
        topo.connect(topo.add_host(f"h{i}"), leaves[i % num_leaves],
                     bw_gbps=bw_gbps)
    for i in range(num_devices):
        topo.connect(topo.add_device(f"d{i}"),
                     leaves[(num_leaves - 1 - i) % num_leaves],
                     bw_gbps=bw_gbps)
    topo.validate()
    return topo


def mesh(num_hosts: int, num_devices: int, rows: int = 2, cols: int = 2,
         bw_gbps: float = DEFAULT_LINK_BW_GBPS) -> Topology:
    """``rows x cols`` switch grid (4-neighbor).  Hosts attach round-robin
    from the top-left corner, devices round-robin from the bottom-right, so
    traffic crosses the grid."""
    _check_counts(num_hosts, num_devices)
    if rows < 1 or cols < 1:
        raise ValueError("mesh needs at least one switch row and column")
    topo = Topology(name="mesh")
    grid = [[topo.add_switch(f"s{r}_{c}") for c in range(cols)]
            for r in range(rows)]
    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                topo.connect(grid[r][c], grid[r][c + 1], bw_gbps=bw_gbps)
            if r + 1 < rows:
                topo.connect(grid[r][c], grid[r + 1][c], bw_gbps=bw_gbps)
    flat = [grid[r][c] for r in range(rows) for c in range(cols)]
    for i in range(num_hosts):
        topo.connect(topo.add_host(f"h{i}"), flat[i % len(flat)],
                     bw_gbps=bw_gbps)
    rflat = list(reversed(flat))
    for i in range(num_devices):
        topo.connect(topo.add_device(f"d{i}"), rflat[i % len(rflat)],
                     bw_gbps=bw_gbps)
    topo.validate()
    return topo


def multi_pod(num_pods: int = 2, hosts_per_pod: int = 4,
              devices_per_pod: int | None = None, num_leaves: int = 2,
              num_spines: int = 2, num_core: int = 2,
              bw_gbps: float = DEFAULT_LINK_BW_GBPS,
              uplink_bw_gbps: float | None = None,
              core_bw_gbps: float | None = None) -> Topology:
    """Multi-pod datacenter fabric: ``num_pods`` spine_leaf pods joined by a
    core tier.  Pod ``k`` owns leaves ``p<k>s<j>`` and spines ``p<k>sp<j>``
    (full leaf-spine bipartite, like :func:`spine_leaf`); every pod spine
    uplinks to every core switch ``c<j>``.

    Hosts are **block-assigned**: pod ``k`` holds hosts
    ``h[k*hosts_per_pod : (k+1)*hosts_per_pod]``, round-robin over the pod's
    leaves — the contiguous host blocks are exactly what the sharded replay
    partitions across devices.  Device ``d<i>`` sits in the pod *after*
    its host's pod (``(pod(i) + 1) % num_pods``), so every ``h_i -> d_i``
    mount crosses the core tier: leaf -> spine (``num_spines`` choices) ->
    core (``num_core`` choices) -> spine -> leaf, i.e.
    ``num_spines * num_core * num_spines`` equal-cost ECMP paths (capped by
    routing's :data:`~repro_torch.core.fabric.routing.MAX_ECMP_PATHS`).  With a
    single pod the core tier still carries no host->device traffic shortcut
    — require ``num_pods >= 2`` so the shape is honest."""
    if num_pods < 2:
        raise ValueError("multi_pod needs at least two pods "
                         "(use spine_leaf for a single pod)")
    if hosts_per_pod < 1:
        raise ValueError("multi_pod needs at least one host per pod")
    if num_leaves < 1 or num_spines < 1 or num_core < 1:
        raise ValueError("multi_pod needs >= 1 leaf, spine and core switch")
    dpp = hosts_per_pod if devices_per_pod is None else devices_per_pod
    if dpp < 1:
        raise ValueError("multi_pod needs at least one device per pod")
    up = uplink_bw_gbps if uplink_bw_gbps is not None else bw_gbps
    core_bw = core_bw_gbps if core_bw_gbps is not None else up
    topo = Topology(name="multi_pod")
    cores = [topo.add_switch(f"c{j}") for j in range(num_core)]
    leaves: List[List[str]] = []
    for k in range(num_pods):
        pod_spines = [topo.add_switch(f"p{k}sp{j}")
                      for j in range(num_spines)]
        pod_leaves = [topo.add_switch(f"p{k}s{j}") for j in range(num_leaves)]
        leaves.append(pod_leaves)
        for leaf in pod_leaves:
            for spine in pod_spines:
                topo.connect(leaf, spine, bw_gbps=up)
        for spine in pod_spines:
            for core in cores:
                topo.connect(spine, core, bw_gbps=core_bw)
    for i in range(num_pods * hosts_per_pod):
        k = i // hosts_per_pod
        topo.connect(topo.add_host(f"h{i}"),
                     leaves[k][(i % hosts_per_pod) % num_leaves],
                     bw_gbps=bw_gbps)
    for i in range(num_pods * dpp):
        k = (i // dpp + 1) % num_pods
        topo.connect(topo.add_device(f"d{i}"),
                     leaves[k][(i % dpp) % num_leaves], bw_gbps=bw_gbps)
    topo.validate()
    return topo


TOPOLOGY_BUILDERS = {
    "direct": direct,
    "single_switch": single_switch,
    "two_level": two_level,
    "spine_leaf": spine_leaf,
    "mesh": mesh,
    "multi_pod": multi_pod,
}


def build_topology(kind: str, **kwargs) -> Topology:
    try:
        builder = TOPOLOGY_BUILDERS[kind]
    except KeyError:
        raise ValueError(f"unknown topology {kind!r}; choose from "
                         f"{sorted(TOPOLOGY_BUILDERS)}") from None
    return builder(**kwargs)
