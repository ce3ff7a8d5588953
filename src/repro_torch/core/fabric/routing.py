"""Shortest-path routing over a fabric topology, with optional ECMP.

Paths are computed over hop count with *deterministic tie-breaking*: among
equal-length paths the lexicographically smallest node sequence wins.  Two
runs of the same scenario therefore route identically — a property the
equivalence tests and the vectorized congestion estimator both rely on.

:meth:`RoutingTable.paths` enumerates *all* equal-cost shortest paths
(lexicographically ordered, so ``paths(...)[0] == path(...)``), which is the
ECMP path set.  :func:`flow_hash` / :func:`flow_choices` map a flow key
``(src, dst, line_addr)`` onto that set deterministically: pure mod-2^64
integer arithmetic (FNV-1a pair salt + splitmix64 finalizer), so the scalar
per-access Python path and the vectorized numpy export used by the fused
replay agree bit-for-bit.

Only switches relay traffic; hosts and devices are endpoints.  Routes are
cached per ``(src, dst)`` under the assumption that the topology is static
once a :class:`~repro_torch.core.fabric.fabric.Fabric` is built.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, FrozenSet, List, Tuple

import numpy as np

from repro_torch.core.fabric.topology import SWITCH, Topology
from repro_torch.core.faults import DeviceUnreachable

# Keep the ECMP fan-out bounded on dense graphs (a large mesh has a
# combinatorial number of equal-cost paths).  The lexicographically smallest
# MAX_ECMP_PATHS are retained — deterministic, and a superset is never
# needed because selection hashes into the retained list.
MAX_ECMP_PATHS = 16

_M64 = (1 << 64) - 1
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3


def pair_salt(src: str, dst: str) -> int:
    """FNV-1a over ``"src->dst"`` — the per-flow-pair hash salt."""
    h = _FNV_OFFSET
    for b in f"{src}->{dst}".encode():
        h = ((h ^ b) * _FNV_PRIME) & _M64
    return h


def flow_hash(src: str, dst: str, line_addr: int) -> int:
    """Deterministic 64-bit flow hash over ``(src, dst, line_addr)``.

    splitmix64 finalizer over the line address xor'd with the pair salt.
    Stable across runs and processes (never Python's randomized ``hash``).
    """
    x = (int(line_addr) ^ pair_salt(src, dst)) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def flow_choices(src: str, dst: str, line_addrs: np.ndarray,
                 num_paths: int) -> np.ndarray:
    """Vectorized ``flow_hash(...) % num_paths`` for a line-address array.

    numpy uint64 arithmetic wraps mod 2^64, matching the scalar
    :func:`flow_hash` exactly — the fused replay precomputes its per-access
    route-choice column with this, so it cannot drift from the interpreted
    per-access path.
    """
    if num_paths <= 1:
        return np.zeros(np.asarray(line_addrs).shape, np.int32)
    x = np.asarray(line_addrs).astype(np.uint64)
    x = x ^ np.uint64(pair_salt(src, dst))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x % np.uint64(num_paths)).astype(np.int32)


def flow_choices_torch(src: str, dst: str, line_addrs, num_paths: int,
                       torch_device="cuda"):
    """Tensor twin of :func:`flow_choices`, so route-choice columns of
    traces that live on the card never leave it.  The uint64 bits are held
    in int64 (see :mod:`repro_torch.core.u64`); bit-equal to the scalar and
    numpy twins (property-tested).  Tensors are hashed where they lie;
    anything else goes to ``torch_device`` first.  Returns int32."""
    import torch

    from repro_torch.core import u64

    x = u64.as_bits(line_addrs, torch_device)
    if num_paths <= 1:
        return torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    x = x ^ u64.const(pair_salt(src, dst))
    x = (x ^ u64.shr(x, 30)) * u64.const(0xBF58476D1CE4E5B9)
    x = (x ^ u64.shr(x, 27)) * u64.const(0x94D049BB133111EB)
    x = x ^ u64.shr(x, 31)
    return u64.rem(x, num_paths).to(torch.int32)


_EMPTY_DOWN: FrozenSet[Tuple[str, str]] = frozenset()


class RoutingTable:
    def __init__(self, topology: Topology) -> None:
        self.topology = topology
        self._cache: Dict[Tuple[str, str], List[List[str]]] = {}
        # masked-route cache: (src, dst, down-set) -> recomputed paths,
        # populated only when a whole equal-cost set is down (failover)
        self._down_cache: Dict[Tuple[str, str, FrozenSet[Tuple[str, str]]],
                               List[List[str]]] = {}

    def paths(self, src: str, dst: str,
              down: FrozenSet[Tuple[str, str]] = _EMPTY_DOWN
              ) -> List[List[str]]:
        """All equal-cost shortest node sequences ``[src, ..., dst]``,
        lexicographically ordered (capped at :data:`MAX_ECMP_PATHS`);
        raises if unreachable.

        ``down`` masks directed port keys: surviving base paths are
        returned if any remain; otherwise routes are *recomputed* over the
        masked topology (failover onto longer paths).  Zero surviving
        paths raises :class:`~repro_torch.core.faults.DeviceUnreachable` naming
        the down-port set."""
        key = (src, dst)
        cached = self._cache.get(key)
        if cached is None:
            cached = self._cache[key] = _all_shortest_paths(
                self.topology, src, dst)
        if not down:
            return cached
        surviving = [p for p in cached if not _path_blocked(p, down)]
        if surviving:
            return surviving
        dkey = (src, dst, down)
        rerouted = self._down_cache.get(dkey)
        if rerouted is None:
            try:
                rerouted = _all_shortest_paths(self.topology, src, dst,
                                               blocked=down)
            except ValueError:
                rerouted = []
            self._down_cache[dkey] = rerouted
        if not rerouted:
            raise DeviceUnreachable(
                f"no surviving route from {src!r} to {dst!r}: every path "
                f"crosses a down port (down={sorted(down)})")
        return rerouted

    def path(self, src: str, dst: str) -> List[str]:
        """The primary (lexicographically smallest shortest) path."""
        return self.paths(src, dst)[0]

    def num_paths(self, src: str, dst: str) -> int:
        return len(self.paths(src, dst))

    def select(self, src: str, dst: str, line_addr: int,
               down: FrozenSet[Tuple[str, str]] = _EMPTY_DOWN
               ) -> List[str]:
        """ECMP selection: hash ``(src, dst, line_addr)`` onto the
        (surviving) equal-cost path set.  With a single shortest path this
        is exactly :meth:`path`; with every path down it raises
        :class:`~repro_torch.core.faults.DeviceUnreachable`."""
        paths = self.paths(src, dst, down=down)
        if len(paths) == 1:
            return paths[0]
        return paths[flow_hash(src, dst, line_addr) % len(paths)]

    def hops(self, src: str, dst: str) -> int:
        return len(self.path(src, dst)) - 1


def _path_blocked(path: List[str],
                  down: FrozenSet[Tuple[str, str]]) -> bool:
    """Whether any hop of ``path`` crosses a down directed port."""
    return any((u, v) in down for u, v in zip(path, path[1:]))


def _all_shortest_paths(topo: Topology, src: str, dst: str,
                        blocked: FrozenSet[Tuple[str, str]] = frozenset()
                        ) -> List[List[str]]:
    """Lazily enumerate equal-cost shortest paths in lexicographic order.

    A reverse BFS from ``dst`` over the relay-constrained graph labels
    every node with its shortest remaining distance; a forward DFS from
    ``src`` then walks only distance-decreasing edges, visiting candidates
    in sorted order — so paths stream out lexicographically (the first one
    reproduces the seed Dijkstra tie-break exactly) and generation stops at
    :data:`MAX_ECMP_PATHS` without materializing the combinatorial path
    set a dense mesh would otherwise produce."""
    if src == dst:
        raise ValueError(f"src == dst ({src!r})")
    for node in (src, dst):
        if node not in topo.kinds:
            raise ValueError(f"unknown node {node!r}")
    # dist_d[v]: hops from v to dst relaying only through switches.
    dist_d = {dst: 0}
    queue = deque([dst])
    while queue:
        node = queue.popleft()
        # Endpoints never relay: expand through switches (or dst itself).
        if node != dst and topo.kind(node) != SWITCH:
            continue
        for nxt in topo.neighbors(node):
            # expanding node -> nxt labels the *forward* edge (nxt, node)
            if blocked and (nxt, node) in blocked:
                continue
            if nxt not in dist_d:
                dist_d[nxt] = dist_d[node] + 1
                queue.append(nxt)
    if src not in dist_d:
        raise ValueError(f"no path from {src!r} to {dst!r}")

    paths: List[List[str]] = []
    prefix = [src]

    def walk(node: str) -> None:
        if len(paths) >= MAX_ECMP_PATHS:
            return
        if node == dst:
            paths.append(list(prefix))
            return
        for nxt in topo.neighbors(node):        # adjacency is kept sorted
            if nxt != dst and topo.kind(nxt) != SWITCH:
                continue
            if blocked and (node, nxt) in blocked:
                continue
            if dist_d.get(nxt, -1) == dist_d[node] - 1:
                prefix.append(nxt)
                walk(nxt)
                prefix.pop()

    walk(src)
    return paths
