"""Vectorized fabric congestion estimation (tensor hot path).

Same philosophy as :mod:`repro_torch.core.cache.trace_sim`: the per-access
busy-until replay in :class:`~repro_torch.core.fabric.fabric.Fabric` is
exact but Python-speed; for *what-if sweeps* over large traces we want an
analytic estimate that runs as a few tensor operations on the card.  The
model here is fluid-flow:

1. every access is attributed to its (host, device) pair;
2. per-pair bytes are reduced with ``index_add_`` (one slot per pair — the
   trace can be millions of accesses);
3. per-*link* bytes come from a static route-weight matrix ``R`` (pairs x
   links), computed once from the routing table: ``link_bytes = R.T @
   pair_bytes``.  On an ECMP fabric each of a pair's equal-cost paths
   carries weight ``1/K`` (the flow hash spreads uniformly in
   expectation), so shared first/last hops accumulate back to 1 and the
   spine tier splits — matching the exact replay's spreading;
4. link utilization = link_bytes / (bw x window); a pair's congestion
   factor is the max utilization along its route, and its predicted
   throughput scales by ``1 / max(1, congestion)``.

This ignores queueing order (it is a load-balance estimate, not a replay),
but it identifies bottleneck links and relative per-host slowdowns in one
matrix product — and ``what_if_bandwidth`` broadcasts the whole pipeline
over candidate link-speed scalings for instant capacity-planning sweeps.
Everything is float32, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import torch_device as _td
from repro_torch.core.fabric.fabric import Fabric


class LinkCongestionSim:
    """Static route matrix + tensor trace reduction for one fabric, on
    ``torch_device`` (the card by default)."""

    def __init__(self, fabric: Fabric, hosts: Sequence[str],
                 device_nodes: Sequence[str], torch_device="cuda") -> None:
        self.device = _td.resolve(torch_device)
        self.hosts = list(hosts)
        self.device_nodes = list(device_nodes)
        self.link_names: List[str] = [f"{u}->{v}"
                                      for (u, v) in sorted(fabric.ports)]
        link_index = {name: i for i, name in enumerate(self.link_names)}
        n_pairs = len(self.hosts) * len(self.device_nodes)
        routes = np.zeros((n_pairs, len(self.link_names)), dtype=np.float32)
        for hi, h in enumerate(self.hosts):
            for di, d in enumerate(self.device_nodes):
                # ECMP-aware: fabric.paths is the path set actually routed
                # ([primary] when ecmp is off); each path carries 1/K.
                paths = fabric.paths(h, d)
                for path in paths:
                    for u, v in zip(path, path[1:]):
                        routes[hi * len(self.device_nodes) + di,
                               link_index[f"{u}->{v}"]] += 1.0 / len(paths)
        self.routes = torch.from_numpy(routes).to(self.device)     # (P, L)
        self.link_bw_bytes_per_s = torch.tensor(
            [fabric.ports[tuple(name.split("->"))].bw_gbps * 1e9
             for name in self.link_names], dtype=torch.float32,
            device=self.device)                                    # (L,)

    # ------------------------------------------------------------------ API
    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def pair_ids(self, host_idx, dev_idx) -> torch.Tensor:
        """Fuse per-access host/device indices into pair slots."""
        return (self._tensor(host_idx, torch.int32) * len(self.device_nodes)
                + self._tensor(dev_idx, torch.int32))

    def _inputs(self, host_idx, dev_idx, nbytes, window_s: float):
        return (self.pair_ids(host_idx, dev_idx).long(),
                self._tensor(nbytes, torch.float32),
                torch.tensor(window_s, dtype=torch.float32,
                             device=self.device))

    def estimate(self, host_idx, dev_idx, nbytes,
                 window_s: float) -> Dict[str, np.ndarray]:
        """Per-link utilization and per-pair slowdown for a trace assumed to
        span ``window_s`` seconds.  Returns plain-numpy arrays."""
        pair, b, window = self._inputs(host_idx, dev_idx, nbytes, window_s)
        pair_bytes = _pair_bytes(pair, b, self.routes.shape[0])
        util, slowdown = _congestion(pair_bytes, self.routes,
                                     self.link_bw_bytes_per_s, window)
        util = util.cpu().numpy()
        return {
            "link_names": self.link_names,
            "link_utilization": util,
            "pair_slowdown": slowdown.cpu().numpy(),
            "pair_bytes": pair_bytes.cpu().numpy(),
            "bottleneck_link": self.link_names[int(np.argmax(util))],
        }

    def what_if_bandwidth(self, host_idx, dev_idx, nbytes, window_s: float,
                          bw_scales: Sequence[float]) -> Dict[str, np.ndarray]:
        """The estimate over uniform link-speed scalings — 'what if the
        fabric were k x faster?' — broadcast over a leading scale axis in
        one pass, no Python loop."""
        pair, b, window = self._inputs(host_idx, dev_idx, nbytes, window_s)
        scales = self._tensor(bw_scales, torch.float32)
        pair_bytes = _pair_bytes(pair, b, self.routes.shape[0])
        util, slowdown = _congestion(
            pair_bytes, self.routes,
            self.link_bw_bytes_per_s[None, :] * scales[:, None], window)
        return {
            "bw_scales": scales.cpu().numpy(),
            "max_link_utilization": util.max(dim=-1).values.cpu().numpy(),
            "mean_pair_slowdown": slowdown.mean(dim=-1).cpu().numpy(),
        }


def _pair_bytes(pair_ids: torch.Tensor, nbytes: torch.Tensor,
                n_pairs: int) -> torch.Tensor:
    return torch.zeros(n_pairs, dtype=torch.float32,
                       device=nbytes.device).index_add_(0, pair_ids, nbytes)


def _congestion(pair_bytes: torch.Tensor, routes: torch.Tensor,
                link_bw_bytes_per_s: torch.Tensor, window_s: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Utilization ``(..., L)`` and slowdown ``(..., P)``; leading axes of
    ``link_bw_bytes_per_s`` (the what-if scales) broadcast through."""
    link_bytes = routes.T @ pair_bytes                          # (L,)
    util = link_bytes / (link_bw_bytes_per_s * window_s)
    # A pair is slowed by its most-congested link; utilization <= 1 is
    # free.  Membership (routes > 0), not the fractional ECMP weight,
    # selects which links can slow a pair.
    pair_congestion = torch.where(routes > 0, util[..., None, :],
                                  torch.zeros((), device=util.device)
                                  ).max(dim=-1).values
    return util, torch.clamp(pair_congestion, min=1.0)
