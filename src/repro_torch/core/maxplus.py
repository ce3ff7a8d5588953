"""Max-plus prefix scans: the busy-until fold in closed form.

Every busy-until chain of the simulator (a switch port, a link, the media
occupancy, the QoS virtual-finish clock, the cached fill stage) is the
recurrence ``free_i = max(arr_i, free_{i-1}) + svc_i``.  With ``A`` the
running sum of the services it is one inclusive scan, ``free = A +
max(init, cummax(arr - A + svc))``, so a whole chain is a ``cumsum`` and a
``cummax`` on whatever device the arrivals lie on.  The associative
replay lane and the cached-CXL-SSD kernel's cross-check both use it.
Importing this module loads no torch.
"""

from __future__ import annotations


# "Never" sentinel of a gated chain's inactive elements: far enough below
# any tick that max() ignores it after every accumulated service time is
# added, far enough above int64's minimum that no addition wraps.
NEG = -((2**63 - 1) // 4)


def busy_until(arrivals, services, active=None, init=None):
    """Closed form of the sequential busy-until fold, in int64 on the
    arrivals' device.

    Sequential semantics (the switch-port / link / media / QoS
    virtual-finish-time rule)::

        free = init
        for i in range(N):
            if active[i]:
                free = max(arrivals[i], free) + services[i]
            out[i] = free

    ``services`` may vary per element or be one number; ``active`` gates
    elements that bypass the chain (e.g. cache hits on a fill path);
    ``init`` defaults to the "never" sentinel.  With ``a = where(active,
    services, 0)`` and ``A = cumsum(a)``, the chain is ``A + max(init,
    cummax(where(active, arrivals - A + a, NEG)))`` — an inclusive scan
    equal to the fold element for element (property-tested)."""
    import torch

    arr = torch.as_tensor(arrivals).to(torch.int64)
    svc = torch.as_tensor(services, device=arr.device).to(
        torch.int64).expand(arr.shape)
    if active is None:
        act = torch.ones(arr.shape, dtype=torch.bool, device=arr.device)
    else:
        act = torch.as_tensor(active, device=arr.device).to(torch.bool)
    a = torch.where(act, svc, 0)
    acc = torch.cumsum(a, dim=-1)
    key = torch.where(act, arr - acc + a, NEG)
    best = torch.cummax(key, dim=-1).values
    floor = NEG if init is None else int(init)
    return acc + torch.clamp(best, min=floor)


def port_busy_until(arrivals, services, ports, num_ports, init=0):
    """Closed form of ``num_ports`` independent busy-until chains selected
    per element — the ECMP route-choice shape, where access *i* occupies
    port ``ports[i]`` out of the path set's port union.

    Sequential semantics::

        free = [init] * num_ports
        for i in range(N):
            free[ports[i]] = max(arrivals[i], free[ports[i]]) + services[i]
            out[i] = free[ports[i]]

    Each port is one gated chain of :func:`busy_until` over an ``(N, P)``
    one-hot, all ports in one pass; returns each element's own-port value
    after its update, equal to the fold (property-tested)."""
    import torch

    arr = torch.as_tensor(arrivals).to(torch.int64)
    svc = torch.as_tensor(services, device=arr.device).to(
        torch.int64).expand(arr.shape)
    pt = torch.as_tensor(ports, device=arr.device).to(torch.int64)
    onehot = (torch.arange(num_ports, device=arr.device)[None, :]
              == pt[:, None])
    a = torch.where(onehot, svc[:, None], 0)
    acc = torch.cumsum(a, dim=0)
    key = torch.where(onehot, arr[:, None] - acc + a, NEG)
    free = acc + torch.clamp(torch.cummax(key, dim=0).values, min=int(init))
    return torch.gather(free, 1, pt[:, None])[:, 0]
