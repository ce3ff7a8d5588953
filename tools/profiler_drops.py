#!/usr/bin/env python3
"""Count how often ``torch.profiler`` misses the card's work.

    python tools/profiler_drops.py [SESSIONS] [REPS]

Opens SESSIONS profiler sessions (default 400) one after another in one
process, as ``chip_smoke.py`` does, each around REPS calls (default 24)
that launch one kernel each (alternately an elementwise add on 4 MB and an
``index_select`` of two rows), and counts the device events each session
recorded.  Prints one JSON line: the number of sessions, how many recorded
no device activity at all, how many recorded fewer kernels than were
launched, the indices of the empty sessions, and the card's name and power
limit.  Needs a CUDA card.
"""

import json
import subprocess
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def main() -> int:
    sessions = int(sys.argv[1]) if len(sys.argv) > 1 else 400
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 24
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    x = torch.zeros(1 << 20, device="cuda")
    rows = torch.zeros(64, 1 << 14, device="cuda")
    idx = torch.tensor([3, 7], device="cuda")

    def call(i):
        if i % 2:
            x.add_(1.0)
        else:
            torch.index_select(rows, 0, idx)

    call(0)
    torch.cuda.synchronize()
    empty, short = [], 0
    for s in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                call(i)
            torch.cuda.synchronize()
        n = sum(e.device_type == DeviceType.CUDA for e in prof.events())
        if n == 0:
            empty.append(s)
        elif n < reps:
            short += 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({"sessions": sessions, "launches_per_session": reps,
                      "empty_sessions": len(empty),
                      "short_sessions": short, "empty_at": empty,
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
