"""The closed loop: one caller hands in the next request only once the
previous one is done (synchronised on the device).  The window opens at
the first hand-in and closes when the request that ran past ``seconds``
is done, so every request counted ran whole inside it and its length is
the time that work took."""

import sys
import time
import traceback
from dataclasses import dataclass, field


@dataclass
class Window:
    seconds: float = 0.0          # from the first hand-in to the last done
    attempted: int = 0
    failed: int = 0
    units: float = 0.0            # work units done (patches, images, tasks)
    latencies: list = field(default_factory=list)


def closed_loop(request, seconds, max_requests=None, first=0,
                min_requests=1):
    """Run ``request(i)`` (returns the units of work it did, and returns
    only once its result is on the device) for i = first, first + 1, ...
    until ``seconds`` have passed (and at least ``min_requests`` ran) or
    ``max_requests`` ran."""
    w = Window()
    start = time.perf_counter()
    deadline = start + seconds
    i = first
    while True:
        t0 = time.perf_counter()
        try:
            w.units += request(i)
        except Exception:                  # counted as failed, never hidden
            w.failed += 1
            traceback.print_exc(file=sys.stderr)
        t1 = time.perf_counter()
        w.latencies.append(t1 - t0)
        w.attempted += 1
        i += 1
        if (t1 >= deadline and w.attempted >= min_requests) or (
                max_requests and w.attempted >= max_requests):
            break
    w.seconds = t1 - start
    return w
