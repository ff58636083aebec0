"""What the metric readers (``metrics/<name>.py``) share.  A reader takes
the run's context and returns a number, or None where the run holds
nothing to read it from; then the metric is left out of the line.  None
of them returns 0 for a share of a roofline or of a peak."""

import math

from portbench.yardstick import peaks


def percentile(values, q):
    """The q-th percentile (0 < q <= 100) of ``values`` by nearest rank:
    the smallest value that at least q% of them do not exceed."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def _done(w):
    return w.attempted - w.failed


def call_share(ctx):
    """The whole call's counted work (``entry.work["call"]``: flops, bytes
    a request) over the untraced window's time a request, against the
    peaks of the cell's cards, in %."""
    w = ctx.window
    if "call" not in ctx.entry.work or _done(w) <= 0:
        return None
    flops, nbytes = ctx.entry.work["call"]
    return peaks.share_pct(flops, nbytes, w.seconds / _done(w), ctx.chips)


def kernel_share(ctx, key):
    """The counted work of one kernel's launches a request
    (``entry.work[key]``) times the traced requests, over the device time
    of the kernels whose name holds ``entry.work[key + "_tag"]``, in %."""
    tr = ctx.trace
    if tr is None or key not in ctx.entry.work or not tr.requests:
        return None
    t = tr.kernel_time(ctx.entry.work[key + "_tag"])
    if t <= 0:
        return None
    flops, nbytes = ctx.entry.work[key]
    return peaks.share_pct(flops * tr.requests, nbytes * tr.requests, t)


def idle_pct(ctx):
    """1 - busy / window of the traced window, averaged over the cards, in
    %; None where the trace saw no device work."""
    tr = ctx.trace
    if tr is None or not tr.busy_s or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.mean_busy_s(ctx.devices) / tr.window_s)
