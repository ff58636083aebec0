"""What the span readers share: the program's own spans of the traced
window.

While the profiler runs, the program keeps a record of each of its spans
(``lyssandra_tpu_torch.utils.spans()``: name, start_ns, end_ns, parent,
request, attrs; ``parent`` the record's index of the enclosing span or -1,
``request`` shared by the spans under one outermost span).  Only the
traced window runs under the profiler, so its requests are the last
``trace.requests`` request ids of the store.  A reader gives its quantity
a request of that window, or None where there is no trace, where the
program keeps no spans (one that predates them), where the store holds
fewer requests than were traced, or where no span of the name is there."""

from collections import defaultdict


def program_spans():
    """The program's span records, or None where it keeps none."""
    try:
        from lyssandra_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans()


def window(records, requests):
    """{index: record} of the closed spans of the last ``requests``
    request ids among ``records`` (the index is the one ``parent`` refers
    to); None where the records hold fewer requests."""
    if not requests:
        return None
    ids = sorted({r.request for r in records})
    if len(ids) < requests:
        return None
    keep = set(ids[-requests:])
    return {i: r for i, r in enumerate(records)
            if r.request in keep and r.end_ns is not None}


def _named(win, name, parent=None):
    return [(i, r) for i, r in win.items() if r.name == name and (
        parent is None or (r.parent in win and win[r.parent].name == parent))]


def total_ns(win, name, parent=None):
    """The summed length of the spans called ``name`` (whose enclosing
    span is called ``parent``, where given); None where there is none."""
    found = _named(win, name, parent)
    if not found:
        return None
    return sum(r.end_ns - r.start_ns for _, r in found)


def self_ns(win, name):
    """The summed self time of the spans called ``name``: each one's length
    less the part of it that its child spans cover; None where there is
    none."""
    found = _named(win, name)
    if not found:
        return None
    children = defaultdict(list)
    for r in win.values():
        children[r.parent].append((r.start_ns, r.end_ns))
    out = 0
    for i, r in found:
        covered, reach = 0, r.start_ns
        for s, e in sorted(children[i]):
            s, e = max(s, reach), min(e, r.end_ns)
            if e > s:
                covered += e - s
                reach = e
        out += r.end_ns - r.start_ns - covered
    return out


def attr_sum(win, name, key):
    """The sum of attribute ``key`` over the spans called ``name``; None
    where there is none."""
    found = _named(win, name)
    if not found:
        return None
    return sum(r.attrs.get(key, 0) for _, r in found)


def per_request(ctx, quantity, scale=1.0):
    """``quantity(window)`` times ``scale`` over the traced requests; None
    where the run has nothing to read it from."""
    tr = ctx.trace
    if tr is None or not tr.requests:
        return None
    records = program_spans()
    if records is None:
        return None
    win = window(records, tr.requests)
    if win is None:
        return None
    value = quantity(win)
    return None if value is None else scale * value / tr.requests
