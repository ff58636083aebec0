"""A traced window, reduced: ``torch.profiler`` (CPU and CUDA activity)
around the loop, read back as device intervals (kernels, copies, sets) and
host intervals (ops, runtime calls, the harness's spans).

- busy time of a card: the union of its device intervals inside the
  window (copied from ``tools/profile_encoders.py``'s union);
- idle share: 1 - busy / window;
- device time by kernel name, and the number of kernel launches;
- idle gaps: the stretches of the window in which a card ran nothing,
  each put to the innermost host interval around its middle, which says
  what the host was doing meanwhile."""

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW_SPAN = "portbench.window"
SPANS = {WINDOW_SPAN}
MAX_LABELLED_GAPS = 5000


@dataclass
class Trace:
    window_s: float
    busy_s: dict                      # device index -> seconds
    kernel_s: dict = field(default_factory=dict)   # short name -> seconds
    launches: int = 0                 # kernel launches, all cards
    gaps: dict = field(default_factory=dict)       # host label -> seconds
    requests: int = 0

    def mean_busy_s(self, devices):
        return sum(self.busy_s.get(d, 0.0) for d in devices) / len(devices)

    def kernel_time(self, tag):
        """Device seconds of the kernels whose name holds ``tag``."""
        return sum(s for n, s in self.kernel_s.items() if tag in n)

    def breakdown(self):
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in gaps]}


def short(name):
    """A kernel's name without its return type, anonymous namespaces and
    argument list."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].removeprefix("void ").strip()
    return name if len(name) <= 80 else name[:77] + "..."


def span(name):
    """A host span around a call into the program (``record_function``);
    its name is kept, so that the span's device-side copy in the trace is
    not taken for device work."""
    import torch

    SPANS.add(name)
    return torch.profiler.record_function(name)


def _kind(on_device, name, annotation):
    if not on_device:
        return "host"
    if annotation or name in SPANS:
        return None                       # a span's device-side shadow
    return "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"


def _events(prof):
    """(on_device, name, start_ns, end_ns, device index, kind) of every
    event; kind is 'kernel', 'copy' or 'host'."""
    from torch.autograd import DeviceType

    out = []
    try:
        for e in prof.profiler.kineto_results.events():
            dev = e.device_type() == DeviceType.CUDA
            name = e.name()
            note = getattr(e, "is_user_annotation", lambda: False)()
            kind = _kind(dev, name, note)
            if kind is None:
                continue
            if hasattr(e, "start_ns"):
                s, d = e.start_ns(), e.duration_ns()
            else:
                s, d = e.start_us() * 1000, e.duration_us() * 1000
            out.append((dev, name, s, s + d, e.device_index(), kind))
        return out
    except AttributeError:               # another torch's event class
        out = []
    for e in prof.events():
        dev = e.device_type == DeviceType.CUDA
        kind = _kind(dev, e.name, False)
        if kind is None:
            continue
        out.append((dev, e.name, int(e.time_range.start * 1000),
                    int(e.time_range.end * 1000), e.device_index, kind))
    return out


def _union(intervals, lo, hi):
    """Merged [start, end) intervals clipped to [lo, hi]."""
    merged = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _label(host, starts, t):
    """The innermost host interval around time t: the latest-starting one
    that has not ended."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 20000), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "(no host op)"


def reduce(prof, requests):
    evs = _events(prof)
    win = [(s, e) for dev, n, s, e, _, _ in evs
           if not dev and n == WINDOW_SPAN]
    if not win:
        raise RuntimeError("the trace holds no window span")
    lo, hi = win[0]
    by_dev = defaultdict(list)
    kernel_ns = defaultdict(int)
    launches = 0
    host = []
    for dev, name, s, e, idx, kind in evs:
        if not dev:
            if name != WINDOW_SPAN:
                host.append((s, e, name))
            continue
        if e <= lo or s >= hi:
            continue
        by_dev[idx].append((s, e))
        if kind == "kernel":
            launches += 1
            kernel_ns[short(name)] += min(e, hi) - max(s, lo)
        else:
            kernel_ns[name.split(" (")[0]] += min(e, hi) - max(s, lo)
    host.sort()
    starts = [h[0] for h in host]
    busy = {}
    gaps = []
    for idx, ivs in by_dev.items():
        merged = _union(ivs, lo, hi)
        busy[idx] = sum(e - s for s, e in merged) / 1e9
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        gaps += [(edges[k + 1] - edges[k], edges[k])
                 for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]
    gaps.sort(reverse=True)
    labelled = defaultdict(float)
    for length, start in gaps[:MAX_LABELLED_GAPS]:
        labelled[_label(host, starts, start + length // 2)] += length / 1e9
    return Trace(window_s=(hi - lo) / 1e9, busy_s=busy,
                 kernel_s={n: ns / 1e9 for n, ns in kernel_ns.items()},
                 launches=launches, gaps=dict(labelled), requests=requests)


def traced(loop, synchronize):
    """Run ``loop()`` (returns its Window) under the profiler; returns
    (the Window, the reduced Trace, host seconds spent reducing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with span(WINDOW_SPAN):
            w = loop()
            synchronize()
    t0 = time.perf_counter()
    tr = reduce(prof, w.attempted)
    return w, tr, time.perf_counter() - t0
