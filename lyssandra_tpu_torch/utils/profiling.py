"""Tracing and timing hooks (``lyssandra_tpu.utils.profiling``
counterpart): ``profile_trace`` wraps a region in a ``torch.profiler``
trace written as a Chrome/Perfetto JSON file; ``timed`` times a call with
a device sync after each run; ``span`` and ``spanned`` mark a stretch of
the program.

Program spans.  The port marks its layers with ``span(name, **attrs)`` (a
context manager) or ``spanned(name)`` (a decorator, for a whole
function):

- ``lyssa.encode``: ``SparseEncoder.encode``, whole;
- ``lyssa.encode.block``: each block's solver call in ``encode``;
- ``lyssa.denoise``: ``Denoiser.__call__``, whole;
- ``lyssa.denoise.phase2``: the two-phase coder from its first count of
  the lanes left after phase 1 to the end of its re-solve loop; ``lanes``,
  that count (the lanes re-solved);
- ``lyssa.denoise_adaptive``: ``apps.denoise_adaptive``, whole;
- ``lyssa.ksvd.fit``: ``KSVDLearner.fit``, whole;
- ``lyssa.ksvd.iteration``: each iteration of ``fit`` with its metrics;
- ``lyssa.ksvd.sweep``: the atom sweep of a K-SVD iteration (the dense
  one is ``ksvd_atom_update``, whole); ``replayed``, 1 where the dense
  sweep ran as a replay of its CUDA graph, else 0; ``fused``, 1 where it
  ran as one launch of the kernel ``csrc/ksvd_sweep.cu`` (float32 on a GPU,
  one atom a step, inside its envelope), else 0;
- ``lyssa.ksvd.post``: its stats, atom replacement and normalisation;
- ``lyssa.online.fit``: ``OnlineDictionaryLearner.fit``, whole;
- ``lyssa.online.step``: ``dict_learning.online.minibatch_update``, the
  Mairal update of one minibatch (``fit`` and ``partial_fit`` alike);
- ``lyssa.online.code``: its coding; ``syncs``, the solvers' host reads
  during it (the ``solvers.lasso.host_syncs()`` delta);
- ``lyssa.online.sweep``: its atom sweep (``_dict_update_body``);
  ``fused``, 1 where the sweeps ran as one launch of the kernel
  ``csrc/online_sweep.cu`` (float32 on a GPU, inside its envelope), else 0
  (the plain loop, about 8 launches an atom);
- ``lyssa.fs.cold``: ``feature_sign``'s cold start (the fused kernel on a
  GPU).

While a torch profiler runs (``profile_trace``, or any
``torch.profiler.profile``), each span is a ``record_function`` range of
the trace, on the clock of the device's kernels, and a record in an
in-memory store that ``spans()`` returns: (name, start_ns, end_ns, parent,
request, attrs), stamped with ``time.time_ns()`` inside the range.
``parent`` is the store index of the enclosing span of the same thread, or
-1; a span opened under no other starts a new ``request`` id, which the
spans inside it share.  The attributes are in the records only, not in the
exported trace; ``with span(name) as attrs`` gives the open span's
attribute dict (None with no profiler running), for a count known only at
the end.  The store holds ``SPAN_CAPACITY`` records; past that,
spans are dropped and counted (``dropped_spans()``).  ``clear_spans()``
empties it; call it with no span open.

With no profiler running, a span reads the profiler's flag and does
nothing else: ``span`` returns one shared no-op object, ``spanned`` calls
the function.  It records nothing and calls no torch op.  The spans add no
host read and no kernel launch either way: the counts they carry are ones
the program reads anyway."""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
import time
from typing import Any, Callable, NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_CAPACITY = 1 << 16


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int | None            # None while the span is open
    parent: int                   # store index of the enclosing span, or -1
    request: int
    attrs: dict


class _NoSpan:
    """What ``span`` returns with no profiler running."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_NO_SPAN = _NoSpan()


class _Span:
    """An open span: a ``record_function`` range and its store record."""

    __slots__ = ("name", "attrs", "index", "parent", "request", "start_ns",
                 "end_ns", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.end_ns = None

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        _STORE.open(self)
        self.start_ns = time.time_ns()
        return self.attrs

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        _STORE.close()
        self._range.__exit__(*exc)
        return False

    def record(self) -> SpanRecord:
        return SpanRecord(self.name, self.start_ns, self.end_ns, self.parent,
                          self.request, dict(self.attrs))


class _SpanStore:
    """The records of the spans opened while a profiler ran, in the order
    they were opened; a stack of open spans per thread."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.records: list[_Span] = []
        self.dropped = 0
        self._lock = threading.Lock()
        self._requests = itertools.count()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, s: _Span) -> None:
        stack = self._stack()
        top = stack[-1] if stack else None
        with self._lock:
            s.parent = top.index if top is not None else -1
            s.request = (top.request if top is not None
                         else next(self._requests))
            if len(self.records) < self.capacity:
                s.index = len(self.records)
                self.records.append(s)
            else:
                s.index = -1
                self.dropped += 1
        stack.append(s)

    def close(self) -> None:
        self._stack().pop()

    def snapshot(self) -> list[SpanRecord]:
        with self._lock:
            return [s.record() for s in self.records]

    def clear(self) -> None:
        with self._lock:
            self.records = []
            self.dropped = 0


_STORE = _SpanStore(SPAN_CAPACITY)


def span(name: str, **attrs):
    """A context manager that marks a stretch of the program as ``name``
    with ``attrs`` (see the module docstring).  A no-op unless a torch
    profiler is running."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, attrs)


def spanned(name: str) -> Callable:
    """A decorator that makes each call of a function the span ``name``.
    With no profiler running the function is called directly."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name, {}):
                return fn(*args, **kwargs)
        return call
    return wrap


def spans() -> list[SpanRecord]:
    """The stored span records, in the order their spans opened."""
    return _STORE.snapshot()


def dropped_spans() -> int:
    """Spans not stored because the store was full."""
    return _STORE.dropped


def clear_spans() -> None:
    """Empty the store and its count of dropped spans."""
    _STORE.clear()


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """Trace the region with ``torch.profiler`` (CPU ops, and the GPU's
    kernels where one is present) and write it to ``logdir/trace.json``, a
    Chrome/Perfetto trace, on exit.  The program's spans (``lyssa.*``)
    appear in the trace as ranges and in ``spans()`` as records.  A no-op
    when logdir is None."""
    if logdir is None:
        yield
        return
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _sync(tree: Any) -> None:
    """Wait for the GPUs that hold the tensors of ``tree``."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def timed(fn: Callable, *args, warmup: int = 1, reps: int = 3, **kw):
    """(result, seconds per call): ``warmup`` untimed calls (at least
    one), then the mean over ``reps`` calls, each waited for on its
    result's device."""
    for _ in range(max(warmup, 1)):
        _sync(fn(*args, **kw))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args, **kw)
        _sync(out)
    return out, (time.perf_counter() - t0) / reps
