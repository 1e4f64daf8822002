"""Spans of the port's stages, and profiler traces (the JAX package's
``utils/profiling.py`` writes traces only).

A span marks one stage of the program: a scoring call, its host stages, a
runner method and its chunks, a training sweep's upload and rounds. It
records only while a torch profiler is recording, so it lies on the
profiler's timeline beside the card's kernels and copies:

- ``span(name, *, device=False, **counts)``: a context manager. While a
  profiler records in this thread it opens a ``record_function`` range of
  the same name and keeps a :class:`Span`: name, start and end on
  ``time.time_ns()`` (the clock of the profiler's host events), its id, its
  parent's and its root's, the thread and its counts (rows, bytes up, bytes
  down, ``pack4``: a runner chunk sent 4 bits a base). ``device``, a CUDA
  device, adds two timing events on its current stream, whose elapsed time
  is resolved when the span is read: no synchronise is added (a CPU device
  adds none). With no profiler
  recording, ``span`` returns the shared no-op :data:`OFF` after one check.
  ``spanned(name)`` puts each call of a function in such a span.
- ``begin(name, **counts)``: a span ended by its ``end()``, from any
  thread (a chunk in flight ends on the worker that lands it); one never
  ended is never recorded. It keeps a record only: the profiler's ranges
  belong to one thread.
- ``current()``: the innermost open span of this thread; its
  ``child(name, **counts)`` is a span for a worker thread, with that span as
  its parent (record only, as ``begin``).
- ``count(**counts)``: adds to the counts of this thread's innermost span.
- ``spans()``, ``dropped()``, ``reset(limit)``: the recorder, which keeps
  the newest ``SPAN_LIMIT`` closed spans and counts those it drops.
- ``trace(log_dir)``: records the enclosed block with ``torch.profiler``
  (host activity, and the card's kernels and copies when CUDA is available)
  and writes its Chrome trace, ``trace_<pid>_<ns>.json``, and the spans it
  recorded, ``spans_<pid>_<ns>.jsonl`` (one JSON object a line), under
  ``log_dir``. Open the trace in Perfetto or chrome://tracing.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from collections import deque

import torch

#: closed spans the recorder keeps; past it the oldest go, counted
SPAN_LIMIT = 65536

#: whether a torch profiler records in the calling thread: the one check a
#: span makes when none does
_profiler_enabled = torch._C._autograd._profiler_enabled

_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The span of a thread in which no profiler records: does nothing,
    tests false."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def add(self, **counts) -> None:
        pass

    def end(self) -> None:
        pass

    def child(self, name: str, **counts):
        return self


OFF = _Off()


class _Recorder:
    def __init__(self, limit: int):
        self.kept: deque = deque(maxlen=limit)
        self.dropped = 0
        self.lock = threading.Lock()

    def keep(self, s: Span) -> None:
        with self.lock:
            if len(self.kept) == self.kept.maxlen:
                self.dropped += 1
            self.kept.append(s)


_recorder = _Recorder(SPAN_LIMIT)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _top():
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def _stream(device):
    """The CUDA stream a span's timing events go on, or None."""
    if device is False or device is None:
        return None
    device = torch.device(device)
    return torch.cuda.current_stream(device) if device.type == "cuda" else None


class Span:
    """One recorded span. ``host_ms`` is its length on the host clock;
    ``device_ms`` the elapsed time between its two CUDA events (resolved on
    first read, waiting for the end event), or ``host_ms`` where it has
    none."""

    __slots__ = ("name", "id", "parent", "root", "thread", "start_ns", "end_ns", "counts", "_events", "_device_ms",
                 "_range")

    def __init__(self, name: str, counts: dict, parent: Span | None, device=False):
        self.name, self.counts = name, counts
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        self.root = self.id if parent is None else parent.root
        self.thread = threading.get_native_id()
        self.start_ns = self.end_ns = 0
        stream = _stream(device)
        self._events = None if stream is None else (torch.cuda.Event(enable_timing=True),
                                                    torch.cuda.Event(enable_timing=True), stream)
        self._device_ms = None
        self._range = None

    def _open(self, ranged: bool) -> Span:
        if ranged:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self._events is not None:
            self._events[0].record(self._events[2])
        self.start_ns = time.time_ns()
        return self

    def _close(self, exc=(None, None, None)) -> None:
        self.end_ns = time.time_ns()
        if self._events is not None:
            self._events[1].record(self._events[2])
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _recorder.keep(self)

    def __enter__(self) -> Span:
        _stack().append(self)
        return self._open(_profiler_enabled())

    def __exit__(self, *exc):
        _stack().pop()
        self._close(exc)
        return False

    def __bool__(self):
        return True

    def add(self, **counts) -> None:
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v

    def end(self) -> None:
        self._close()

    def child(self, name: str, **counts) -> Span:
        return Span(name, counts, self)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> float:
        if self._events is None:
            return self.host_ms
        if self._device_ms is None:
            start, end, _stream_ = self._events
            end.synchronize()
            self._device_ms = float(start.elapsed_time(end))
        return self._device_ms

    def as_dict(self) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent, "root": self.root, "thread": self.thread,
                "start_ns": self.start_ns, "end_ns": self.end_ns, "host_ms": self.host_ms,
                "device_ms": self.device_ms, "counts": self.counts}


def span(name: str, *, device=False, **counts):
    """A span of the enclosed block (see the module's docstring)."""
    if not _profiler_enabled():
        return OFF
    return Span(name, counts, _top(), device)


def spanned(name: str):
    """A decorator: each call of the function inside a span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapped

    return wrap


def begin(name: str, **counts):
    """A span from now to its ``end()``, which any thread may call."""
    if not _profiler_enabled():
        return OFF
    return Span(name, counts, _top())._open(False)


def current():
    """This thread's innermost open span, or :data:`OFF`."""
    if not _profiler_enabled():
        return OFF
    return _top() or OFF


def count(**counts) -> None:
    """Add ``counts`` to this thread's innermost open span."""
    if not _profiler_enabled():
        return
    top = _top()
    if top is not None:
        top.add(**counts)


def spans() -> list[Span]:
    """The recorded spans, in the order they closed."""
    with _recorder.lock:
        return list(_recorder.kept)


def dropped() -> int:
    """Spans the recorder let go since its last reset."""
    return _recorder.dropped


def reset(limit: int = SPAN_LIMIT) -> None:
    """Forget every recorded span; keep at most ``limit`` from now on."""
    global _recorder
    _recorder = _Recorder(limit)


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Capture a torch profiler trace of the enclosed block, and its spans,
    into ``log_dir``; with None, run the block untraced."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.time_ns()
    with profile(activities=activities) as prof:
        yield
    stamp = f"{os.getpid()}_{time.time_ns()}"
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{stamp}.json"))
    with open(os.path.join(log_dir, f"spans_{stamp}.jsonl"), "w") as f:
        for s in spans():
            if s.start_ns >= t0:
                f.write(json.dumps(s.as_dict()) + "\n")
