"""Device trace of a stretch of calls: ``torch.profiler`` over the CPU and
the card, read from the profiler's raw events (building ``prof.events()``
takes seconds for long stretches). The benchmark's own spans are
``record_function`` ranges named ``bench.*``; device operations are the
card's kernels, copies and sets (annotation ranges left out).

From it: the stretch's length on the host, the card's busy time (the union
of its operations), device seconds by kernel name and by stage (the
substrings of ``stages.json``), and the idle gaps, each named by the
innermost benchmark span the host was in at the gap's middle. The reading
of busy and idle follows ``scripts/profile_*_torch.py`` and
``chip_smoke.py``'s ``profiled_events`` / ``_union_us``.
"""

from __future__ import annotations

import json
import os
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SPAN_PREFIX = "bench."


def stage_map() -> dict:
    with open(os.path.join(HERE, "stages.json")) as f:
        return json.load(f)["stages"]


def stage_of(kernel: str, stages: dict) -> str | None:
    for stage, needles in stages.items():
        if any(n in kernel for n in needles):
            return stage
    return None


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: dict = field(default_factory=dict)  # name -> device seconds
    stage_s: dict = field(default_factory=dict)  # stage -> device seconds
    gaps: list = field(default_factory=list)  # (seconds, span name), longest first


def _is_annotation(e, host_names: set) -> bool:
    """A ``record_function`` range drawn on the card's timeline: flagged as
    such where this torch says so, else known by its name, which is also a
    host event's (kernel and copy names never are)."""
    flag = getattr(e, "is_user_annotation", None)
    if flag is not None and flag():
        return True
    return e.name() in host_names or e.name().startswith(SPAN_PREFIX)


@contextmanager
def profiled():
    """A profiler over the CPU and the card; yields a holder whose
    ``summary`` is set on exit."""
    from torch.profiler import ProfilerActivity, profile

    holder = type("Holder", (), {"summary": None})()
    cuda = torch.cuda.is_available()
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        with torch.profiler.record_function(SPAN_PREFIX + "stretch"):
            yield holder
            if cuda:
                torch.cuda.synchronize()
    holder.summary = summarize(prof.profiler.kineto_results.events())


def summarize(events) -> TraceSummary:
    cuda = torch.autograd.DeviceType.CUDA
    events = list(events)
    host_names = {e.name() for e in events if e.device_type() != cuda}
    spans, ops = [], []
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == cuda:
            if not _is_annotation(e, host_names):
                ops.append((start, end, e.name()))
        elif e.name().startswith(SPAN_PREFIX):
            spans.append((start, end, e.name()))
    stretch = [s for s in spans if s[2] == SPAN_PREFIX + "stretch"]
    if not stretch:
        raise RuntimeError("the trace holds no stretch span")
    w0, w1 = stretch[0][0], stretch[0][1]
    stages = stage_map()
    kernel_s: dict = {}
    stage_s: dict = {}
    for start, end, name in ops:
        kernel_s[name] = kernel_s.get(name, 0.0) + (end - start) / 1e9
        st = stage_of(name, stages)
        if st is not None:
            stage_s[st] = stage_s.get(st, 0.0) + (end - start) / 1e9
    # the union of device operations inside the stretch, and the gaps
    busy = 0
    gaps = []
    last = w0
    for start, end, _name in sorted(ops):
        start, end = max(start, w0), min(end, w1)
        if end <= start:
            continue
        if start > last:
            gaps.append((last, start))
        if end > last:
            busy += end - max(start, last)
            last = end
    if w1 > last:
        gaps.append((last, w1))
    inner = [s for s in spans if s[2] != SPAN_PREFIX + "stretch"]

    def name_of(t):
        best = None
        for start, end, name in inner:
            if start <= t <= end and (best is None or end - start < best[1] - best[0]):
                best = (start, end, name)
        return best[2][len(SPAN_PREFIX):] if best else "outside calls"

    gaps.sort(key=lambda g: g[0] - g[1])
    named = [((b - a) / 1e9, name_of((a + b) / 2)) for a, b in gaps[:10]]
    return TraceSummary(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, kernel_s=kernel_s, stage_s=stage_s, gaps=named)
