"""The formulas of the metrics read from the program's own spans
(``expecto_tpu_torch/utils/profiling.py``): the spans the profiled stretch
recorded, a root span a call. Each returns None where the run has nothing
for it to read: another flow, no profiled stretch, or fewer roots of its
kind than the stretch's calls (a program without these spans records
none)."""

from __future__ import annotations

#: the runner's spans inside a method's span; every other ``runner.*`` span
#: is a public method's
RUNNER_PARTS = ("runner.plan", "runner.produce", "runner.in_flight", "runner.wait", "runner.write")


def _recorded():
    """The program's recorded spans, or None where it records none."""
    try:
        from expecto_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return read() if callable(read) else None


def _calls(run, flow: str, root: str):
    """[(root span, the spans under it)] of the stretch's last
    ``run.trace_calls`` roots named ``root``, or None."""
    if run.flow != flow or run.trace is None or run.trace_calls <= 0:
        return None
    recorded = _recorded()
    if not recorded:
        return None
    roots = sorted((s for s in recorded if s.name == root and s.parent is None), key=lambda s: s.start_ns)
    if len(roots) < run.trace_calls:
        return None
    inside = {r.id: [] for r in roots[-run.trace_calls:]}
    for s in recorded:
        if s.root in inside and s.parent is not None:
            inside[s.root].append(s)
    return [(r, inside[r.id]) for r in roots[-run.trace_calls:]]


def _union_ns(spans, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi] that the spans cover."""
    covered, last = 0, lo
    for start, end in sorted((max(s.start_ns, lo), min(s.end_ns, hi)) for s in spans):
        if end > last:
            covered += end - max(start, last)
            last = end
    return covered


def _is_method(s) -> bool:
    return s.name.startswith("runner.") and s.name not in RUNNER_PARTS


def self_ms(run, flow: str, root: str):
    """Mean milliseconds a call of the ``root`` span outside the runner's
    public-method spans under it: the host time of the layers above the
    runner, measured inside the program."""
    calls = _calls(run, flow, root)
    if calls is None:
        return None
    own = [r.end_ns - r.start_ns - _union_ns([s for s in inside if _is_method(s)], r.start_ns, r.end_ns)
           for r, inside in calls]
    return sum(own) / len(own) / 1e6


def starved_ms(run, flow: str, root: str):
    """Mean milliseconds a call of the ``root`` span outside the union of
    its ``runner.in_flight`` spans (a chunk from the start of its production
    to the end of its landing's wait): the time the program had no chunk
    queued for the card."""
    calls = _calls(run, flow, root)
    if calls is None:
        return None
    idle = [r.end_ns - r.start_ns - _union_ns([s for s in inside if s.name == "runner.in_flight"], r.start_ns,
                                                r.end_ns) for r, inside in calls]
    return sum(idle) / len(idle) / 1e6


def device_ms(run, flow: str, root: str, stage: str):
    """Mean device milliseconds a call of the ``stage`` spans under each
    ``root`` (their CUDA events' elapsed time; the host's where they have
    none), or None where a call has none."""
    calls = _calls(run, flow, root)
    if calls is None:
        return None
    per_call = [[s.device_ms for s in inside if s.name == stage] for _r, inside in calls]
    if not all(per_call):
        return None
    return sum(sum(ms) for ms in per_call) / len(per_call)
