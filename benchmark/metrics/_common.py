"""The formulas the metric readers share; each reader sets its flow (and
stage) and calls one of these. Each returns None where the run has nothing
for it to read."""

from __future__ import annotations


def rate(run, flow: str):
    """Units completed over the window's seconds: every whole call of the
    window, all its time."""
    if run.flow != flow or run.window_s <= 0:
        return None
    return run.units / run.window_s


def ms_per_unit(run, flow: str):
    """The window's milliseconds over the units it completed."""
    if run.flow != flow or run.units == 0:
        return None
    return run.window_s * 1e3 / run.units


def roofline(run, flow: str, stage: str):
    """Percent of the stage's roofline: the least time its work in the
    profiled calls needs (the larger of operations over the configuration's
    peak and bytes over HBM's, ``benchmark/flops.py``), over the device time
    of the kernels ``stages.json`` maps to the stage in the trace."""
    if run.flow != flow or run.trace is None:
        return None
    seconds = run.trace.stage_s.get(stage, 0.0)
    if seconds <= 0 or stage not in run.work.flops:
        return None
    k = run.trace_calls
    least = max(k * run.work.flops[stage] / run.peak_flops, k * run.work.bytes[stage] / run.peak_bytes)
    return 100.0 * least / seconds


def idle_pct(run, flow: str):
    """Percent of the profiled stretch (whole calls after the window) in
    which no kernel, copy or set ran on the card, from the device trace."""
    if run.flow != flow or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def mfu(run, flow: str):
    """The model's least operations for the work the window completed, over
    the window and the configuration's peak (``peaks.json``), percent;
    from the run's own counts, not from the trace."""
    if run.flow != flow or run.calls == 0:
        return None
    return 100.0 * run.calls * run.work.total_flops / (run.window_s * run.peak_flops)


def host_ms(run, flow: str):
    """Host milliseconds a call spends outside the runner's device methods:
    each traced call's wall less the time inside ``BelugaRunner``'s public
    methods it called (the benchmark's host spans around them), mean over
    the window's calls."""
    if run.flow != flow or not run.host:
        return None
    return sum(wall - inside for wall, inside in run.host) / len(run.host) * 1e3
