"""The harness: finds a cell's configuration, traffic mix and metric
readers by the names in ``BENCHMARK.json``, sets the flow up, measures a
window of whole calls, optionally profiles a stretch after it, checks the
outputs against the plain reference, and assembles the result line.

Everything a cell needs is found by name, in a file of its own:
``configs[].file`` for the configuration, ``benchmark/traffic/<traffic>.json``
for the traffic mix, whose ``"flow"`` names ``benchmark/flows/<flow>.py``
(the program's entry, inputs and check) and whose ``"arrival"`` names
``benchmark/arrivals/<arrival>.py`` (how the window's calls are made), and
``benchmark/metrics/<name>.py`` for each metric's reader, end-to-end and
per-layer alike (``read(run) -> float | None``). A later cell or metric is
added as files and entries, with no edit to a file that is here.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "expecto_tpu")


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    workload: dict
    config: dict  # the manifest's entry
    cfg: dict  # the configuration file
    traffic: dict  # the traffic file
    end_to_end: list
    per_layer: list


def traffic_path(name: str, root: str = ROOT) -> str:
    return os.path.join(root, "benchmark", "traffic", f"{name}.json")


def metric_path(name: str, root: str = ROOT) -> str:
    return os.path.join(root, "benchmark", "metrics", f"{name}.py")


def flow_path(name: str, root: str = ROOT) -> str:
    return os.path.join(root, "benchmark", "flows", f"{name}.py")


def arrival_path(name: str, root: str = ROOT) -> str:
    return os.path.join(root, "benchmark", "arrivals", f"{name}.py")


def find_cell(manifest: dict, name: str, root: str = ROOT) -> Cell:
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(by_name)})")
    w = by_name[name]
    config = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if ((name in m["workloads"]) if "workloads" in m else (m["moves"] in moved))]
    return Cell(w, config, load_json(os.path.join(root, config["file"])), load_json(traffic_path(w["traffic"], root)),
                e2e, per_layer)


def load_module(path: str, module: str):
    """The module in file ``path``, under the name ``module`` (a name inside
    the ``benchmark`` package, so its relative imports resolve)."""
    if module in sys.modules and getattr(sys.modules[module], "__file__", None) == path:
        return sys.modules[module]
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[module]
        raise
    return mod


def load_reader(name: str, root: str = ROOT):
    """The ``read(run)`` of metric ``name``: ``benchmark/metrics/<name>.py``."""
    return load_module(metric_path(name, root), f"benchmark.metrics.{name.replace('.', '__')}").read


def flow_class(name: str, root: str = ROOT):
    """The ``FLOW`` class of flow ``name``: ``benchmark/flows/<name>.py``."""
    return load_module(flow_path(name, root), f"benchmark.flows.{name}").FLOW


def arrival_drive(name: str, root: str = ROOT):
    """The ``drive`` of arrival ``name``: ``benchmark/arrivals/<name>.py``."""
    return load_module(arrival_path(name, root), f"benchmark.arrivals.{name}").drive


def forbidden_loaded(modules=None) -> list[str]:
    """Top-level names in ``sys.modules`` that are JAX's or the JAX
    package's, compared whole (``expecto_tpu_torch`` is not
    ``expecto_tpu``)."""
    modules = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in modules}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def process_start_time() -> float:
    """The wall-clock time this process started (Linux ``/proc``), or now."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


@dataclass
class Run:
    """What a metric reader reads."""

    flow: str
    cfg: dict
    traffic: dict
    peaks: dict
    work: object  # flops.Work of one call
    calls: int
    window_s: float
    units: int
    setup_s: float = 0.0
    window: dict = field(default_factory=dict)  # what the arrival's drive() returned
    trace: object = None  # trace.TraceSummary of the profiled stretch
    trace_calls: int = 0
    host: list = field(default_factory=list)  # per call: (wall s, seconds inside the runner)

    @property
    def peak_flops(self) -> float:
        return float(self.peaks["flops"][self.cfg["peak"]])

    @property
    def peak_bytes(self) -> float:
        return float(self.peaks["hbm_bytes_per_s"])


POOL_MARGIN = 4  # inputs made for calls this many times faster than the warm call


def pool_calls(seconds: float, warm_s: float) -> int:
    """Calls to make inputs for in set-up: a window of ``seconds`` at
    ``POOL_MARGIN`` times the warm call's pace, and one more."""
    return int(math.ceil(seconds * POOL_MARGIN / max(warm_s, 1e-3))) + 1


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, root: str = ROOT, device=None, cfg_override=None,
             traffic_override=None, started: float | None = None, patch=None, cache_dir=None, controls=(),
             log=sys.stderr) -> dict:
    """One run of cell ``name``; returns the result record. ``device``
    defaults to the first CUDA device; ``cfg_override`` and
    ``traffic_override`` update the files' values (the CPU tests' narrow
    sizes); ``patch(flow)`` may change the flow after its set-up (the tests'
    planted faults); ``cache_dir`` holds the inputs that do not change
    from run to run (default ``build/benchmark`` in the checkout);
    ``controls`` names checks of the control put in the program's place,
    whose readings go under ``"controls"`` (calibration only)."""
    import torch

    from . import flops as flops_mod
    from . import trace as trace_mod

    started = process_start_time() if started is None else started
    manifest = load_manifest(root)
    cell = find_cell(manifest, name, root)
    cfg = {**cell.cfg, **(cfg_override or {})}
    traffic = {**cell.traffic, **(traffic_override or {})}
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    workdir = tempfile.mkdtemp(prefix="expecto-bench-")
    cache_dir = cache_dir or os.path.join(root, "build", "benchmark")
    try:
        if device.type == "cuda":
            from expecto_tpu_torch.ops import cuda_build

            cuda_build.build()
        fl = flow_class(traffic["flow"], root)(cfg, traffic, seed, device, workdir, cache_dir)
        fl.mark("imports and kernel libraries")
        trace_calls = int(traffic["trace_calls"]) if trace else 0
        fl.setup()
        fl.prepare(pool_calls(seconds, fl.warm_s) + trace_calls)
        if patch is not None:
            patch(fl)
        host = []
        call = _host_timed_call(fl, host) if trace else fl.call
        setup_s = time.time() - started
        steps = [(n, t - started) for n, t in fl.marks]
        print(f"bench: {name} seed {seed}: set-up {setup_s:.3f} s ("
              + ", ".join(f"{n} by {t:.2f} s" for n, t in steps) + f"; warm call {fl.warm_s:.3f} s)",
              file=log, flush=True)

        window = arrival_drive(traffic["arrival"], root)(call, seconds, traffic)
        calls = int(window["calls"])
        summary = None
        if trace:
            with _named_program_functions(fl), trace_mod.profiled() as holder:
                for j in range(trace_calls):
                    with torch.profiler.record_function(trace_mod.SPAN_PREFIX + "call"):
                        call(calls + j)
            summary = holder.summary
        memory_peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
        units = calls * fl.units_per_call
        ends = window.get("ends", [])
        print(f"bench: {name}: {calls} calls, {units} {traffic['unit']} in {window['window_s']:.3f} s; call walls "
              + " ".join(f"{b - a:.3f}" for a, b in zip([0.0] + ends, ends)), file=log, flush=True)
        fl.free()

        run = Run(flow=traffic["flow"], cfg=cfg, traffic=traffic, peaks=flops_mod.peaks(), work=fl.work_per_call(),
                  calls=calls, window_s=float(window["window_s"]), units=units, setup_s=setup_s, window=window,
                  trace=summary, trace_calls=trace_calls, host=host[:calls])
        metrics = {}
        for m in (cell.per_layer if trace else cell.end_to_end):
            value = load_reader(m["name"], root)(run)
            if value is None and not trace:
                raise RuntimeError(f"the end-to-end metric {m['name']} read nothing")
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

        t_check = time.perf_counter()
        numbers = fl.check()
        print(f"bench: {name}: the check took {time.perf_counter() - t_check:.3f} s", file=log, flush=True)
        limits = cfg["limits"][traffic["flow"]]
        checks = {k: {"value": numbers.get(k, float("nan")), "limit": float(limits[k])} for k in sorted(limits)}
        correct = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
        result = {
            "correct": bool(correct),
            "attempted": int(units),
            "failed": int(fl.failed_units(limits)),
            "metrics": metrics,
            "device": _device(device, memory_peak, summary),
        }
        if summary is not None:
            result["breakdown"] = {
                "device_ops": [[k, v] for k, v in sorted(summary.kernel_s.items(), key=lambda kv: -kv[1])[:10]],
                "idle_gaps": [[n, s] for s, n in summary.gaps],
            }
        if controls:
            result["controls"] = {c: fl.check(control=c) for c in controls}
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _device(device, memory_peak: int, summary) -> dict:
    import torch

    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = memory_peak
    if summary is not None:
        info["busy_s"] = summary.busy_s
        info["window_s"] = summary.window_s
    return info


def _host_timed_call(fl, host: list):
    """``fl.call`` timed on the host, with the seconds spent inside the
    runner's public methods (``fl.runner_methods``) recorded beside each
    call's wall: the traced run's host spans."""
    import torch

    from . import trace as trace_mod
    from .flows import timed

    inside: list = []
    obj, names = fl.runner_methods()
    for n in names:
        fn = getattr(obj, n)
        setattr(obj, n, timed(_spanned(fn, trace_mod.SPAN_PREFIX + "runner." + n, torch), inside))

    def call(i):
        inside.clear()
        t0 = time.perf_counter()
        fl.call(i)
        host.append((time.perf_counter() - t0, sum(inside)))

    return call


def _spanned(fn, span: str, torch):
    def wrapped(*a, **k):
        with torch.profiler.record_function(span):
            return fn(*a, **k)

    return wrapped


class _named_program_functions:
    """For the profiled stretch: each of ``fl.program_functions()`` inside a
    ``bench.<module>.<function>`` span, so idle gaps can be named."""

    def __init__(self, fl):
        self.targets = fl.program_functions()
        self.saved = []

    def __enter__(self):
        import torch

        from . import trace as trace_mod

        for mod, names in self.targets:
            for n in names:
                fn = getattr(mod, n)
                self.saved.append((mod, n, fn))
                setattr(mod, n, _spanned(fn, f"{trace_mod.SPAN_PREFIX}{mod.__name__.rsplit('.', 1)[-1]}.{n}", torch))
        return self

    def __exit__(self, *exc):
        for mod, n, fn in reversed(self.saved):
            setattr(mod, n, fn)
        return False


def print_result(result: dict, out=sys.stdout, err=sys.stderr) -> None:
    """The checks as the last lines of standard error, the result as the
    last line of standard output."""
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)
