"""Profiling and structured logging (port of expecto_tpu/utils/profiling.py):

- ``trace(log_dir)``: a context manager that records the enclosed block with
  ``torch.profiler`` (host activity, and the card's kernels and copies when
  CUDA is available) and writes a Chrome trace, ``trace_<pid>_<ns>.json``,
  under ``log_dir`` (open it in Perfetto or chrome://tracing);
- ``StageLogger``: wall-clock and item-throughput counters per pipeline
  stage, one JSON line a stage.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch profiler trace of the enclosed block into ``log_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StageLogger:
    """Per-stage throughput counters with JSON-line output."""

    def __init__(self, stream=None, run_id: str | None = None):
        self.stream = stream or sys.stderr
        self.run_id = run_id

    @contextlib.contextmanager
    def stage(self, name: str, n_items: int | None = None, unit: str = "items"):
        t0 = time.perf_counter()
        record: dict = {"stage": name}
        try:
            yield record
        finally:
            dt = time.perf_counter() - t0
            record["seconds"] = round(dt, 4)
            if n_items is not None:
                record["n"] = n_items
                record["per_sec"] = round(n_items / dt, 2) if dt > 0 else None
                record["unit"] = unit
            if self.run_id:
                record["run_id"] = self.run_id
            print(json.dumps(record), file=self.stream, flush=True)
