"""Wall-clock stage timer (port of expecto_tpu/utils/timing.py).

A CUDA call returns before the card has finished, so a stage that ends in
device work passes ``sync=torch.cuda.synchronize`` (or a callable that
fetches the stage's result) to stop the clock when the work is done.
"""

from __future__ import annotations

import time
from contextlib import contextmanager


class Timer:
    def __init__(self):
        self.stages: dict[str, float] = {}

    @contextmanager
    def stage(self, name: str, sync=None):
        """Time a stage; ``sync`` is an optional callable run before stopping
        the clock (on the card: ``torch.cuda.synchronize``)."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            sync()
        self.stages[name] = self.stages.get(name, 0.0) + (time.perf_counter() - t0)

    def report(self) -> str:
        return " | ".join(f"{k}: {v:.3f}s" for k, v in self.stages.items())
