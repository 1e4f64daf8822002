"""Closed loop, one client: each call starts when the last has ended, until
``seconds`` have passed; the window ends with the last call, so every call
in it is whole."""

from __future__ import annotations

import time


def drive(call, seconds: float, traffic: dict) -> dict:
    t0 = time.perf_counter()
    ends = []
    while not ends or ends[-1] < seconds:
        call(len(ends))
        ends.append(time.perf_counter() - t0)
    return {"calls": len(ends), "window_s": ends[-1], "ends": ends}
