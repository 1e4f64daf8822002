"""Host ms a call outside the runner's device methods in the score flow, fp32 cell. Layer: pipeline host (``pipeline/*.py``, ``genome/*``, ``io/xgb.py``)."""

from ._common import host_ms


def read(run):
    return host_ms(run, "score")
