"""Percent of the profiled stretch with nothing on the card in the score flow, fp32 cell. Layer: runner and device."""

from ._common import idle_pct


def read(run):
    return idle_pct(run, "score")
