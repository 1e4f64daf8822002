"""Variants scored (REF, ALT, SED of every model) over the window's seconds, fp32 cell. End to end."""

from ._common import rate


def read(run):
    return rate(run, "score")
