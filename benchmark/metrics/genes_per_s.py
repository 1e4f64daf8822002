"""Gene feature vectors computed over the window's seconds. End to end."""

from ._common import rate


def read(run):
    return rate(run, "genes")
