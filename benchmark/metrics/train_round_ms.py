"""Window milliseconds over the boosting rounds it completed. End to end."""

from ._common import ms_per_unit


def read(run):
    return ms_per_unit(run, "train")
