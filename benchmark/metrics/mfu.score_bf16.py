"""The model's least operations in the window over window x peak, percent, in the score flow, bf16 cell. Layer: model step."""

from ._common import mfu


def read(run):
    return mfu(run, "score")
