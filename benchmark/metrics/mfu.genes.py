"""The model's least operations in the window over window x peak, percent, in the genes flow. Layer: model step."""

from ._common import mfu


def read(run):
    return mfu(run, "genes")
