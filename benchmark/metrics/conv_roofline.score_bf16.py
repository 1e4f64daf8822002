"""Percent of the conv stage's roofline (conv0-conv5 kernels) in the score flow, bf16 cell. Layer: kernels."""

from ._common import roofline


def read(run):
    return roofline(run, "score", "conv")
