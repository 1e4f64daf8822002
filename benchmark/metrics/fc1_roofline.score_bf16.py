"""Percent of the fc1 stage's roofline (the strided fc1 kernels) in the score flow, bf16 cell. Layer: kernels."""

from ._common import roofline


def read(run):
    return roofline(run, "score", "fc1")
