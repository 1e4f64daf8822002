"""Percent of the block stage's roofline (the gblinear gradient and residual kernels) in the train flow. Layer: kernels."""

from ._common import roofline


def read(run):
    return roofline(run, "train", "block")
