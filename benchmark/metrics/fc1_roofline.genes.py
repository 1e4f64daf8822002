"""Percent of the fc1 stage's roofline (the strided fc1 kernels) in the genes flow. Layer: kernels."""

from ._common import roofline


def read(run):
    return roofline(run, "genes", "fc1")
