"""Percent of the conv stage's roofline (conv0-conv5 kernels) in the genes flow. Layer: kernels."""

from ._common import roofline


def read(run):
    return roofline(run, "genes", "conv")
