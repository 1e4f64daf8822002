"""Device ms a call of the train flow's ``gblinear.upload`` span: X to the card and into its block layout. Layer: runner and device."""

from ._program import device_ms


def read(run):
    return device_ms(run, "train", "gblinear.train", "gblinear.upload")
