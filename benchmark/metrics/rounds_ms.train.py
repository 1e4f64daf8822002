"""Device ms a call of the train flow's ``gblinear.rounds`` span: the 100 rounds of the sweep. Layer: model step."""

from ._program import device_ms


def read(run):
    return device_ms(run, "train", "gblinear.train", "gblinear.rounds")
