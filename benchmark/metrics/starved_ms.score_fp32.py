"""Ms a call of the score flow's ``sed.score`` span with no ``runner.in_flight`` chunk, fp32 cell, read from the program's spans. Layer: runner and device."""

from ._program import starved_ms


def read(run):
    return starved_ms(run, "score", "sed.score")
