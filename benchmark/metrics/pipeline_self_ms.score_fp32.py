"""Host ms a call of the score flow's ``sed.score`` span outside the runner's method spans, fp32 cell, read from the program's spans (the inside counterpart of ``pipeline_host_ms.score_fp32``). Layer: pipeline host."""

from ._program import self_ms


def read(run):
    return self_ms(run, "score", "sed.score")
