"""Seconds from process start to the first timed call: imports, kernel
libraries (built on a checkout's first run), inputs, weights, one warm call
and the inputs of the window's calls. End to end."""


def read(run):
    return run.setup_s
