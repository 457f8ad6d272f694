"""Set-up seconds: process start to the window's start (host clock):
imports, the graph and data made on the card, the host copy the
program's graph takes, the sampler's calibration, the warm-up calls and
their captures, and the nvcc build on a checkout's first run."""


def read(rec, name):
    return rec["setup_s"]
