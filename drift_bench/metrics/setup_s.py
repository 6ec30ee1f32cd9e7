"""Seconds from the process's start to the window's: imports, CUDA
initialisation, weights, the flip pool, kernel builds and the warm batch."""


def read(run):
    return run.setup_s
