"""Requested images completed over the whole window (host clock)."""


def read(run):
    return run.images / run.window_s
