"""Analytical performance and energy model of the paper's accelerator.

Counterpart of ``repro.perfmodel``, copied as plain Python float
arithmetic with every expression's association unchanged, so the port
bills the same joules and virtual seconds as the reference, bit for bit.
Its numbers describe the modeled accelerator (64 systolic arrays of 32x32
int8 MACs at 2 GHz), never the GPU the port runs on.
"""
