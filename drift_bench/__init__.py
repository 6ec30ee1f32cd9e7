"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything here is
the yardstick: the traffic generator, the weights and the flip pool made
from the seed, the frozen counts of operations and bytes, the trace
reduction, the per-metric readers and the plain reference that decides
``correct``. Nothing here imports JAX or the JAX package ``repro``, and
nothing under ``reference/`` imports the port.
"""
