"""The plain reference that decides ``correct``: plain PyTorch, no import
of the port, of JAX or of the JAX package. ``REFERENCES`` maps a
configuration's ``reference`` key to its module."""
from drift_bench.reference import dit

REFERENCES = {"dit": dit}
