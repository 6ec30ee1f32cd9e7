"""Elastic scaling policies (counterpart of ``repro.distributed``, its
pure-Python part)."""
