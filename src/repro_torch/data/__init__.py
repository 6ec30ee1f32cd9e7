"""Synthetic data pipelines (counterpart of ``repro.data``)."""
