"""Training checkpoints (counterpart of ``repro.checkpoint``)."""
