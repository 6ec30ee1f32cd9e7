"""Model code: the DiT and its attention."""
