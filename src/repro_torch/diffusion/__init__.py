"""The DDPM/DDIM schedule and the DRIFT sampling loop."""
