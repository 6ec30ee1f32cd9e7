"""Resilience-heatmap helpers: timestep binning and site labels.

Counterpart of ``repro.serving.trace.heatmap``. ``summarize`` takes the
sampler's heatmap as a torch tensor (on the card or the CPU) or an
array and moves it to the host once per batch.

The sampler emits a per-step detection vector (``SampleOutput.heatmap``,
shape (steps, sites)); serving summarizes it into (sites, timestep-bin)
buckets -- the live-serving analogue of the paper's Figs 5-6, where the
early (protected) timesteps and the embedding/first-block sites are
exactly the cells DRIFT keeps at nominal voltage.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# Timestep bins in the exported heatmap. Four is enough to separate the
# protected head (nominal_steps live in bin 0 for typical step counts)
# from the resilient tail without exploding metric cardinality.
N_STEP_BINS = 4


def bin_heatmap(heat, n_bins: int = N_STEP_BINS) -> np.ndarray:
    """(steps, sites) detection counts -> (sites, bins) int64 buckets.

    Steps are partitioned into ``n_bins`` contiguous ranges (edges via
    linspace, so a non-divisible step count spreads the remainder); fewer
    steps than bins degrades to one bin per step.
    """
    if isinstance(heat, torch.Tensor):
        heat = heat.cpu().numpy()
    heat = np.asarray(heat)
    assert heat.ndim == 2, heat.shape
    steps, sites = heat.shape
    n_bins = max(1, min(n_bins, steps))
    edges = np.linspace(0, steps, n_bins + 1).astype(int)
    out = np.zeros((sites, n_bins), dtype=np.int64)
    for b in range(n_bins):
        out[:, b] = heat[edges[b]:edges[b + 1]].sum(axis=0)
    return out


def site_labels(n_sites: int) -> Tuple[str, ...]:
    """Row labels matching the sampler's detection-row layout
    (``sampler.detection_rows``): DiT-family rows are the embedding GEMMs
    followed by one row per block; single-row families (UNet's flat
    ExecContext, AR decode windows) get "all"."""
    if n_sites == 1:
        return ("all",)
    return ("embed",) + tuple(f"block{i}" for i in range(n_sites - 1))


def summarize(heat, n_bins: int = N_STEP_BINS
              ) -> Tuple[Optional[tuple], Optional[tuple]]:
    """(steps, sites) array -> (nested int tuple (sites, bins), labels);
    (None, None) for a sampler that produced no heatmap."""
    if heat is None:
        return None, None
    binned = bin_heatmap(heat, n_bins)
    rows = tuple(tuple(int(v) for v in row) for row in binned)
    return rows, site_labels(binned.shape[0])
