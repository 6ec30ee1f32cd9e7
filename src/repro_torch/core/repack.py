"""Tile-contiguous data-layout repacking (Sec 5.4, Fig 10b).

Counterpart of ``repro.core.repack``. Conventional row-major layouts
scatter a (tm x tn) tile across tm different DRAM rows; tile-wise recovery
then pays tm row activations per corrected tile. Repacking stores each
tile as a contiguous 1-D run so a tile recovery touches
ceil(tile_bytes / dram_row_bytes) rows instead.

Plain ``reshape``/``permute`` moves, any dtype, on any device; the
reference has no Pallas kernel here. ``repack`` always returns a new
tensor, never a view of its input (the offload store relies on it to
snapshot a buffer the next step overwrites). The row-activation
*accounting* lives in ``perfmodel/dram.py``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def pad_to_tiles(x: torch.Tensor, tm: int, tn: int) -> torch.Tensor:
    """``x`` zero-padded to whole tiles; ``x`` itself when aligned (a
    full-width checkpoint leaf, which would otherwise be copied once
    more)."""
    m, n = x.shape
    if m % tm == 0 and n % tn == 0:
        return x
    return F.pad(x, (0, (-n) % tn, 0, (-m) % tm))


def repack(x: torch.Tensor, tm: int, tn: int) -> torch.Tensor:
    """(M, N) row-major -> (Mt, Nt, tm*tn) tile-contiguous, in a new
    tensor."""
    xp = pad_to_tiles(x, tm, tn)
    mp, np_ = xp.shape
    mt, nt = mp // tm, np_ // tn
    out = torch.empty((mt, nt, tm * tn), dtype=x.dtype, device=x.device)
    out.view(mt, nt, tm, tn).copy_(
        xp.reshape(mt, tm, nt, tn).permute(0, 2, 1, 3))
    return out


def unpack(xt: torch.Tensor, shape: Tuple[int, int], tm: int, tn: int
           ) -> torch.Tensor:
    """Inverse of ``repack`` (crops padding)."""
    mt, nt, _ = xt.shape
    x = xt.reshape(mt, nt, tm, tn).permute(0, 2, 1, 3).reshape(mt * tm,
                                                               nt * tn)
    return x[: shape[0], : shape[1]]


def gather_tiles(xt: torch.Tensor, tile_flag: torch.Tensor) -> torch.Tensor:
    """Select flagged tiles from a repacked tensor (recovery read set).

    Returns (n_tiles_padded, tm*tn) with unflagged rows zeroed -- the
    fixed-shape analogue of the recovery scheduler's coalesced read list.
    """
    flags = tile_flag.reshape(-1)
    flat = xt.reshape(flags.shape[0], -1)
    return torch.where(flags[:, None], flat, torch.zeros_like(flat))
