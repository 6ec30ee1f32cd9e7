"""Tile-contiguous host layouts for offloaded checkpoint snapshots.

Counterpart of ``repro.serving.offload.layout``. The offload store
(``store.py``) does not ship checkpoint tensors to the host row-major: it
routes every leaf through the Sec 5.4 tile-contiguous transform
(``core.repack``) first, so a *partial* tile restore is charged the
repacked DRAM row count from ``perfmodel.dram``, not one row activation
per matrix row.

Leaves are arbitrary-rank (the DiT block store stacks leaves ``(L, rows,
N)``), so a leaf is first flattened to 2-D ``(prod(leading), last_dim)``,
then tiled. The pack/unpack pair is exact (pad -> reshape -> permute ->
crop), which keeps a restore bit-identical to the live store.

A snapshot is taken in two moves: ``stage_leaf`` makes the device copy in
host layout (the repack; a plain clone for the row-major ablation), and
``host_leaf`` copies that staging tensor into host memory, pinned when it
comes from a CUDA device. ``pack_leaf`` does both synchronously; the store
runs them on two CUDA streams. A store tree is the port's
``(embed_store, block_store)`` pair of dicts, or any nesting of dicts,
tuples and lists over tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import repack as repack_lib
from repro_torch.perfmodel import dram as dram_lib
from repro_torch.perfmodel.hw import PAPER_ACCEL
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class PackedLeaf:
    """One checkpoint tensor in its host-side tile-contiguous form.

    ``data`` is host memory: ``(Mt, Nt, tm*tn)`` when packed, the raw
    leaf when it was too small to tile (ndim < 2) or the layout is
    row-major. ``device`` is where a restore re-uploads it."""
    data: torch.Tensor
    shape: Tuple[int, ...]            # original (unflattened) leaf shape
    dtype: torch.dtype
    tm: int
    tn: int
    packed: bool
    device: str = "cpu"

    @property
    def nbytes(self) -> int:
        """Host bytes actually offloaded (tile padding included)."""
        return self.data.numel() * self.data.element_size()


def _flat2d(shape: Tuple[int, ...]) -> Tuple[int, int]:
    lead = math.prod(shape[:-1]) if len(shape) > 1 else 1
    return lead, int(shape[-1])


def _packs(arr: torch.Tensor, repacked: bool) -> bool:
    return repacked and arr.ndim >= 2


def stage_leaf(arr: torch.Tensor, tm: int, tn: int,
               repacked: bool = True) -> torch.Tensor:
    """A new device tensor holding ``arr`` in its host layout, made on the
    current stream: the repack, or a clone when the leaf is not tiled."""
    if not _packs(arr, repacked):
        return arr.clone()
    return repack_lib.repack(arr.reshape(_flat2d(tuple(arr.shape))), tm, tn)


def host_leaf(arr: torch.Tensor, staged: torch.Tensor, tm: int, tn: int,
              repacked: bool = True, host: Optional[torch.Tensor] = None,
              non_blocking: bool = False) -> PackedLeaf:
    """Copy ``staged`` (``stage_leaf(arr, ...)``) into ``host``, or into new
    host memory (pinned when ``staged`` is on a CUDA device)."""
    if host is None:
        host = torch.empty(staged.shape, dtype=staged.dtype,
                           pin_memory=staged.is_cuda)
    host.copy_(staged, non_blocking=non_blocking)
    return PackedLeaf(data=host, shape=tuple(arr.shape), dtype=arr.dtype,
                      tm=tm, tn=tn, packed=_packs(arr, repacked),
                      device=str(arr.device))


def pack_leaf(arr: torch.Tensor, tm: int, tn: int,
              repacked: bool = True) -> PackedLeaf:
    """Snapshot one device leaf to host in tile-contiguous layout,
    synchronously."""
    return host_leaf(arr, stage_leaf(arr, tm, tn, repacked), tm, tn,
                     repacked)


def unpack_leaf(leaf: PackedLeaf, device: bool = True) -> torch.Tensor:
    """Inverse of :func:`pack_leaf`: a new tensor holding the original
    leaf, on ``leaf.device`` (the restore path) or, with ``device=False``,
    in host memory."""
    src = leaf.data.to(leaf.device) if device else leaf.data
    if leaf.packed:
        src = repack_lib.unpack(src, _flat2d(leaf.shape), leaf.tm,
                                leaf.tn).reshape(leaf.shape)
    if (src.untyped_storage().data_ptr()
            == leaf.data.untyped_storage().data_ptr()):
        src = src.clone()             # never hand out the host buffer
    return src


def pack_store(stores, tm: int, tn: int, repacked: bool = True):
    """Pack a whole checkpoint-store tree (PackedLeaf per leaf)."""
    return tree_map(lambda a: pack_leaf(a, tm, tn, repacked), stores)


def unpack_store(packed):
    """Restore a packed tree back onto its device."""
    return tree_map(unpack_leaf, packed)


def store_nbytes(packed) -> int:
    """Total host bytes of one packed snapshot (the offload volume)."""
    return int(sum(leaf.nbytes for leaf in tree_leaves(packed)))


def recovery_rows(leaf_shape: Tuple[int, ...], tm: int, tn: int,
                  n_tiles: int = 1, repacked: bool = True,
                  elem_bytes: int = 4,
                  row_bytes: int = PAPER_ACCEL.dram_row_bytes) -> int:
    """DRAM row activations charged for restoring ``n_tiles`` tiles of a
    leaf -- the accounting bridge to ``perfmodel.dram``: a repacked layout
    pays ``rows_per_tile_repacked``, a row-major one
    ``rows_per_tile_rowmajor`` with the leaf's flattened column count."""
    _, n_cols = _flat2d(leaf_shape)
    if repacked:
        per_tile = dram_lib.rows_per_tile_repacked(tm, tn, elem_bytes,
                                                   row_bytes)
    else:
        per_tile = dram_lib.rows_per_tile_rowmajor(tm, tn, n_cols,
                                                   elem_bytes, row_bytes)
    return n_tiles * per_tile


def layout_report(stores, tm: int, tn: int) -> Dict[str, float]:
    """Whole-store layout accounting: total tiles, row activations for a
    full restore under both layouts, and the Fig 13(b)-style reduction."""
    tiles = rows_rp = rows_rm = 0
    for arr in tree_leaves(stores):
        shape = tuple(arr.shape)
        if len(shape) < 2:
            continue
        m, n = _flat2d(shape)
        n_tiles = math.ceil(m / tm) * math.ceil(n / tn)
        tiles += n_tiles
        rows_rp += recovery_rows(shape, tm, tn, n_tiles, repacked=True)
        rows_rm += recovery_rows(shape, tm, tn, n_tiles, repacked=False)
    return {"tiles": float(tiles),
            "rows_repacked": float(rows_rp),
            "rows_rowmajor": float(rows_rm),
            "reduction": rows_rm / max(rows_rp, 1.0)}
