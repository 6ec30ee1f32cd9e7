"""Algorithm-based fault tolerance (ABFT) for the INT8 GEMM.

Counterpart of ``repro.core.abft``: the config and the overflow-safe
threshold test. The per-tile checksums and the mask are computed by
``kernels.abft_matmul`` and ``kernels.rollback_correct``, whose plain
versions are the PyTorch reference. All checksum arithmetic wraps mod 2^32,
like int32 in XLA: ``wrap_i32`` reduces int64 explicitly, since signed
overflow is not something to lean on.
"""
from __future__ import annotations

import dataclasses

import torch


def _exceeds(diff: torch.Tensor, thr) -> torch.Tensor:
    """|diff| >= thr robust to int32 overflow: abs(INT32_MIN) wraps negative,
    so a bit-31 flip (delta = -2^31) would escape an abs()-based check."""
    return (diff >= thr) | (diff <= -thr)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Reduce an int64 tensor mod 2^32 into int32 two's complement."""
    return (torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class AbftConfig:
    threshold_bit: int = 10        # errors >= 2**threshold_bit are "large"
    tile_m: int = 32               # systolic-array tile (paper default 32)
    tile_n: int = 32
    # 'cross' = flagged rows x flagged cols within a tile (paper Fig 10a);
    # 'union' = whole flagged rows AND whole flagged cols of a tile.
    mask_policy: str = "union"

    @property
    def threshold(self) -> int:
        return 1 << self.threshold_bit
