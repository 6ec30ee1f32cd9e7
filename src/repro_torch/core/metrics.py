"""Generation-quality metrics the serving engine scores requests with.

Counterpart of ``repro.core.metrics``' ``lpips_proxy`` (a fixed, seed-pinned
3-level random-conv pyramid; unit-normalised feature differences averaged
over scales) and ``psnr``. Images are (B, H, W, C) in [-1, 1], as in the
reference; the convolutions run NCHW with OIHW filters.

XLA's ``SAME`` padding at stride 2 is asymmetric: for an even input and a
3x3 kernel it pads 0 before and 1 after, which ``conv2d(padding=...)``
cannot express, hence the explicit ``F.pad``. cuDNN would run a float32
convolution in TF32 by default; the convolutions here turn that off.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_FEAT_SEED = 20260713


@functools.lru_cache(maxsize=None)
def _filters(in_ch: int, out_ch: int, level: int) -> np.ndarray:
    """HWIO filters, float64 as numpy computes them (the reference casts
    them to f32 when it converts them to an array)."""
    rng = np.random.RandomState(_FEAT_SEED + level)
    w = rng.randn(3, 3, in_ch, out_ch).astype(np.float32)
    return w / np.sqrt(9.0 * in_ch)


def _same_pad(size: int, k: int = 3, stride: int = 2):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: np.ndarray, stride: int = 2) -> torch.Tensor:
    """NCHW conv with HWIO filters ``w`` and XLA ``SAME`` padding."""
    wt = torch.from_numpy(np.ascontiguousarray(
        w.transpose(3, 2, 0, 1), dtype=np.float32)).to(x.device)
    ph, pw = _same_pad(x.shape[2], w.shape[0], stride), \
        _same_pad(x.shape[3], w.shape[1], stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return F.conv2d(x, wt, stride=stride)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _pyramid(img: torch.Tensor, channels=(16, 32, 64)):
    """img (B, H, W, C) -> list of NCHW feature maps."""
    feats = []
    x = img.float().permute(0, 3, 1, 2)
    in_ch = img.shape[-1]
    for lvl, out_ch in enumerate(channels):
        x = torch.tanh(_conv(x, _filters(in_ch, out_ch, lvl)))
        feats.append(x)
        in_ch = out_ch
    return feats


def lpips_proxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Perceptual distance between two (B, H, W, C) images in [-1, 1]."""
    fa, fb = _pyramid(a), _pyramid(b)
    total = 0.0
    for xa, xb in zip(fa, fb):
        na = xa / (torch.linalg.vector_norm(xa, dim=1, keepdim=True) + 1e-6)
        nb = xb / (torch.linalg.vector_norm(xb, dim=1, keepdim=True) + 1e-6)
        total = total + torch.mean(torch.sum((na - nb) ** 2, dim=1))
    return total / len(fa)


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0
         ) -> torch.Tensor:
    mse = torch.mean((a.float() - b.float()) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp_min(mse, 1e-12))
