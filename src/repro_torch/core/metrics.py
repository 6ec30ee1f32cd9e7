"""Generation-quality metrics the serving engine scores requests with.

Counterpart of ``repro.core.metrics``: ``lpips_proxy`` (a fixed, seed-pinned
3-level random-conv pyramid; unit-normalised feature differences averaged
over scales), ``clip_proxy`` (cosine of the pyramid's pooled last level and
a seeded random projection of the conditioning vector), ``psnr``, the
global-window ``ssim`` and ``fid_proxy`` (the Frechet distance of the pooled
last level's diagonal Gaussians of two batches). Images are (B, H, W, C) in
[-1, 1], as in the reference; the convolutions run NCHW with OIHW filters.
Each runs on its inputs' device.

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


def _pooled(img: torch.Tensor) -> torch.Tensor:
    """The pyramid's last level averaged over space: (B, C)."""
    return _pyramid(img)[-1].mean(dim=(2, 3))


def clip_proxy(img: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """Cosine(embedding(img), projection(cond)), averaged over the batch:
    the semantic-trend proxy. The projection is numpy's, in float64 as
    numpy divides it, then f32 as the reference's array holds it."""
    feats = _pooled(img)
    rng = np.random.RandomState(_FEAT_SEED + 99)
    proj = rng.randn(cond.shape[-1], feats.shape[-1]).astype(np.float32) \
        / np.sqrt(cond.shape[-1])
    ce = cond.float() @ torch.from_numpy(proj.astype(np.float32)).to(
        feats.device)
    num = torch.sum(feats * ce, dim=-1)
    den = (torch.linalg.vector_norm(feats, dim=-1)
           * torch.linalg.vector_norm(ce, dim=-1) + 1e-6)
    return torch.mean(num / den)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0
         ) -> torch.Tensor:
    """Global-window SSIM (one window over the whole batch)."""
    a, b = a.float(), b.float()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a, mu_b = torch.mean(a), torch.mean(b)
    va = torch.var(a, correction=0)
    vb = torch.var(b, correction=0)
    cov = torch.mean((a - mu_a) * (b - mu_b))
    return ((2 * mu_a * mu_b + c1) * (2 * cov + c2)
            / ((mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2)))


def fid_proxy(batch_a: torch.Tensor, batch_b: torch.Tensor) -> torch.Tensor:
    """Frechet distance between the random-feature Gaussians of two
    batches, with diagonal covariances (a full matrix square root is
    ill-conditioned at B < 64)."""
    fa, fb = _pooled(batch_a), _pooled(batch_b)
    mu_a, mu_b = fa.mean(0), fb.mean(0)
    va, vb = fa.var(0, correction=0), fb.var(0, correction=0)
    return (torch.sum((mu_a - mu_b) ** 2)
            + torch.sum(va + vb - 2.0 * torch.sqrt(
                torch.clamp_min(va * vb, 0.0))))
