"""DVFS timing-error model: uniform random bit flips on GEMM outputs.

Counterpart of ``repro.core.fault``. Same law: each 32-bit INT32 output
word flips with probability ``1 - (1 - ber)^32``, at a bit position uniform
in [0, 32). Masks are int32 bit patterns (bit 31 is ``INT32_MIN``).

The reference keys every fault site through ``jax.random.fold_in``. The
port does not replay threefry: ``ExecContext`` asks a *flip source*
``(site, shape, ber) -> int32 mask`` for each GEMM's mask. The default
source (``PhiloxFlipSource``) seeds one ``torch.Generator`` per site from a
stable 64-bit mix of (base seed, batch index, step, scope, crc32(name)) and
draws the mask on the context's device; the tests plug in a source that
replays the reference's masks bit for bit.

``inject_f32`` applies a mask to the raw bits of f32 words (the
autoregressive path's un-quantized GEMM outputs) through the hand-written
injection kernel (``kernels.fault_inject``). ``inject_at`` flips one
chosen bit of one chosen word, as the reference's tests pin detection
one bit at a time.

The Sec 4 sweep options ride each draw as keywords, as in the reference's
``_flip_words``: ``force_bit >= 0`` pins the flipped position and reads
``ber`` as the per-word rate; ``double_flip`` makes a second draw, at
``clip(15.5 * ber, 0, 1)``, on the words already flipped. ``ExecContext``
passes them to its flip source only when they are set, so a source that
takes ``(site, shape, ber)`` alone still serves the default options.
"""
from __future__ import annotations

import zlib
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.kernels.fault_inject import fault_inject


class FaultSite(NamedTuple):
    """Identity of one protected GEMM's fault draw."""
    step: int      # denoising or decode step index
    scope: int     # 1000 for the embedding context, else the layer index
    name: str      # GEMM name ("attn.q", "mlp.w1", "patch", ...)


# (site, shape, ber[, double_flip=..., force_bit=...]) -> int32 mask
FlipSource = Callable[..., torch.Tensor]


def site_id(name: str) -> int:
    """crc32 of a GEMM name, as ``repro.core.exec_ctx._site_id``."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


def word_flip_prob(ber: float, bits: int = 32) -> float:
    """P(at least one of ``bits`` bits flips) at per-bit ``ber``, in f32."""
    b = torch.tensor(ber, dtype=torch.float32).clamp(0.0, 0.5)
    return float(-torch.expm1(bits * torch.log1p(-b)))


def draw_flips(shape: Sequence[int], ber: float, generator: torch.Generator,
               device, double_flip: bool = False,
               force_bit: int = -1) -> torch.Tensor:
    """One int32 flip mask of ``shape`` at ``ber``: a word flips when its
    uniform draw is below ``word_flip_prob(ber)``, at a uniform bit; with
    ``force_bit >= 0`` when it is below ``ber`` itself, at that bit; with
    ``double_flip`` a flipped word flips a second uniform bit with
    probability ``clip(15.5 * ber, 0, 1)`` (the same bit twice cancels,
    as in the reference)."""
    shape = tuple(shape)
    # 1 << 31 wraps to INT32_MIN, the bit-31 pattern.
    one = torch.ones((), dtype=torch.int32, device=device)
    u = torch.rand(shape, generator=generator, device=device)
    if force_bit >= 0:
        bit = torch.bitwise_left_shift(one, int(force_bit))
        return torch.where(u < float(np.float32(ber)), bit, 0)
    flip = u < word_flip_prob(ber)
    pos = torch.randint(0, 32, shape, generator=generator, device=device,
                        dtype=torch.int32)
    mask = torch.where(flip, torch.bitwise_left_shift(one, pos), 0)
    if double_flip:
        p2 = float(np.clip(np.float32(15.5) * np.float32(ber), 0.0, 1.0))
        u2 = torch.rand(shape, generator=generator, device=device)
        pos2 = torch.randint(0, 32, shape, generator=generator,
                             device=device, dtype=torch.int32)
        mask ^= torch.where(flip & (u2 < p2),
                            torch.bitwise_left_shift(one, pos2), 0)
    return mask


def expected_flips(shape: Sequence[int], ber: float, bits: int = 32) -> float:
    """E[#flipped bits] in a tensor of ``shape`` at per-bit ``ber``."""
    n = 1
    for d in shape:
        n *= d
    return float(n) * bits * ber


def inject_f32(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Bit flips on raw float32 words: ``x`` viewed as int32, xor ``mask``
    (int32 bit patterns, e.g. a flip source's mask for a ``FaultSite``),
    viewed back as float32."""
    if x.dtype != torch.float32:
        raise TypeError(f"inject_f32 takes float32 words, got {x.dtype}")
    return fault_inject(x, mask)


def inject_at(acc: torch.Tensor, flat_index: int, bit: int) -> torch.Tensor:
    """One deterministic flip (the Sec 4 probes): bit ``bit`` (0 the LSB,
    31 the sign: a delta of -2^31 on an int32) of element ``flat_index``
    of the flattened 32-bit tensor ``acc`` (int32 or float32), xored
    through an int32 view. Returns a new tensor on ``acc``'s device; no
    value is read back to the host. As the reference's ``.at[].set``
    and shift: a ``flat_index`` in [-numel, 0) counts from the end, one
    outside [-numel, numel) flips nothing, a ``bit`` in [32, 2^32) flips
    nothing, and a ``bit`` outside [0, 2^32) raises ``OverflowError``."""
    if acc.element_size() != 4:
        raise ValueError(f"inject_at flips 32-bit words, got {acc.dtype}")
    flat_index, bit = int(flat_index), int(bit)
    if not 0 <= bit < 2 ** 32:
        raise OverflowError(f"bit {bit} out of bounds for uint32")
    words = acc.reshape(-1).view(torch.int32).clone()
    n = words.numel()
    if -n <= flat_index < n and bit < 32:
        # the bit-31 pattern is INT32_MIN as an int32
        words[flat_index] ^= -2 ** 31 if bit == 31 else 1 << bit
    return words.view(acc.dtype).reshape(acc.shape)


def mix64(*fields: int) -> int:
    """splitmix64 over the fields: a stable 64-bit seed (unlike ``hash``)."""
    mask = (1 << 64) - 1
    h = 0x9E3779B97F4A7C15
    for f in fields:
        h = (h ^ (f & mask)) & mask
        h = (h + 0x9E3779B97F4A7C15) & mask
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & mask
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & mask
        h ^= h >> 31
    return h & ((1 << 63) - 1)


class PhiloxFlipSource:
    """Default flip source: one seeded ``torch.Generator`` per fault site.

    A given (base seed, batch index, site) always gives the same mask, on
    the CPU and on the card alike (each draws from its own generator, so the
    two devices give different masks from one seed). At BER 0 it returns
    zeros without drawing.
    """

    def __init__(self, base_seed: int, batch_index: int, device):
        self.base_seed = int(base_seed)
        self.batch_index = int(batch_index)
        self.device = torch.device(device)

    def seed_for(self, site: FaultSite) -> int:
        return mix64(self.base_seed, self.batch_index, site.step, site.scope,
                      site_id(site.name))

    def __call__(self, site: FaultSite, shape: Sequence[int], ber: float,
                 double_flip: bool = False,
                 force_bit: int = -1) -> torch.Tensor:
        if not ber > 0.0:
            return torch.zeros(tuple(shape), dtype=torch.int32,
                               device=self.device)
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed_for(site))
        return draw_flips(shape, ber, g, self.device, double_flip,
                          force_bit)


def philox_source_factory(base_seed: int, device):
    """The engine's default ``flip_source_factory(batch_index)``."""
    return lambda batch_index: PhiloxFlipSource(base_seed, batch_index,
                                                device)

