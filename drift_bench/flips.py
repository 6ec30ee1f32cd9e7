"""The benchmark's flip source: a pool of int32 flip masks drawn at set-up.

On a real accelerator the flips come from undervolting, not from
software, so the fault model belongs to the yardstick. The law is the one
of the port's fault model: each 32-bit word of a GEMM's int32 output
flips with probability ``1 - (1 - ber)^32``, at a bit uniform in [0, 32).

The pool holds ``size`` masks for each output shape the cell's faulted
GEMMs ask for, drawn on the device from the run seed the first time a
shape is asked for (during set-up's warm batch). ``freeze`` ends the
drawing: a shape first asked for later raises, so no mask is drawn inside
the measured window. A fault site (batch, step, scope, GEMM name) picks
its pool entry by a crc32 of those fields: drawing costs no kernel, and
masks repeat across sites, a departure from the law's independence.

``factory(batch_index)`` is what the engine's ``flip_source_factory``
takes; the reference calls the same source with the same sites.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from drift_bench.seeds import POOL_TAG, mix64

POOL_SIZE = 8


class Site(NamedTuple):
    """A fault site, as the port's ``FaultSite`` names one."""
    step: int
    scope: int
    name: str


def word_flip_prob(ber: float) -> float:
    """P(a 32-bit word has a flipped bit) at per-bit ``ber``."""
    return 1.0 - (1.0 - float(ber)) ** 32


def draw(shape: Sequence[int], ber: float, generator: torch.Generator,
         device) -> torch.Tensor:
    """One int32 mask of ``shape`` by the law."""
    shape = tuple(shape)
    u = torch.rand(shape, generator=generator, device=device)
    pos = torch.randint(0, 32, shape, generator=generator, device=device,
                        dtype=torch.int32)
    one = torch.ones((), dtype=torch.int32, device=device)
    # 1 << 31 wraps to INT32_MIN, the bit-31 pattern
    return torch.where(u < word_flip_prob(ber),
                       torch.bitwise_left_shift(one, pos),
                       torch.zeros((), dtype=torch.int32, device=device))


class FlipPool:
    """Masks at one BER, ``size`` per shape, from ``seed``."""

    def __init__(self, seed: int, ber: float, device, size: int = POOL_SIZE):
        self.ber = float(ber)
        self.device = torch.device(device)
        self.size = int(size)
        self.masks: Dict[Tuple[int, ...], List[torch.Tensor]] = {}
        self.frozen = False
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(mix64(seed, POOL_TAG))

    @property
    def nbytes(self) -> int:
        return sum(m.numel() * m.element_size()
                   for ms in self.masks.values() for m in ms)

    def freeze(self) -> None:
        self.frozen = True

    def mask(self, batch_index: int, site, shape: Sequence[int],
             ber: float) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        if abs(float(ber) - self.ber) > 1e-3 * self.ber:
            raise ValueError(f"site {tuple(site)} asks for BER {ber}, the "
                             f"pool holds BER {self.ber}")
        pool = self.masks.get(shape)
        if pool is None:
            if self.frozen:
                raise ValueError(f"site {tuple(site)} asks for a mask of "
                                 f"shape {shape} after set-up")
            pool = self.masks[shape] = [
                draw(shape, self.ber, self._gen, self.device)
                for _ in range(self.size)]
        key = f"{batch_index}/{site.step}/{site.scope}/{site.name}"
        return pool[zlib.crc32(key.encode()) % self.size]

    def factory(self, batch_index: int):
        """The flip source of one batch: ``(site, shape, ber) -> mask``."""
        def source(site, shape, ber, double_flip=False, force_bit=-1):
            if double_flip or force_bit >= 0:
                raise ValueError("the pool draws single uniform flips only")
            if not ber > 0.0:
                return torch.zeros(tuple(shape), dtype=torch.int32,
                                   device=self.device)
            return self.mask(batch_index, site, shape, ber)
        return source
