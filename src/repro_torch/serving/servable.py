"""DiffusionServable: how one diffusion micro-batch computes.

Counterpart of ``repro.serving.servable.DiffusionServable``: request seeds
become initial latents and class ids (``batch_inputs``), a ``SamplerKey``
becomes a built sampler (``build_fn``), a batch runs (``execute``) and is
scored against the cached error-free reference of the same latents
(``finalize``). The autoregressive servable and streaming wait for later
slices.

Initial latents come from the port's own generator, one
``torch.Generator`` per request seed; tests that compare with the
reference hand the reference's latents in by replacing ``batch_inputs``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import torch

from repro_torch import configs
from repro_torch.core import dvfs as dvfs_lib
from repro_torch.core import fault, metrics
from repro_torch.core.exec_ctx import DriftSystemConfig
from repro_torch.core.rollback import RollbackConfig
from repro_torch.diffusion import sampler as sampler_lib
from repro_torch.serving.cache import SamplerKey

# Stream tag mixed into a request seed for its initial latents (the
# reference folds 7 into the seed's key).
LATENT_TAG = 7


@dataclasses.dataclass
class BatchOutcome:
    """What ``finalize`` hands back to the engine."""
    corrected: int
    n_model_evals: int
    per_slot: List[dict]


class DiffusionServable:
    """The DRIFT denoising path for one engine."""

    paradigm = "diffusion"

    def __init__(self, engine):
        self.eng = engine

    def batch_inputs(self, model_cfg, seeds: List[int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(latents (B, H, W, C) f32, class ids (B,)) on the engine device."""
        dev = self.eng.device
        shape = (model_cfg.latent_size, model_cfg.latent_size,
                 model_cfg.latent_channels)
        lats = []
        for s in seeds:
            g = torch.Generator(device=dev)
            g.manual_seed(fault.mix64(int(s), LATENT_TAG))
            lats.append(torch.randn(shape, generator=g, device=dev))
        cond = torch.tensor([s % max(model_cfg.num_classes, 1)
                             for s in seeds], dtype=torch.int64, device=dev)
        return torch.stack(lats), cond

    def build_fn(self, key: SamplerKey) -> Callable:
        eng = self.eng
        model_cfg = configs.get_config(key.arch, smoke=key.smoke)
        if key.mode == "clean" or not key.op:
            schedule = None
        else:
            schedule = dvfs_lib.fine_grained_schedule(
                key.steps, dvfs_lib.OP_BY_NAME[key.op],
                nominal_steps=eng.nominal_steps)
        scfg = sampler_lib.SamplerConfig(
            num_sample_steps=key.steps,
            drift=DriftSystemConfig(
                mode=key.mode,
                rollback=RollbackConfig(interval=key.rollback_interval)),
            schedule=schedule,
            monitor_target_ber=eng.monitor_target_ber)
        return eng._sampler_factory(key, model_cfg, scfg)

    def _clean_reference(self, key: SamplerKey, seeds: Tuple[int, ...],
                         params, latents, cond) -> torch.Tensor:
        """Error-free reference latents for this batch, cached by
        (configuration, latent seeds) in the engine's bounded LRU."""
        eng = self.eng
        ckey = dataclasses.replace(key, mode="clean", op="")
        sample_id = (ckey, seeds)
        cached = eng._clean_samples.get(sample_id)
        if cached is not None:
            eng._clean_samples.move_to_end(sample_id)
            eng.stats.clean_sample_hits += 1
            return cached
        fn = eng.cache.get(ckey, self.build_fn)
        # BER 0 everywhere: the flip source is never asked for a mask.
        out = fn(params, None, latents, cond,
                 dvfs_lib.ber_monitor_init(eng.device))
        clean = torch.clamp(out.latents, -1, 1)
        eng._clean_samples[sample_id] = clean
        while len(eng._clean_samples) > eng._clean_cache_size:
            eng._clean_samples.popitem(last=False)
        eng.stats.clean_samples_computed += 1
        return clean

    def execute(self, mb, ctx):
        fn = self.eng.cache.get(mb.key, self.build_fn)
        latents, cond = ctx.inputs
        return fn(ctx.params, ctx.flip_source, latents, cond,
                  self.eng.monitor)

    def finalize(self, mb, ctx, out) -> BatchOutcome:
        key = mb.key
        latents, cond = ctx.inputs
        img = torch.clamp(out.latents, -1, 1)
        if key.mode == "clean":
            clean = img       # the run IS the reference
        else:
            clean = self._clean_reference(key, ctx.padded_seeds, ctx.params,
                                          latents, cond)
        per_slot = []
        for slot in range(len(mb.requests)):
            a, b = img[slot:slot + 1], clean[slot:slot + 1]
            per_slot.append(dict(
                lpips_vs_clean=float(metrics.lpips_proxy(a, b)),
                psnr_vs_clean_db=float(metrics.psnr(a, b)),
                latents=a[0]))
        return BatchOutcome(corrected=int(out.total_corrected),
                            n_model_evals=int(out.n_model_evals),
                            per_slot=per_slot)
