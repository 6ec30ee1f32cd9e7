"""Servables: how one micro-batch of a paradigm computes.

Counterpart of ``repro.serving.servable``. The engine owns the queue,
batcher, cache, monitor, virtual clock and perfmodel attribution; a
servable checks a request's mode and knobs for its paradigm
(``validate_request``), turns request seeds into model inputs
(``batch_inputs``), a ``SamplerKey`` into built callables (``build_fn``),
runs a batch (``execute``), and scores it against the cached error-free
reference of the same inputs and states its perfmodel ``RunConfig``
(``finalize``); ``execute_stream`` is the generator twin of ``execute``
(``PreviewEvent``s, then ``("final", output)``). Two ship, as in the
reference; ``SERVABLE_BY_FAMILY`` maps each ported family to one, and each
provides its family's params init (``init_params``):

* ``DiffusionServable`` -- the DRIFT denoising path (DiT), with
  TaylorSeer, the precision plans, streaming previews and, with the
  engine's offload store, checkpoint commits between windows.
* ``AutoregressiveServable`` -- token-by-token decode with statistical
  ABFT and KV-window rollback (``serving.ar``), with the flight
  recorder's window and replay taps.

``finalize`` also hands back the batch's resilience heatmap (the
sampler's per-step detections binned on the host, ``trace/heatmap.py``)
and the telemetry controller's word count.

Initial latents and prompts come from the port's own generator, one
``torch.Generator`` per request seed; tests that compare with the
reference hand the reference's inputs in by replacing ``batch_inputs``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import dvfs as dvfs_lib
from repro_torch.core import fault, metrics
from repro_torch.core import quant as quant_lib
from repro_torch.core.exec_ctx import PORTED_MODES, DriftSystemConfig
from repro_torch.core.rollback import RollbackConfig
from repro_torch.diffusion import sampler as sampler_lib
from repro_torch.diffusion.taylorseer import TaylorSeerConfig
from repro_torch.models import dit, transformer
from repro_torch.perfmodel import energy
from repro_torch.serving import ar
from repro_torch.serving.cache import SamplerKey
from repro_torch.serving.request import PreviewEvent
from repro_torch.serving.trace import heatmap as heatmap_lib

# Stream tag mixed into a request seed for its initial latents (the
# reference folds 7 into the seed's key).
LATENT_TAG = 7

# Modes whose ABFT detections feed the BER monitor; only they pay ABFT
# compute and checkpoint traffic in the perfmodel.
MONITORED_MODES = ("drift", "stat_abft")


def _taylorseer_cfg(key: SamplerKey) -> TaylorSeerConfig:
    """The TaylorSeer schedule a DiT key runs, and so the one it is
    billed for."""
    return TaylorSeerConfig(enabled=key.taylorseer)


@dataclasses.dataclass
class BatchOutcome:
    """What ``finalize`` hands back to the engine."""
    corrected: int
    n_model_evals: int
    rc: energy.RunConfig        # the batch's perfmodel run shape
    n_words: int                # telemetry BER denominator
    per_slot: List[dict]
    # binned detections (sites, timestep bins) and the site labels; None
    # when the sampler produced no heatmap
    heatmap: Optional[tuple] = None
    heatmap_blocks: Optional[tuple] = None


class DiffusionServable:
    """The DRIFT denoising path for one engine."""

    paradigm = "diffusion"
    init_params = staticmethod(dit.init_params)

    def __init__(self, engine):
        self.eng = engine

    def validate_request(self, fields: dict) -> dict:
        mode = fields.get("mode", "drift")
        if mode not in PORTED_MODES:
            raise ValueError(
                f"mode {mode!r} is not yet ported to repro_torch for "
                "diffusion archs (ROADMAP Queue A item 4, baselines); "
                f"ported: {PORTED_MODES}")
        return fields

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
            taylorseer=_taylorseer_cfg(key),
            # protect_steps rides the engine's nominal_steps so the
            # precision protection window matches the DVFS one
            precision=quant_lib.get_plan(key.precision).with_protect_steps(
                eng.nominal_steps),
            monitor_target_ber=eng.monitor_target_ber)
        return eng._sampler_factory(key, model_cfg, scfg)

    def _clean_reference(self, key: SamplerKey, seeds: Tuple[int, ...],
                         params, latents, cond) -> torch.Tensor:
        """Error-free reference latents for this batch, cached by
        (configuration, latent seeds) in the engine's bounded LRU."""
        eng = self.eng
        # precision="int8": a narrowed run is scored against the
        # full-width error-free sample; TaylorSeer stays as requested.
        ckey = dataclasses.replace(key, mode="clean", op="",
                                   precision="int8")
        sample_id = (ckey, seeds)
        cached = eng._clean_samples.get(sample_id)
        if cached is not None:
            eng._clean_samples.move_to_end(sample_id)
            eng.stats.clean_sample_hits += 1
            return cached
        fn = eng.cache.get(ckey, self.build_fn)
        # BER 0 everywhere: the flip source is never asked for a mask.
        *_, out = fn(params, None, latents, cond,
                     dvfs_lib.ber_monitor_init(eng.device),
                     window=max(key.steps, 1))
        clean = torch.clamp(out.latents, -1, 1)
        eng._clean_samples[sample_id] = clean
        while len(eng._clean_samples) > eng._clean_cache_size:
            eng._clean_samples.popitem(last=False)
        eng.stats.clean_samples_computed += 1
        return clean

    def execute(self, mb, ctx):
        """One drain of the windowed sampler: the whole chain as one
        window, or with offload on the refresh interval, so every
        committed snapshot offloads between windows. Streamed finals are
        bit-identical to one-shot ones, so offload changes no latent
        bit."""
        key = mb.key
        store = self.eng._offload_for(key)
        window = (max(key.steps, 1) if store is None
                  else min(key.rollback_interval, key.steps))
        *_, out = self._windows(mb, ctx, window, store,
                                streamed=store is not None)
        return out

    def execute_stream(self, mb, ctx, preview_interval: int) -> Iterator:
        """A ``PreviewEvent`` per live request after each window of
        ``preview_interval`` steps, then ``("final", output)``; offload
        commits ride the same windows."""
        eng = self.eng
        out = None
        for ev in self._windows(mb, ctx, preview_interval,
                                eng._offload_for(mb.key), streamed=True):
            if isinstance(ev, sampler_lib.SampleOutput):
                out = ev
                continue
            preview = torch.clamp(ev.latents, -1, 1)
            for slot, req in enumerate(mb.requests):   # live slots only
                eng.stats.preview_events += 1
                eng.telemetry.on_preview()
                yield PreviewEvent(request_id=req.request_id,
                                   batch_index=ctx.batch_index,
                                   step=int(ev.step),
                                   total_steps=mb.key.steps,
                                   latents=preview[slot])
        yield ("final", out)

    def _windows(self, mb, ctx, window: int, store,
                 streamed: bool) -> Iterator:
        """The windowed sampler's events for one batch, with ``store``
        (or None) bound to the batch and joined when it ends (its stat
        delta lands in ``ctx.offload_delta``). ``streamed``: the window
        taps fire, as for the reference's streamed samplers."""
        eng = self.eng
        fn = eng.cache.get(mb.key, self.build_fn)
        if store is not None:
            store.begin_batch(interval=mb.key.rollback_interval,
                              batch_index=ctx.batch_index)
            eng._active_offload = store
        eng._stream_taps = streamed
        try:
            latents, cond = ctx.inputs
            yield from fn(ctx.params, ctx.flip_source, latents, cond,
                          eng.monitor, window=window)
        finally:
            eng._stream_taps = False
            if store is not None:
                eng._active_offload = None
                ctx.offload_delta = store.finish_batch()

    def finalize(self, mb, ctx, out) -> BatchOutcome:
        key = mb.key
        latents, cond = ctx.inputs
        img = torch.clamp(out.latents, -1, 1)
        if key.mode == "clean":
            clean = img       # the run IS the reference
        else:
            clean = self._clean_reference(key, ctx.padded_seeds, ctx.params,
                                          latents, cond)
        # the true int64 count: the reference's int32 carry wraps it at
        # full width (ROADMAP Queue C item 7)
        corrected = int(out.total_corrected)
        protected = key.mode in MONITORED_MODES
        ts = _taylorseer_cfg(key)
        rc = energy.RunConfig(
            num_steps=key.steps, nominal_steps=self.eng.nominal_steps,
            aggressive=dvfs_lib.OP_BY_NAME.get(key.op, dvfs_lib.NOMINAL),
            ckpt_interval=key.rollback_interval if protected else 10 ** 9,
            abft_enabled=protected,
            taylorseer_interval=ts.interval if ts.enabled else 0,
            body_bits=quant_lib.get_plan(key.precision).body_bits,
            recovery_tiles_per_step=corrected / max(key.steps, 1)
            / (32 * 32))
        per_slot = []
        for slot in range(len(mb.requests)):
            a, b = img[slot:slot + 1], clean[slot:slot + 1]
            per_slot.append(dict(
                lpips_vs_clean=float(metrics.lpips_proxy(a, b)),
                psnr_vs_clean_db=float(metrics.psnr(a, b)),
                latents=a[0]))
        heat, blocks = heatmap_lib.summarize(out.heatmap)
        return BatchOutcome(corrected=corrected,
                            n_model_evals=int(out.n_model_evals), rc=rc,
                            n_words=latents.numel() * max(key.steps, 1),
                            per_slot=per_slot, heatmap=heat,
                            heatmap_blocks=blocks)


# ----------------------------------------------------- autoregressive path
class AutoregressiveServable:
    """Token-by-token decode with statistical ABFT and KV-window rollback
    (``serving.ar``) behind the engine's queue, cache and monitor."""

    paradigm = "autoregressive"
    init_params = staticmethod(transformer.init_params)

    #: the AR protection story is detection + window rollback; "drift"
    #: (inline tile rollback) is a diffusion mechanism.
    ALLOWED_MODES = ("clean", "faulty", "stat_abft")

    def __init__(self, engine):
        self.eng = engine
        # (arch, smoke) -> (params object, its prepared Weights)
        self._weights: Dict[Tuple[str, bool], tuple] = {}

    def validate_request(self, fields: dict) -> dict:
        arch = fields.get("arch", "?")
        if fields.get("taylorseer"):
            raise ValueError(
                f"request for AR arch {arch!r} sets taylorseer=True: "
                "TaylorSeer caches diffusion denoiser features across "
                "timesteps and does not apply to token decoding. Drop the "
                "flag (or serve a dit arch).")
        if fields.get("precision", "int8") != "int8":
            raise ValueError(
                f"request for AR arch {arch!r} sets precision="
                f"{fields['precision']!r}: precision plans narrow the "
                "diffusion denoiser body per timestep and do not apply to "
                "token decoding. Use the default 'int8' (or serve a dit "
                "arch).")
        if fields.get("energy_budget_j") is not None \
                or fields.get("quality_floor") is not None:
            raise ValueError(
                f"request for AR arch {arch!r} sets a frontier objective "
                "(energy_budget_j/quality_floor): the compute-optimal "
                "frontier enumerates diffusion knobs (steps x precision x "
                "TaylorSeer x DVFS) and is not built for autoregressive "
                "serving. Use deadline_s/step_budget instead.")
        mode = fields.get("mode", "drift")
        if mode not in self.ALLOWED_MODES:
            raise ValueError(
                f"request for AR arch {arch!r} has mode="
                f"{mode!r}: autoregressive serving supports modes "
                f"{'/'.join(self.ALLOWED_MODES)} (statistical ABFT with "
                "KV-cache window rollback)")
        return fields

    def batch_inputs(self, model_cfg, seeds: List[int]) -> Tuple:
        return (ar.prompt_tokens(model_cfg, seeds, self.eng.device),)

    def build_fn(self, key: SamplerKey) -> ar.DecoderFns:
        eng = self.eng
        model_cfg = configs.get_config(key.arch, smoke=key.smoke)
        if key.mode == "clean" or not key.op:
            schedule = None
        else:
            schedule = dvfs_lib.fine_grained_schedule(
                key.steps, dvfs_lib.OP_BY_NAME[key.op],
                nominal_steps=eng.nominal_steps)
        return ar.make_decoder(
            model_cfg,
            ar.DecodeConfig(steps=key.steps,
                            window=min(int(key.rollback_interval),
                                       key.steps),
                            mode=key.mode,
                            monitor_target_ber=eng.monitor_target_ber),
            schedule=schedule)

    def _weights_for(self, key: SamplerKey, params) -> transformer.Weights:
        """The prepared weights of ``params``, built once per params
        object (``set_params`` swaps the object and so re-prepares)."""
        k = (key.arch, key.smoke)
        hit = self._weights.get(k)
        if hit is None or hit[0] is not params:
            cfg = configs.get_config(key.arch, smoke=key.smoke)
            hit = self._weights[k] = (params,
                                      transformer.prepare(cfg, params))
        return hit[1]

    def execute(self, mb, ctx):
        eng = self.eng
        fns = eng.cache.get(mb.key, self.build_fn)
        (tokens,) = ctx.inputs
        tracer = eng.tracer

        # window and replay spans carry joules: decoded tokens at the
        # batch's per-step estimate, replays their window length at it
        def on_window(done_steps: int) -> None:
            tracer.on_window(done_steps,
                             energy_j=eng._window_energy_delta_j(done_steps))

        def on_replay(window_start: int, window_len: int) -> None:
            tracer.on_replay(window_start, window_len,
                             energy_j=window_len * eng._window_step_j)

        return ar.decode_batch(fns, self._weights_for(mb.key, ctx.params),
                               tokens, eng.monitor, ctx.flip_source,
                               on_window=on_window, on_replay=on_replay)

    def execute_stream(self, mb, ctx, preview_interval: int) -> Iterator:
        raise ValueError(
            "run_stream() previews are latent images -- a diffusion "
            "mechanism. Autoregressive requests return their tokens in "
            "RequestResult.tokens via run().")

    def _clean_tokens(self, mb, ctx) -> torch.Tensor:
        """Fault-free reference decode of this (configuration, prompts),
        cached in the engine's clean-sample LRU like the diffusion one."""
        eng = self.eng
        ckey = dataclasses.replace(mb.key, mode="clean", op="")
        sample_id = (ckey, ctx.padded_seeds)
        cached = eng._clean_samples.get(sample_id)
        if cached is not None:
            eng._clean_samples.move_to_end(sample_id)
            eng.stats.clean_sample_hits += 1
            return cached
        fns = eng.cache.get(ckey, self.build_fn)
        (tokens,) = ctx.inputs
        out = ar.decode_batch(fns, self._weights_for(mb.key, ctx.params),
                              tokens, dvfs_lib.ber_monitor_init(eng.device),
                              None)
        clean = out.tokens
        eng._clean_samples[sample_id] = clean
        while len(eng._clean_samples) > eng._clean_cache_size:
            eng._clean_samples.popitem(last=False)
        eng.stats.clean_samples_computed += 1
        return clean

    def finalize(self, mb, ctx, out) -> BatchOutcome:
        toks = out.tokens.cpu().numpy()                # (B, steps)
        if mb.key.mode == "clean":
            clean = toks
        else:
            clean = self._clean_tokens(mb, ctx).cpu().numpy()
        per_slot = []
        for slot in range(len(mb.requests)):
            mismatch = float(np.mean(toks[slot] != clean[slot]))
            # token-space stand-ins for the image metrics of the result
            # schema: lpips ~ mismatch share, psnr ~ -10 log10 of it
            psnr = 99.0 if mismatch == 0.0 else float(
                -10.0 * np.log10(mismatch))
            per_slot.append(dict(
                lpips_vs_clean=mismatch, psnr_vs_clean_db=psnr,
                latents=None, tokens=tuple(int(t) for t in toks[slot]),
                token_match_vs_clean=1.0 - mismatch,
                ar_detections=int(out.detections),
                ar_rollbacks=int(out.rollbacks)))
        # Replays are real decode steps: evals = 1 prefill + key.steps
        # first-pass decodes + window re-decodes, and everything past the
        # first two terms bills as compute_replay.
        nevals = int(out.n_model_evals)
        protected = mb.key.mode in MONITORED_MODES
        rc = energy.RunConfig(
            num_steps=nevals, nominal_steps=self.eng.nominal_steps,
            aggressive=dvfs_lib.OP_BY_NAME.get(mb.key.op, dvfs_lib.NOMINAL),
            ckpt_interval=(mb.key.rollback_interval if protected
                           else 10 ** 9),
            abft_enabled=protected, taylorseer_interval=0,
            recovery_tiles_per_step=0.0,
            replay_evals=max(nevals - 1 - mb.key.steps, 0))
        heat, blocks = heatmap_lib.summarize(out.heatmap)
        return BatchOutcome(corrected=int(out.rollbacks),
                            n_model_evals=nevals, rc=rc,
                            n_words=max(int(out.n_words), 1),
                            per_slot=per_slot, heatmap=heat,
                            heatmap_blocks=blocks)


# family -> its servable class, for the families the port has.
SERVABLE_BY_FAMILY = {
    "dit": DiffusionServable,
    "dense": AutoregressiveServable,
}

# family -> serving paradigm, as the reference names them.
PARADIGM_BY_FAMILY: Dict[str, str] = {
    fam: cls.paradigm for fam, cls in SERVABLE_BY_FAMILY.items()}


def servable_class(arch: str):
    """The servable class of an arch's family (raises for archs not yet
    ported)."""
    family = configs.get_config(arch).family
    if family not in SERVABLE_BY_FAMILY:
        raise NotImplementedError(
            f"arch {arch!r}: family {family!r} has no servable in "
            "repro_torch yet (ROADMAP Queue A item 12)")
    return SERVABLE_BY_FAMILY[family]


def paradigm_for(arch: str) -> str:
    """Serving paradigm of an arch (raises for archs not yet ported)."""
    return servable_class(arch).paradigm
