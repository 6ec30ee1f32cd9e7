"""The DRIFT sampling loop: DDIM steps with fine-grained DVFS, rollback-ABFT
checkpointing, BER monitoring, and optional TaylorSeer caching and
narrowed precision plans.

Counterpart of ``repro.diffusion.sampler``'s one-shot ``sample``. The
reference's ``lax.scan`` becomes a Python loop over steps; per step:

  1. with TaylorSeer on, steps off its interval grid forecast ``eps``
     from the Taylor table instead of running the model: no GEMM, no flip
     mask, 0 corrected and 0 detected, a zero heatmap row, and the
     checkpoint stores left alone,
  2. otherwise the DVFS schedule's host BER table gives the BER per
     resilience class (nominal for the first ``nominal_steps`` and the
     embedding GEMMs) and the model runs with fault injection, ABFT and
     tile rollback (``ExecContext`` inside the model), checkpoints
     refreshing in place every ``interval`` steps of the step index
     (``have_ckpt`` is false on step 0),
  3. a narrowed precision plan fake-quantizes ``eps`` on steps
     ``>= protect_steps`` (gated on the host step index: the default
     ``"int8"`` plan adds no op),
  4. the BER monitor folds the step's detected-error count into its
     estimate (Sec 5.1 feedback loop), forecast steps included,
  5. DDIM updates the latents.

Clean mode runs as drift at BER 0, as in the reference. Modes that write
no checkpoints (``faulty`` and the baselines) leave the zero stores as
they are, as the reference keeps the carry's.

The DiT and PixArt (``models.dit``, whose stores are ``(embed_store,
block_store)``; PixArt reads ``text``) and the SD1.5 UNet
(``models.unet``: one ``ExecContext`` per evaluation at fault scope 0, a
flat name-keyed store, one heatmap row) share the loop, as in the
reference's ``_model_eval``.

One step loop serves both execution shapes. ``sample_stream`` runs it in
windows of ``window`` steps: after each window it hands the carry
``(latents, (embed_store, block_store), taylor, monitor, corrected,
nevals)`` to ``on_carry`` (the checkpoint-offload store reads
``carry[1]`` and ``carry[3]``), the completed-step count to
``on_window``, and yields a ``StreamEvent`` preview, except after the
last window, where it yields the ``SampleOutput``. ``sample`` drains it
as one window, so streamed finals are bit-identical to one-shot ones.
The Fig 6 gates (``layer_gate``, ``embed_gate``) scale the per-layer and
embedding BERs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import dvfs as dvfs_lib
from repro_torch.core import fault
from repro_torch.core import quant as quant_lib
from repro_torch.core.exec_ctx import DriftSystemConfig, ExecContext
from repro_torch.diffusion import schedule as sched_lib
from repro_torch.diffusion import taylorseer as ts_lib
from repro_torch.distributed import constraints
from repro_torch.models import dit as dit_lib
from repro_torch.models import unet as unet_lib
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    num_sample_steps: int = 50
    num_train_steps: int = 1000
    drift: DriftSystemConfig = dataclasses.field(
        default_factory=lambda: DriftSystemConfig(mode="clean"))
    schedule: Optional[dvfs_lib.DvfsSchedule] = None   # None -> error-free
    taylorseer: ts_lib.TaylorSeerConfig = dataclasses.field(
        default_factory=lambda: ts_lib.TaylorSeerConfig(enabled=False))
    precision: quant_lib.PrecisionPlan = quant_lib.DEFAULT_PLAN
    monitor_target_ber: float = 3e-3
    # Fig 6 block-level study: per-layer / embed BER multipliers
    layer_gate: Optional[Any] = None
    embed_gate: Optional[Any] = None


class SampleOutput(NamedTuple):
    latents: torch.Tensor
    monitor: dvfs_lib.BerMonitorState
    total_corrected: torch.Tensor     # 0-d int64 on the device
    n_model_evals: int                # computed (not forecast) steps
    # Detected row errors per (step, site): row 0 the embedding GEMMs,
    # rows 1..L the blocks (the UNet: one row); (steps, rows) int64 on
    # the device.
    heatmap: Optional[torch.Tensor] = None


class StreamEvent(NamedTuple):
    """Intermediate preview: the latents after ``step`` completed
    denoising steps (1-based, < num_sample_steps -- the final state
    arrives as the terminating ``SampleOutput``)."""
    step: int
    latents: torch.Tensor


def detection_rows(model_cfg: ModelConfig) -> int:
    """Heatmap rows: one per block plus the embedding GEMMs' (DiT family);
    the UNet's one context gives one row."""
    if model_cfg.family == "unet":
        return 1
    return model_cfg.n_layers + 1


def init_stores(model_cfg: ModelConfig, batch: int, device):
    """Zero checkpoint stores: the DiT's ``(embed_store, block_store)``,
    the UNet's flat dict."""
    if model_cfg.family == "unet":
        return unet_lib.drift_store_spec(model_cfg, batch, device)
    return dit_lib.drift_store_spec(model_cfg, batch, device)


def sample(model_cfg: ModelConfig, params, flip_source: fault.FlipSource,
           latents0: torch.Tensor, cond: Optional[torch.Tensor],
           cfg: SamplerConfig,
           monitor0: Optional[dvfs_lib.BerMonitorState] = None,
           text: Optional[torch.Tensor] = None) -> SampleOutput:
    """Run the full denoising chain from Gaussian latents: the one-window
    drain of :func:`sample_stream`.

    ``flip_source`` draws each GEMM's flip mask; ``monitor0`` seeds the BER
    monitor (the serving engine passes the previous batch's); ``text``
    (B, Tt, cond_dim) conditions PixArt and the UNet, ``cond`` (class
    ids) the class-conditional DiT."""
    *_, out = sample_stream(model_cfg, params, flip_source, latents0, cond,
                            cfg, monitor0,
                            window=max(cfg.num_sample_steps, 1), text=text)
    return out


def sample_stream(model_cfg: ModelConfig, params,
                  flip_source: fault.FlipSource, latents0: torch.Tensor,
                  cond: Optional[torch.Tensor], cfg: SamplerConfig,
                  monitor0: Optional[dvfs_lib.BerMonitorState] = None,
                  window: int = 1,
                  on_window: Optional[Callable[[int], None]] = None,
                  on_carry: Optional[Callable[[int, Tuple], None]] = None,
                  text: Optional[torch.Tensor] = None) -> Iterator:
    """The denoising chain in windows of ``window`` steps: a
    :class:`StreamEvent` after every window but the last, then the
    :class:`SampleOutput`. ``on_carry(done, carry)`` and
    ``on_window(done)`` run after every window, the last included,
    before its event is yielded."""
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    device = latents0.device
    sched = sched_lib.DdpmSchedule.default(cfg.num_train_steps)
    ts = sched_lib.ddim_timesteps(cfg.num_train_steps, cfg.num_sample_steps)
    t_prev = np.concatenate([ts[1:], [-1]]).astype(np.int32)
    if cfg.schedule is not None:
        ber_table = np.asarray(cfg.schedule.ber_table, np.float32)
    else:
        ber_table = np.zeros((cfg.num_sample_steps, dvfs_lib.N_CLASSES),
                             np.float32)
    scfg = cfg.drift
    if scfg.mode == "clean":
        # quantized error-free baseline == drift path at BER 0
        scfg = dataclasses.replace(scfg, mode="drift")
        ber_table = np.zeros_like(ber_table)
    b = latents0.shape[0]
    protected = scfg.mode != "float_clean"
    unet = model_cfg.family == "unet"
    stores = (init_stores(model_cfg, b, device) if protected
              else {} if unet else ({}, {}))
    mon = monitor0 if monitor0 is not None else \
        dvfs_lib.ber_monitor_init(device)
    # the whole batch's words, also when this rank holds some of its rows
    n_words = max(constraints.global_rows(b)[0]
                  * int(np.prod(latents0.shape[1:])), 1)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    zero_rows = torch.zeros((detection_rows(model_cfg),), dtype=torch.int64,
                            device=device)

    def step_fn(i: int, latents: torch.Tensor):
        tvec = torch.full((b,), float(ts[i]), dtype=torch.float32,
                          device=device)
        ber_row = ber_table[min(i, ber_table.shape[0] - 1)]
        if unet:
            ctx = None
            if protected:
                ctx = ExecContext(scfg, flip_source=flip_source, step=i,
                                  scope=unet_lib.SCOPE, ber_by_class=ber_row,
                                  state_in=stores, have_ckpt=i > 0)
            eps = unet_lib.forward(model_cfg, params, latents, tvec, text,
                                   ctx=ctx)
            if ctx is None:
                return eps, zero, zero, zero_rows
            detected = dit_lib._as_count(ctx.stats["detected_row_errors"],
                                         device)
            return (eps, dit_lib._as_count(ctx.stats["corrected_elems"],
                                           device),
                    detected, detected[None])
        drift = None
        if protected:
            embed_store, block_store = stores
            drift = dit_lib.DriftState(
                cfg=scfg, flip_source=flip_source, step=i,
                ber_by_class=ber_row, embed_store=embed_store,
                block_store=block_store, have_ckpt=i > 0,
                layer_gate=cfg.layer_gate, embed_gate=cfg.embed_gate)
        eps, stats = dit_lib.forward(model_cfg, params, latents, tvec, cond,
                                     drift=drift, text=text)
        return (eps, stats.get("corrected_elems", zero),
                stats.get("detected_row_errors", zero),
                stats.get("detected_per_block", zero_rows))

    ts_cfg, plan = cfg.taylorseer, cfg.precision
    taylor = (ts_lib.init_state(latents0.shape, device=device)
              if ts_cfg.enabled else None)
    latents = latents0
    corrected = zero
    nevals = 0
    heat = []
    n = len(ts)
    for start in range(0, n, window):
        done = min(start + window, n)
        with torch.no_grad():
            for i in range(start, done):
                if ts_lib.should_compute(i, ts_cfg):
                    eps, corr, detected, det_blocks = step_fn(i, latents)
                    if ts_cfg.enabled:
                        taylor = ts_lib.update_on_compute(taylor, eps)
                    nevals += 1
                    if constraints.batch_sharded():
                        # the whole batch's counts, before the monitor
                        packed = constraints.data_sum(
                            torch.cat([corr.reshape(1), det_blocks]))
                        corr, det_blocks = packed[0], packed[1:]
                        detected = det_blocks.sum()
                else:
                    eps = ts_lib.forecast(taylor, i % ts_cfg.interval,
                                          ts_cfg.interval, ts_cfg.order)
                    corr, detected, det_blocks = zero, zero, zero_rows
                if plan.narrowed and i >= plan.protect_steps:
                    eps = quant_lib.fake_quant(
                        eps, plan.body_bits,
                        amax=constraints.data_amax(eps.abs().amax()))
                mon = dvfs_lib.ber_monitor_update(
                    mon, detected, n_words, scfg.abft.threshold_bit,
                    cfg.monitor_target_ber)
                latents = sched.ddim_step(latents, eps, int(ts[i]),
                                          int(t_prev[i]))
                corrected = corrected + corr
                heat.append(det_blocks)
        if on_carry is not None:
            on_carry(done, (latents, stores, taylor, mon, corrected,
                            nevals))
        if on_window is not None:
            on_window(done)
        if done < n:
            yield StreamEvent(step=done, latents=latents)
    yield SampleOutput(latents, mon, corrected, nevals, torch.stack(heat))
