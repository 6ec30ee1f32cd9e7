"""Autoregressive decode loop with statistical ABFT and KV-window rollback.

Counterpart of ``repro.serving.ar``: greedy token-by-token decoding over
``models.transformer`` under the DVFS BER table, with ReaLM-style
statistical ABFT (``kernels.stat_abft``) on every projection GEMM:

  * every faulted decode step routes ``attn.{q,k,v,o}`` and, in the
    dense and hybrid families, ``mlp.{gate,up,down}`` through a
    detection-only ``StatAbftContext`` (the MoE family's expert FFNs and
    the SSD blocks of the SSM and hybrid families are unprotected, as in
    the reference; an SSM arch has no protected word, so its faulty and
    stat_abft decodes are its clean one):
    bit flips are injected into the f32 view of each GEMM output by the
    injection kernel (``kernels.fault_inject``), with the mask a flip
    source draws for ``FaultSite(step, layer_idx, name)``, and rows whose
    checksum residual leaves the rounding envelope are counted;
  * decoding runs in windows of ``rollback_interval`` tokens. A window
    that detects anything is rolled back and replayed fault-free.

One departure from the reference (ROADMAP Queue C item 6): a flip that
makes a NaN leaves a NaN residual, which ``|r| > tau`` never flags, so
the reference keeps a window whose only faults made NaNs, and its tokens
with it. The port counts such rows apart (``nan_rows``) and rolls their
window back too. Detections, the heatmap and the BER monitor stay the
reference's statistical counts; only the replay decision (and so
rollbacks, evaluations and tokens) differs, and only for such windows.

Rollback restores the window's snapshot of ``(cache, last token)``. The
reference's cache is immutable, so its snapshot is a reference; the port's
has two parts, each restored soundly without a copy:

  * the KV cache is written in place and not cloned; restoring
    ``cache.pos`` is enough, since the replay rewrites each slot
    ``i..i+n-1`` before it reads it, and ``decode_attention`` reads no
    slot past ``pos``;
  * the SSM state (``cache.ssm``, one ``(h, conv)`` per layer) is
    recurrent: each step's state is computed from all of the last one, so
    a faulted step's NaN in ``h`` would stay for the rest of the request.
    The decode step never writes a state in place; it returns new
    tensors, so the snapshot's tuple still holds the state from the
    window's start, and restoring the snapshot restores it.

Host syncs: detections stay on the device for the whole window (the
reference reads ``float(det)`` after every step); the host reads one
scalar per window, for the replay decision, and the per-step heatmap at
the end. A replay runs the clean decode step: at BER 0 the reference's
context computes the same values, and the replay's detections and monitor
output are discarded. At BER 0 a context skips the draw and the injection,
as the flip source already skips the draw.

``make_decoder`` builds the prefill and step callables of one
configuration (the engine's cache counts it as one build).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import dvfs, fault
from repro_torch.kernels import stat_abft
from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig

#: fixed prompt length, as the reference's.
PROMPT_LEN = 8

#: stream tag mixed into a request seed for its prompt tokens.
PROMPT_TAG = 0x41525052  # "ARPR"


def prompt_tokens(cfg: ModelConfig, seeds, device="cpu") -> torch.Tensor:
    """Deterministic per-seed synthetic prompts, (B, PROMPT_LEN) int64,
    from the port's own generator (the reference draws from threefry, so
    the two differ; parity tests hand the reference's prompts in)."""
    rows = []
    for s in seeds:
        g = torch.Generator(device=device)
        g.manual_seed(fault.mix64(int(s), PROMPT_TAG))
        rows.append(torch.randint(0, cfg.vocab, (PROMPT_LEN,), generator=g,
                                  device=device))
    return torch.stack(rows)


def protected_words_per_step(cfg: ModelConfig, batch: int) -> int:
    """GEMM output words routed through the ABFT context per decode step
    (the BER monitor's normalization), by the reference's family
    branches: attn.{q,k,v,o}, plus mlp.{gate,up,down} outside the MoE
    family (whose expert FFNs are unprotected); none in the SSM family,
    whose SSD blocks are unprotected."""
    d, h, hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd,
                        cfg.d_ff)
    per_layer = 0
    if cfg.family != "ssm":
        per_layer += h * hd + 2 * hkv * hd + d          # attn.{q,k,v,o}
        if cfg.family != "moe":
            per_layer += 2 * f + d                      # mlp.{gate,up,down}
    return cfg.n_layers * per_layer * batch


class StatAbftContext:
    """Detection-only execution context for one decode layer.

    ``matmul(x, proj, name=, rclass=)`` computes the clean product in the
    model dtype, injects the flip source's mask for ``FaultSite(step,
    layer_idx, name)`` into its f32 view at ``ber_by_class[rclass]``, and
    (with ``detect``) counts rows whose checksum residual exceeds the
    statistical threshold and, apart, rows whose residual is NaN. The
    counts stay on the device. No correction.
    """

    def __init__(self, flip_source: Optional[fault.FlipSource], step: int,
                 layer_idx: int, ber_by_class: np.ndarray, detect: bool):
        self.flip_source = flip_source
        self.step = int(step)
        self.layer_idx = int(layer_idx)
        self.ber_by_class = ber_by_class
        self.detect = detect
        self.stats: Dict[str, object] = {"detected_rows": 0,
                                         "nan_rows": 0, "gemm_words": 0.0}

    def matmul(self, x: torch.Tensor, proj: transformer.Proj, *, name: str,
               rclass: int) -> torch.Tensor:
        y = x @ proj.w                                   # clean product
        ber = float(self.ber_by_class[int(rclass)])
        y_faulty = y
        if ber > 0.0:
            site = fault.FaultSite(self.step, self.layer_idx, name)
            mask = self.flip_source(site, tuple(y.shape), ber)
            # bf16 -> f32 is exact; f32 -> bf16 rounds to nearest even.
            y_faulty = fault.inject_f32(y.float(), mask.to(y.device))
        if self.detect:
            flagged, nan = stat_abft.detect_and_nan(
                x, proj.w, y_faulty, proj.w_sum, proj.w_abs_sum)
            self.stats["detected_rows"] = (self.stats["detected_rows"]
                                           + flagged.sum())
            self.stats["nan_rows"] = self.stats["nan_rows"] + nan.sum()
        self.stats["gemm_words"] += float(y.numel())
        return y_faulty.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Static decode-loop shape."""
    steps: int                   # tokens to generate (incl. prefill's)
    window: int                  # rollback window, in decode steps
    mode: str                    # "clean" | "faulty" | "stat_abft"
    monitor_target_ber: float


@dataclasses.dataclass(frozen=True)
class DecoderFns:
    """What ``make_decoder`` hands the serving cache: the prefill and step
    callables plus the static config ``decode_batch`` drives."""
    dcfg: DecodeConfig
    prefill: Callable
    step: Callable


class DecodeOut(NamedTuple):
    tokens: torch.Tensor         # (B, steps) generated tokens
    monitor: dvfs.BerMonitorState
    detections: float            # flagged checksum rows, summed
    rollbacks: int               # windows reverted + replayed
    n_model_evals: int           # prefill + decode steps incl. replays
    n_words: float               # GEMM words checked (0 for clean)
    heatmap: torch.Tensor        # (steps, 1) int32 detections per step
    nan_rows: float              # NaN-residual rows, summed (not detected)


def make_decoder(cfg: ModelConfig, dcfg: DecodeConfig, *,
                 schedule: Optional[dvfs.DvfsSchedule] = None
                 ) -> DecoderFns:
    """Build the prefill and step callables of one AR configuration.
    ``schedule`` is the per-step DVFS BER table (None: fault-free)."""
    if dcfg.mode not in ("clean", "faulty", "stat_abft"):
        raise ValueError(f"AR decode mode {dcfg.mode!r}; one of clean, "
                         "faulty, stat_abft")
    max_seq = PROMPT_LEN + dcfg.steps
    if schedule is not None:
        ber_table = np.asarray(schedule.ber_table, np.float32)
    else:
        ber_table = np.zeros((max(dcfg.steps, 1), dvfs.N_CLASSES),
                             np.float32)
    n_rows = ber_table.shape[0]

    def prefill(params, tokens):
        logits, cache = transformer.prefill(cfg, params, tokens, max_seq)
        return logits[:, -1, :].argmax(dim=-1), cache

    def step(params, cache, tok, step_idx: int, monitor, flip_source,
             ber_scale: float):
        """One decode step; returns (next token, cache, monitor,
        detections, NaN-residual rows (each a 0-d device tensor or 0),
        GEMM words)."""
        if dcfg.mode == "clean" or ber_scale == 0.0:
            logits, cache, _ = transformer.decode_step(cfg, params, cache,
                                                       tok[:, None])
            det, nan, words = 0, 0, 0.0
        else:
            row = ber_table[min(max(step_idx, 0), n_rows - 1)] \
                * np.float32(ber_scale)

            def ctx_factory(layer_idx):
                return StatAbftContext(flip_source, step_idx, layer_idx,
                                       row, detect=dcfg.mode == "stat_abft")
            logits, cache, stats = transformer.decode_step_stats(
                cfg, params, cache, tok[:, None], ctx_factory)
            det, nan, words = (stats["detected_rows"], stats["nan_rows"],
                               stats["gemm_words"])
            det_t = torch.as_tensor(det, dtype=torch.float32,
                                    device=tok.device)
            monitor = dvfs.ber_monitor_update(
                monitor, det_t,
                max(protected_words_per_step(cfg, tok.shape[0]), 1), 0,
                dcfg.monitor_target_ber)
        return (logits[:, -1, :].argmax(dim=-1), cache, monitor, det, nan,
                words)

    return DecoderFns(dcfg=dcfg, prefill=prefill, step=step)


def decode_batch(fns: DecoderFns, params, tokens: torch.Tensor,
                 monitor0: dvfs.BerMonitorState,
                 flip_source: Optional[fault.FlipSource],
                 on_window: Optional[Callable[[int], None]] = None,
                 on_replay: Optional[Callable[[int, int], None]] = None
                 ) -> DecodeOut:
    """Host decode loop: prefill, then windows of decode steps with
    detect / rollback-replay. See the module docstring.

    ``on_window(done_steps)`` and ``on_replay(window_start, window_len)``
    are host taps (the flight recorder's) after each decoded window and
    each rollback replay; they add no device op."""
    dcfg = fns.dcfg
    if tokens.shape[1] != PROMPT_LEN:
        raise ValueError(f"prompts must be (B, {PROMPT_LEN}), got "
                         f"{tuple(tokens.shape)}")
    dev = tokens.device
    last_tok, cache = fns.prefill(params, tokens)
    generated = [last_tok]
    monitor = monitor0
    detections = nan_rows = 0.0
    n_words = 0.0
    rollbacks = 0
    n_model_evals = 1                          # the prefill pass
    window = max(dcfg.window, 1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    det_steps: List[torch.Tensor] = [zero]     # prefill runs clean

    i = 1
    while i < dcfg.steps:
        n = min(window, dcfg.steps - i)
        # cache.pos and the tuple of SSM states (never written in place)
        snap_cache, snap_tok = cache, last_tok
        window_toks = []
        det_w = nan_w = zero
        for j in range(n):
            last_tok, cache, monitor, det, nan, words = fns.step(
                params, cache, last_tok, i + j, monitor, flip_source, 1.0)
            window_toks.append(last_tok)
            det_steps.append(zero + det)
            det_w = det_w + det
            nan_w = nan_w + nan
            n_words += words
        n_model_evals += n
        # one host sync per window
        det_w_host, nan_w_host = torch.stack([det_w, nan_w]).tolist()
        detections += det_w_host
        nan_rows += nan_w_host
        if dcfg.mode == "stat_abft" and (det_w_host > 0 or nan_w_host > 0):
            # Revert the corrupted window and replay it fault-free.
            cache, last_tok = snap_cache, snap_tok
            window_toks = []
            for j in range(n):
                last_tok, cache, *_ = fns.step(
                    params, cache, last_tok, i + j, monitor, flip_source,
                    0.0)
                window_toks.append(last_tok)
            rollbacks += 1
            n_model_evals += n
            if on_replay is not None:
                on_replay(i, n)
        generated.extend(window_toks)
        i += n
        if on_window is not None:
            on_window(i)

    toks = torch.stack(generated, dim=1)                # (B, steps)
    heatmap = torch.stack(det_steps).to(torch.int32)[:, None]
    return DecodeOut(tokens=toks, monitor=monitor, detections=detections,
                     rollbacks=rollbacks, n_model_evals=n_model_evals,
                     n_words=n_words, heatmap=heatmap, nan_rows=nan_rows)
