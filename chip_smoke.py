#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of DRIFT on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # every phase, as the check runs it
    python3 chip_smoke.py --phases device,build,kernels --reps 3
    python3 chip_smoke.py --phases device,build,kernels,ar
    python3 chip_smoke.py --phases device,build,kernels,lm
    python3 chip_smoke.py --phases device,build,kernels,moe
    python3 chip_smoke.py --phases device,build,kernels,ssm
    python3 chip_smoke.py --phases device,build,offload
    python3 chip_smoke.py --phases device,build,sched
    python3 chip_smoke.py --phases device,build,baselines
    python3 chip_smoke.py --phases device,build,families
    python3 chip_smoke.py --phases device,build,resilience
    python3 chip_smoke.py --phases device,build,kernels,train
    python3 chip_smoke.py --phases device,build,sharded
    python3 chip_smoke.py --phases device,build,sharded_lm
    python3 chip_smoke.py --phases device,build,train_sharded
    python3 chip_smoke.py --phases device,build,roofline,examples

Phases, each printing one JSON line with its wall time:

1. device   -- the card (nvidia-smi name and power limit), torch and CUDA.
2. build    -- compile the six CUDA kernels from ``src/repro_torch/
               kernels/csrc`` (one nvcc each, in parallel); registers and
               spill bytes of every compiled kernel (``ptxas -v``);
               ``stat_abft``'s and ``drift_gemm``'s (``WGMMA_KERNELS``)
               must show no spill and no wgmma that ptxas serialized
               (C7518).
3. kernels  -- each kernel against its plain PyTorch version on the card,
               at the shapes the serving path gives it: ``abft_matmul`` at
               the seven padded GEMM shapes of DiT-XL/2-512 at bucket 2
               (flips at BER 3e-3 plus one bit-31 flip; all five outputs
               bit-equal; achieved TOP/s and the ratio to
               ``torch._int_mm``), ``rollback_correct`` (union and cross,
               bit-equal) and attention as the DiT block calls it
               (``mha_flash`` on (2, 1024, 16, 72) reshaped projections
               in place, and the
               ``(BH, S, D)`` entry point ``flash_attention`` on folded
               copies; bf16 on the tensor cores within 1e-2 and f32
               within 2e-5 of the plain version). Device times
               from ``torch.profiler`` (the kernel, its plain version and a
               PyTorch library call where one exists, attention's SDPA in
               the row's dtype), the wall time per call with CUDA events
               (``wall_ms``, host launch overhead included), the least
               time the card could take (``bound_ms``, attention's at the
               bf16 or f32 rate of its dtype) and attention's achieved
               TFLOP/s. Timed calls cycle
               through copies of their inputs that together exceed twice
               the L2, so each call reads its inputs cold from HBM. Then
               the autoregressive slice's: ``fault_inject`` at the decode
               GEMM outputs (2, 1, 2048) and (2, 1, 8192) f32 and at
               8192 x 8192 int32 (bit-equal on int32 views; timed over
               ten times ``--reps``, beside ``torch.bitwise_xor``), the
               prefill's attention call ``mha_flash`` at (2, 8, 16, 128)
               causal (bf16 and f32, within tolerance; one kernel on the
               (B, S, H, D) inputs in place), ``stat_abft_matmul``'s
               ``wgmma`` kernel at the DiT's three body GEMMs
               (2048x1152x1152, x4608 and 2048x4608x1152), at M = 32,
               at K = 50 and at row tiles 96, 160, 256 and 384 (the
               32-wide instance's residuals summed by a second launch;
               64x1152x3840) (bit-equal at thresholds 0 and ``THRESHOLD``,
               with a bit-31 flip; at the DiT's shapes timed beside its
               bound, the kernel alone and its int8 rate, and beside the
               composite it replaced, which it must beat), and the
               composite ``drift_gemm`` at one DiT GEMM shape
               (bit-equal). Then ``drift_gemm_fused``, the drift
               paths' one kernel a protected GEMM, at the unpadded shapes
               they give it: the DiT's seven, PixArt's M = 240 and the
               UNet's M = 154 text GEMMs, and ``DriftDecode``'s one-tile
               shapes; every output bit-equal to the plain version at BER
               3e-3 (union, with a checkpoint; cross, without) and at BER
               0 (no mask), timed in the first setting beside its bound
               (the checkpoint read where masked, as this run's masks
               need): the call (its transpose of B to K-major, none at
               M <= 64, where the kernel reads B in place, and the
               ``wgmma`` kernel), each of the two alone, its int8 rate
               and its share of the bound. Then the GQA models'
               attention calls
               (``LM_ATTN``: gemma2-9b's prefill at (2, 8, 16/8, 256)
               with the softcap of 50 and window 4096 or none, a binding
               window at (1, 8192, 16/8, 256), gemma3-27b's prefill
               (2, 8, 32/16, 168) and (1, 2048, 32/16, 168), window 1024,
               glm4-9b's (1, 4096, 32/2, 128), hymba-1.5b's prefill
               (2, 8, 25/5, 64) and (1, 2048, 25/5, 64), window 1024),
               each one launch within tolerance of the plain version,
               beside its causal- and window-clipped bound and SDPA with
               ``enable_gqa`` (a compiled ``flex_attention`` where a
               softcap), the UNet's two
               self-attention shapes again over ``UNET_REPS`` times the
               launches, and whisper-base's encoder call (8, 1500, 8/8,
               64) within 3e-3, a limit that must fail the plain version
               with the partial last tile's 28 keys dropped; olmo-1b's
               train calls, causal (8, 128, 16/16, 128) (one process and
               the (1, 2) mesh) and (4, 128, 16/16, 128) (a (2, 1) rank),
               two key tiles with a causal diagonal, within 1e-2, a limit
               that must fail the plain version with the last whole key
               tile dropped. The train calls and whisper's also time the
               backward beside SDPA's. ``fault_inject`` and
               ``torch.bitwise_xor`` each take the median of
               ``FI_WINDOWS`` profiler windows, with their spread. Last,
               the single-flip sweep (``phase_kernels_flips``):
               ``abft_matmul``, ``drift_gemm_fused`` and
               ``stat_abft_matmul`` at 2048x1152x1152 and at M = 2, K =
               4608 (split K), every bit 0-31 at four positions, each
               launch ``torch.equal`` to its plain version; the first two
               flag iff bit >= 10; one line per kernel with its
               launches and lowest flagged bit.
4. reference -- the SMOKE DiT and the SMOKE olmo-1b served on the card
               (kernels) and on the CPU (plain versions) with the same
               params, inputs and flip masks: latents, tokens and counts
               must agree. The DiT runs twice: plain drift, and with
               TaylorSeer and ``int8-body4`` for 7 steps, whose corrected
               counts, evaluations (3) and modeled joules must be equal.
               Then the SMOKE DiT in the four Fig 12 baselines and SMOKE
               PixArt and the SMOKE UNet in drift, the same way (latents
               within 1e-3, counts within 1%, joules within 1e-6; dmr's
               finals equal to the clean reference's). Then SMOKE
               gemma2-9b, gemma3-27b and glm4-9b, and SMOKE
               deepseek-moe-16b and kimi-k2-1t-a32b (MoE; kimi's head dim
               8 over 8/2 heads takes the f32 kernel at its smallest
               width), and SMOKE mamba2-370m and hymba-1.5b (SSM and
               hybrid), 12 stat_abft tokens (past the SMOKE window of 8):
               tokens, rollbacks, evaluations and joules equal,
               detections within 2% (mamba2's 0 and 0); a 12-token
               prefill (two SSD chunks of 8), one attention launch an
               attention layer, logits within 1e-4; the MoE rows record
               the smallest gap between a token's k-th and (k+1)-th
               router probability on the card. Then SMOKE
               ``DriftDecode`` (olmo-1b, deepseek-moe-16b, hymba-1.5b)
               card against CPU with CPU-drawn masks, 4 steps at BER
               1e-2: greedy tokens, detected rows, corrected elements
               and flagged tiles equal, logits within 1e-4.
5. serve    -- ``repro_torch.launch.serve.main`` drives a full-width
               DiT-XL/2-512 engine (28 layers, random seeded weights): 2
               requests in drift/undervolt, then the same seeds in faulty
               mode. The launch counters are zeroed just before and read
               just after; the counts must be exact: every drift
               evaluation (the clean reference is drift at BER 0) one
               ``drift_gemm_fused`` launch a protected GEMM, every faulty
               one an ``abft_matmul``, no ``rollback_correct``. Then,
               counted on
               their own the same way, the same seeds in drift/undervolt
               with ``--taylorseer --precision int8-body4``: it and its
               TaylorSeer clean reference compute steps 0, 3, 6 and 9.
               Its line also carries ``count_params`` of the weights
               (beside the DiT paper's ~675 M) and ``store_bytes`` of the
               drift store at bucket 2 beside the offload planner's
               ``refresh_bytes``; the families, LM and train phases print
               their models' counts too.
6. offload  -- the same CLI serves the full-width DiT's 2 requests at
               rollback interval 2 in turns on fresh engines with one base
               seed: plain, ``--offload --stream 2``, the same again,
               plain; each engine serves them 3 times, a cold batch (drift
               and its clean reference; the pinned host sets allocated)
               and 2 steady ones (drift alone, everything reused). Every
               batch's launch counts are exact (3440 / 3440 / 560 / 0
               cold, half that steady) and its finals ``torch.equal`` to
               the first plain turn's batch of the same index (the flip
               source is keyed by batch index); each offloaded batch
               commits 5 snapshots of the 2,388,164,608-byte store and
               yields 8 previews, and the first offloaded turn's first
               steady batch's ``restore()`` equals its live store at step
               8 bit for bit.
               The ``{"offload": ...}`` line gives, beside the card's name
               and power limit, each batch's wall and peak memory over
               its start (the previous engine dropped and collected
               first), each commit's repack and device-to-host ms (CUDA
               events on their streams), GB/s, waits, the pinned
               allocation's seconds, the ``auto`` interval and the
               *modeled* stall; then the SMOKE DiT with ``--offload
               --stream 1 --rollback-interval 2`` on the card and the CPU
               (latents and corrected counts as in ``reference``; commits,
               committed bytes and previews equal).
7. sched    -- ``DeadlineScheduler`` with telemetry, the flight recorder
               and the HTTP front end. The SMOKE DiT (4 requests) and
               olmo-1b (2) through the scheduler on the card and the CPU
               with the same masks: admissions, masked ``/metrics``,
               spans and heatmaps equal. The full-width DiT: 6 requests
               (2 background; 2 interactive whose deadlines, from the
               scheduler's projection, force ``escalated-op``; one with
               ``step_budget=5``; one energy budget the frontier
               resolves), admissions equal to a CPU twin's that only
               submits, served in turns on fresh engines with telemetry,
               recorder and server on and with both off: launch counts
               exact per evaluation, finals bit-identical across turns,
               run walls; then the background pair again drained through
               ``/events?interval=2`` (``urllib``), and the routes
               scraped and timed, a Chrome trace written and loaded.
               Last, 4 ``op="auto"`` batches: the guardband floor, ladder
               index and monitor BER per batch. One
               ``{"phase": "sched", "part": ...}`` line per part.
8. ar       -- the same CLI drives a full-width olmo-1b engine (16
               layers, random seeded weights): 2 requests at bucket 2, 16
               tokens, rollback window 4, in stat_abft at undervolt, then
               faulty. Counters as in ``serve``: 105 fault_inject launches
               (15 faulted layers x 7 GEMMs) per faulted decode step, 16
               attention launches per prefill. stat_abft must detect, roll
               back and match the clean decode token for token. Then the
               time per decode step and a profiled request. Then 16
               ``DriftDecode`` steps on the same weights (8-token
               prompts, the undervolt BER table, refresh interval 4):
               exactly 112 ``drift_gemm_fused`` launches a step (7 GEMMs
               x 16 layers at M = 2) and no other GEMM kernel, a
               (16, 2, n_out) store, finite logits, ms per step.
9. lm       -- the same for full-width gemma2-9b (42 layers, d 3584, 16
               heads of 256 over 8 KV heads, windows of 4096 on alternate
               layers, softcaps; 9.24 B parameters, 18.5 GB of bf16
               weights from ``transformer.init_weights``, no f32
               masters), after the olmo-1b engine is freed: 287
               fault_inject launches (41 faulted layers x 7 GEMMs) per
               faulted decode step, 42 attention launches per prefill;
               peak device memory, ms per decode step, the profiled
               request's device busy share. Then, after gemma2-9b is
               freed, full-width gemma3-27b the same way (62 layers, d
               5376, 32 heads of 168 over 16, windows of 1024 on 5 of 6
               layers, a tied 262144 x 5376 embedding; 28.3 B parameters,
               56.6 GB): 427 fault_inject launches per faulted step, 62
               attentions per prefill; then glm4-9b (40 layers, d 4096,
               32 heads of 128 over 2; 9.40 B parameters, 18.8 GB): 273
               and 40. gemma3-27b's weights also decode a 1040-token
               prompt (past its window of 1024) 16 steps through
               ``decode_step`` and ``decode_step_mixed`` (its rings):
               the logits held to each other within
               ``MIXED_LOGITS_LIMIT`` (0: bit-equal), which a ring
               written one slot off must exceed; ms per step of each.
9b. moe     -- full-width deepseek-moe-16b (28 layers, d 2048, 16 heads
               of 128, 2 shared + 64 routed experts of 1408, top-6; 16.9
               B parameters, 33.8 GB in bf16) the same way, after every
               earlier engine is freed: the expert FFNs are unprotected,
               so 108 fault_inject launches (27 faulted layers x the 4
               attention projections) per faulted decode step, 28
               attentions per prefill, no abft_matmul,
               drift_gemm_fused or rollback_correct launch.
9c. ssm     -- full-width mamba2-370m (48 SSD layers, d 1024; 367.6 M
               parameters, 0.74 GB in bf16) and then hymba-1.5b (32
               layers of attention, 25 heads of 64 over 5, windows of 1024
               but on layers 0, 15 and 31, beside an SSD block; 1.589 B,
               3.18 GB) the same way. mamba2 protects nothing and has no
               attention: no launch, no detection or rollback, 16
               evaluations, faulty tokens equal to the clean ones. hymba:
               217 fault_inject launches (31 faulted layers x 7 GEMMs) per
               faulted decode step, 32 attentions per prefill; its
               rollbacks restore the SSM state.

10. baselines -- the full-width DiT-XL/2-512 serves the same 2 seeds at
               undervolt for 10 steps in thundervolt, approx_abft, dmr
               and stat_abft through the CLI: 1720 ``abft_matmul`` and
               280 attention launches per run (the first run also
               computes the clean reference, drift at BER 0: 1720
               ``drift_gemm_fused`` launches; no baseline launches it),
               dmr's finals ``torch.equal`` to the clean reference's;
               per mode PSNR against clean, corrected elements and the
               run wall, and one evaluation's ``extra_compute_flops`` /
               ``extra_dram_bytes`` (drift's beside them).
11. families -- full-width PixArt-alpha (285 protected GEMMs and 28
               attention launches per evaluation) and the SD1.5 UNet (40
               and 5) each serve 2 requests in drift (with its clean
               reference) and then faulty at undervolt for 10 steps:
               exact launch counts, finite drift latents, one profiled
               drift request each; then ``abft_matmul`` at the GEMM
               shapes they add and ``mha_flash`` at the UNet's two
               self-attention shapes, beside their bounds.
11a. resilience -- the paper's Sec 4 analysis
               (``examples.resilience_study``) at full-width
               DiT-XL/2-512 from ``tiny_model``'s recipe (random weights
               drawn on the card, the adaLN and final weights perturbed),
               bucket 2, 10 steps: the clean reference, Fig 4's bits
               RES_BITS, Fig 5's faulted steps RES_STEPS, Fig 6's sites
               RES_SITES and Fig 7's three trajectories, each sample's
               launches exact (1720 ``abft_matmul`` a faulty sample, 1720
               ``drift_gemm_fused`` a clean one, 280 attentions each), the
               clean reference and the first faulty sample also under the
               op counter, whose kernel calls must equal the launches (no
               plain version ran); the clean reference against itself
               lpips 0, psnr at the clamp, ssim 1. Whether each of the
               four phenomena shows is recorded, not asserted. Then every
               probe whole at SMOKE and 4 steps on the card and on the
               CPU with the same CPU-drawn masks, within the RES_ limits.
11b. sharded -- the serve phase's 2 full-width DiT requests (its seeded
               weights, drift at undervolt, 3 steps, step 2 faulted) in
               one process, where each must correct elements, then on a
               (data 2, model 1) and a (data 1, model 2) mesh, each of 2
               spawned ranks, the 4 ranks run together sharing cuda:0
               over gloo (``serving.sharded``): every rank's latents (on
               int32
               views), detection heatmaps, corrected counts, monitor
               state, billed joules and launch counts equal the one
               process's; per rank the wall, the peak memory and the
               collectives a batch. Beside the ranks, the SMOKE
               ``--sharded`` CLI under ``python -m torch.distributed.run``
               (2 ranks) exits 0 and prints the mesh line once.
11c. sharded_lm -- the sharded engine's language-model buckets (a
               bucket runs whole on every rank, each layer's weights
               sharded at rest and gathered at its boundary): full-width
               olmo-1b (the ar phase's weights) serves 2 stat_abft
               requests of 4 tokens at window 2 in one process, then
               every other LM family at SMOKE (gemma2-9b, glm4-9b,
               gemma3-27b, deepseek-moe-16b, kimi-k2-1t-a32b,
               mamba2-370m, hymba-1.5b) 2 requests of 6 tokens at window
               3 in stat_abft and in faulty, beside the SMOKE ``--sharded
               --arch olmo-1b`` CLI on 2 ranks (exit 0, the mesh line and
               each request's line once). Then all of it on a (data 2,
               model 1) and a (data 1, model 2) mesh, each of 2 spawned
               ranks, the 4 ranks run together sharing cuda:0 over gloo:
               every rank's results, field for field, its monitor and its
               launch counts equal the one
               process's; olmo-1b's launches are exact (105
               ``fault_inject`` launches a faulted step, 16 attentions a
               prefill), it detects, rolls back and matches the clean
               tokens. Per rank: the wall and the wall per token, the
               collectives and the bytes gathered an evaluation (the
               bytes summed over the mesh must be the weights' gather
               buffers, evaluation by evaluation), held and peak memory.
12. train   -- training (``train.steps``, ``optim.adamw``,
               ``checkpoint.manager``): one SMOKE arch per family
               (olmo-1b, deepseek-moe-16b, mamba2-370m, hymba-1.5b,
               internvl2-76b with ``vis_embeds``, whisper-base,
               dit-xl-512, sd15-unet) takes 2 AdamW steps on the card and
               on the CPU from the same params and batches: losses, grad
               norms and gradients within the stated limits, and the
               card's AdamW update of the CPU's gradient within 1e-6 of
               each leaf's largest magnitude (``_train_smoke``),
               attention launches and backward calls exact. Then
               full-width olmo-1b and
               whisper-base take 3 steps each at global batch 8 and
               sequence 128 from the port's init: 16 and 12 attention
               launches (6 at S = 1500) and as many backward calls a
               step, finite losses, every param moved, the whole state
               checkpointed after step 2 and restored bit-equal; ms per
               step and peak memory. whisper-base then runs its prefill
               (8-token prompts over 1500 frames, 12 launches) and 16
               greedy decode steps. The ``kernels`` phase times the
               attention kernel at whisper-base's encoder call, and its
               backward beside SDPA's.
12b. train_sharded -- training across ranks (``make_train_step`` with a
               mesh, ``checkpoint.manager`` from a mesh,
               ``restore_resharded``): full-width olmo-1b cut to TS_LAYERS
               layers at global batch 8 and sequence 128 from the port's
               init on 2 spawned ranks sharing cuda:0 over gloo. Rank 0
               first runs a one-process twin's steps 1 and 2 alone; the
               mesh's AdamW update of the twin's gradient must be
               bit-equal on every rank's block.
               Then 2 steps on (data 2, model 1), each reduced gradient
               within TS_GRAD_RTOL of the twin's gradient at the mesh's
               params before the step (gathered whole), a limit that rank
               0's half batch alone must fail; a save from that mesh
               (leaves gathered whole, rank 0 writing); a restore onto
               (data 1, model 2), every rank's blocks bit-equal to the
               saved state; step 3 there, every block ``torch.equal`` to
               the twin's step 3 from the restored state (rank 1's sent
               through an exact integer sum). TS_LAYERS attention launches
               and backward calls a step on every rank. Per rank: ms,
               collectives and peak memory a step, save and restore
               seconds. Then, in the same ranks, full-width
               deepseek-moe-16b cut to TS_MOE_LAYERS layers takes
               TS_MOE_STEPS steps on (data 2, model 1), each MoE layer
               routing the global batch (``moe.moe_layer``): each
               reduced gradient
               within TS_GRAD_RTOL of the twin's at the mesh's params
               (rank 0's half alone failing it); every MoE layer's
               gathered tokens the same bits on both ranks, this rank's
               rows its own input, their routing ``torch.equal`` to
               ``moe.route`` of the gathered tokens; the assignments a
               per-rank route would drop and the global route keeps,
               counted; TS_MOE_LAYERS attention launches and backward
               calls a step; per rank ms, collectives and peak memory a
               step. Beside the ranks, the SMOKE CLI,
               ``--model-parallel 2`` and ``--arch deepseek-moe-16b`` on
               (2, 1), each under ``python -m torch.distributed.run`` (2
               ranks), both started with the ranks: each exits 0 and
               prints its mesh line once.
13. roofline -- three card paths: the full-width DiT's drift evaluation
               at bucket 2 (``dryrun.drift_sample_step``), full-width
               olmo-1b's train step at batch 8, seq 128, and its
               stat_abft decode step at bucket 2. Each is counted by
               ``launch.op_analysis`` on meta tensors and again on the
               card with its kernels launched: FLOPs, int8 ops and bytes
               must be equal. Each is timed (synchronised, the median of
               5 after a warm-up) and printed with its dominant term,
               bound on ``perfmodel.hw.H100_SXM`` and share bound /
               measured, which must not pass 1.05.
14. examples -- ``python -m repro_torch.examples.quickstart``,
               ``drift_serve --requests 2 --batch 2 --steps 3`` and
               ``resilience_study --probe bits`` on the card at SMOKE, as
               subprocesses started together: each must exit 0.

Every DiT and olmo-1b result carries the perfmodel's attribution; each
must bill a ledger whose ``ledger_total`` equals its ``energy_j`` bit for
bit, drift at undervolt must bill less than its baseline, the TaylorSeer
run less than plain drift, an offloaded result what its plain twin
bills (its modeled latency plus the planner's modeled stall), and
stat_abft's replays must bill as ``compute_replay``. These joules and seconds are the modeled paper
accelerator's, not this card's; the ``energy`` line says so.

Then it prints the run's wall time over every phase (the build included),
the ``energy`` line, the card's name and power limit, the ``kernels``
summary line and, last, ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside a checkout of the repository, it
raises and exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("device", "build", "kernels", "reference", "serve", "offload",
          "sched", "ar", "lm", "moe", "ssm", "baselines", "families",
          "resilience", "sharded", "sharded_lm", "train", "train_sharded",
          "roofline", "examples")

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate, int8 and bf16
# tensor-core rates, float32 rate outside the tensor cores; read from
# ``perfmodel.hw.H100_SXM`` once the package is on the path (``_peaks``).
HBM_BYTES_PER_S = INT8_OPS_PER_S = BF16_FLOPS_PER_S = F32_FLOPS_PER_S = None
L2_BYTES = 50 * 2 ** 20

ARCH = "dit-xl-512"
BUCKET = 2
SERVE_STEPS = 10
THRESHOLD = 1 << 10
AR_ARCH = "olmo-1b"
# full width in the lm phase, each with its weights' seed
LM_ARCHS = (("gemma2-9b", 22), ("gemma3-27b", 24), ("glm4-9b", 25))
GQA_ARCHS = ("gemma2-9b", "gemma3-27b", "glm4-9b")
MOE_ARCH = "deepseek-moe-16b"             # full width in the moe phase
MOE_ARCHS = ("deepseek-moe-16b", "kimi-k2-1t-a32b")
# full width in the ssm phase, and at SMOKE in reference
SSM_ARCHS = (("mamba2-370m", 26), ("hymba-1.5b", 27))
AR_STEPS = 16
AR_WINDOW = 4
# tokens of the profiled request of each LM (its trace, up to ~450k
# kernels at 16 tokens, is processed on the host after the run; 2 keeps
# the whole script inside its time limit with the train_sharded phase)
PROFILE_AR_STEPS = 2
TS_ARGS = ["--taylorseer", "--precision", "int8-body4"]
TS_KNOBS = dict(taylorseer=True, precision="int8-body4")
TS_STEPS_SMOKE, TS_EVALS_SMOKE = 7, 3       # computes steps 0, 3, 6
BASELINE_MODES = ("thundervolt", "approx_abft", "dmr", "stat_abft")
FAMILY_ARCHS = ("pixart-alpha", "sd15-unet")
# decode_step_mixed vs decode_step, gemma3-27b at full width, bf16: the
# largest |logit| difference over 16 steps past the window. 0: the rings
# are read oldest first, so the sums run in decode_step's order and the
# logits are bit-equal (measured); a ring one slot off must exceed it.
MIXED_LOGITS_LIMIT = 0.0
OFFLOAD_INTERVAL = 2        # refresh interval and stream window
STEADY_BATCHES = 2          # batches after an offload engine's first
# decode steps of the per-step timing pass of each LM (``_ar_step_ms``):
# steps 2 to 7 are timed, fewer than the requests' 16 for the time limit
STEP_MS_STEPS = 8
# profiler windows of fault_inject and its library call, median kept
FI_WINDOWS = 5
TIMERS = set()          # which timer produced the kernel times
# the kernels with a wgmma mainloop: no spill, no wgmma that ptxas
# serialized (C7518)
WGMMA_KERNELS = ("stat_abft", "drift_gemm")
ENERGY_SOURCE = "perfmodel: modeled paper accelerator, not this card"
# DiT-XL/2's parameters as Peebles & Xie, "Scalable Diffusion Models with
# Transformers" (2023), give them (~675 M), printed beside the port's count
DIT_XL2_PAPER_PARAMS = 675e6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ring_of(tensors, call_bytes: int):
    """Copies of one call's inputs, enough that cycling through them moves
    twice the L2 between two uses of one copy. Each timed call then finds
    its inputs in HBM, as on the serving path, where a GEMM's operands and
    the rollback checkpoint were last touched a layer or a step earlier."""
    n = 1 + -(-2 * L2_BYTES // max(call_bytes, 1))
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors)
                               for _ in range(n - 1)]


def _cycle(fn, ring, count: int) -> None:
    for i in range(count):
        fn(*ring[i % len(ring)])


def time_ms(fn, ring, reps: int) -> float:
    """Mean time per call of ``fn`` over ``reps`` calls cycling through
    ``ring`` (CUDA events around the loop, host launch cost included),
    after one warm-up pass over the ring."""
    import torch
    _cycle(fn, ring, len(ring))
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    _cycle(fn, ring, reps)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, ring, reps: int, name=""):
    """Device time per call of ``fn`` from ``torch.profiler``: the summed
    time of the GPU kernels whose name contains ``name`` (or any of a tuple
    of names; all kernels when empty) over ``reps`` calls cycling through
    ``ring``, after one warm-up pass over it. Unlike ``time_ms`` it
    excludes the host's launch overhead. Where the profiler sees no device time it falls back to
    ``time_ms`` and notes that in ``TIMERS``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    _cycle(fn, ring, len(ring))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _cycle(fn, ring, reps)
        torch.cuda.synchronize()
    names = (name,) if isinstance(name, str) else name
    total_us = 0.0
    for ev in prof.key_averages():
        if any(nm in ev.key for nm in names):
            total_us += getattr(ev, "self_device_time_total",
                                getattr(ev, "self_cuda_time_total", 0.0))
    if total_us > 0:
        TIMERS.add("torch.profiler")
        return total_us / 1e3 / reps
    TIMERS.add("cuda events (profiler saw no device time)")
    return time_ms(fn, ring, reps)


def _peaks() -> None:
    """The card's peaks from ``perfmodel.hw.H100_SXM``."""
    global HBM_BYTES_PER_S, INT8_OPS_PER_S, BF16_FLOPS_PER_S, \
        F32_FLOPS_PER_S
    from repro_torch.perfmodel.hw import H100_SXM as hw
    HBM_BYTES_PER_S = hw.hbm_bytes_per_s
    INT8_OPS_PER_S = hw.peak_ops_int8
    BF16_FLOPS_PER_S = hw.peak_flops_bf16
    F32_FLOPS_PER_S = hw.peak_flops_f32


def flops_per_s(dtype) -> float:
    """The card's peak rate for attention's products in ``dtype``."""
    import torch
    return BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S


def tflops(flops: float, ms) -> float:
    """Achieved TFLOP/s of ``flops`` done in ``ms``."""
    return flops / (ms * 1e-3) / 1e12 if ms else None


def ptxas_summary(log: str):
    """Registers and spill bytes per kernel from ``nvcc -Xptxas=-v``."""
    import re
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            out.append(dict(function=name))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and out:
            out[-1].update(spill_stores=int(m.group(1)),
                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    return out


def kernel_names(fn, args):
    """The device kernels one call ``fn(*args)`` runs (``torch.profiler``),
    so a yardstick's row says which implementation the library took."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    return sorted({ev.key[:100] for ev in prof.key_averages()
                   if getattr(ev, "self_device_time_total",
                              getattr(ev, "self_cuda_time_total", 0)) > 0})


def max_abs_err(got, want) -> float:
    """Largest |got - want| over paired outputs (0 when all are equal)."""
    return max(float((a.double() - b.double()).abs().max())
               for a, b in zip(got, want))


def path_gemms(cfg, bucket: int):
    """(name, M, K, N, launches per DiT evaluation, unpadded (M, N)) of the
    protected GEMMs, M and N padded to the 32x32 checksum tile as the
    kernels see them."""
    def pad(x):
        return -(-x // 32) * 32
    m = bucket * cfg.tokens
    d, f, pdim = cfg.d_model, cfg.d_ff, cfg.patch_dim
    hd = cfg.n_heads * cfg.hd
    L = cfg.n_layers
    return [("patch", m, pdim, d, 1, (m, d)),
            ("t.w1", pad(bucket), 256, d, 1, (bucket, d)),
            ("t.w2", pad(bucket), d, d, 1, (bucket, d)),
            ("attn.qkvo", m, d, hd, 4 * L, (m, hd)),
            ("mlp.w1", m, d, f, L, (m, f)), ("mlp.w2", m, f, d, L, (m, d)),
            ("final", m, d, pad(pdim), 1, (m, pdim))]


def decode_gemms(cfg, batch: int):
    """(name, M, K, N, launches per layer and step, unpadded (M, N)) of a
    ``DriftDecode`` step's protected projections: M = batch, padded to one
    32-row tile."""
    mp = -(-batch // 32) * 32
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.hd
    kvd = cfg.n_kv_heads * cfg.hd
    rows = [("attn.q", mp, d, hd, 1, (batch, hd)),
            ("attn.k/v", mp, d, kvd, 2, (batch, kvd)),
            ("attn.o", mp, hd, d, 1, (batch, d)),
            ("mlp.gate/up", mp, d, f, 2, (batch, f)),
            ("mlp.down", mp, f, d, 1, (batch, d))]
    if hd == kvd:                                   # q, k, v alike
        rows[:2] = [("attn.q/k/v", mp, d, hd, 3, (batch, hd))]
    return rows


def _abft_rb_rows(torch, g, src, site, name, mkn, valid, reps):
    """``abft_matmul`` and ``rollback_correct`` at one GEMM shape, held
    bit-equal to their plain versions and timed; (abft row, rollback
    row). Inputs outside ``valid`` are zero, as the path pads them."""
    from repro_torch.core.abft import _exceeds
    from repro_torch.kernels import abft_matmul as ak
    from repro_torch.kernels import rollback_correct as rk
    dev = torch.device("cuda")
    m, k, n = mkn
    vm, vn = valid
    aq = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                       dtype=torch.int8)
    bq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                       dtype=torch.int8)
    flips = src(site, (m, n), 3e-3)
    flips[vm // 2, vn // 3] = -2 ** 31              # one bit-31 flip
    aq[vm:] = 0
    bq[:, vn:] = 0
    flips[vm:] = 0
    flips[:, vn:] = 0
    got = ak.abft_matmul(aq, bq, flips)
    want = ak.abft_matmul_plain(aq, bq, flips)
    torch.cuda.synchronize()
    for label, a, b in zip(("c", "act_row", "exp_row", "act_col",
                            "exp_col"), got, want):
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"abft_matmul {name} ({m}x{k}x{n}): "
                                 f"{label} differs in {bad} elements")
    work = ak.work(m, k, n)
    bytes_, ops = work["bytes"], work["int8_ops"]
    t_b, t_o = bytes_ / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    ring = ring_of((aq, bq, flips), bytes_)
    try:
        int_mm = device_ms(torch._int_mm, [r[:2] for r in ring], reps)
    except RuntimeError:                           # shape it does not take
        int_mm = None
    a_row = dict(name=name, m=m, k=k, n=n, valid=list(valid),
                 max_abs_err=max_abs_err(got, want), ring=len(ring),
                 ms=device_ms(ak.abft_matmul, ring, reps, "abft_matmul"),
                 wall_ms=time_ms(ak.abft_matmul, ring, reps),
                 plain_ms=device_ms(ak.abft_matmul_plain, ring,
                                    max(1, reps // 4)),
                 bound_ms=1e3 * max(t_b, t_o),
                 bound_by="bytes" if t_b >= t_o else "operations",
                 int_mm_ms=int_mm,
                 flagged_rows=int(_exceeds(got[1] - got[2],
                                           THRESHOLD).sum()))
    a_row.update(tops=2 * m * n * k / (a_row["ms"] * 1e-3) / 1e12,
                 int_mm_ratio=a_row["ms"] / int_mm if int_mm else None)
    del ring

    rd = got[1] - got[2]
    cd = got[3] - got[4]
    c = got[0].float() * 1e-4
    ckpt = torch.randn((m, n), generator=g, device=dev)
    ckpt[vm:] = 0
    ckpt[:, vn:] = 0
    err = 0.0
    for union in (True, False):
        a = rk.rollback_correct(c, ckpt, rd, cd, THRESHOLD, union=union,
                                valid=valid)
        b = rk.rollback_correct_plain(c, ckpt, rd, cd, THRESHOLD,
                                      union=union, valid=valid)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(a, b))
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"rollback_correct {name} union={union}"
                                 " differs from its plain version")
    rbytes = rk.work(m, n)["bytes"]
    ring = ring_of((c, ckpt, rd, cd), rbytes)

    def rb(c_, ck_, rd_, cd_):
        return rk.rollback_correct(c_, ck_, rd_, cd_, THRESHOLD, valid=valid)

    def rb_plain(c_, ck_, rd_, cd_):
        return rk.rollback_correct_plain(c_, ck_, rd_, cd_, THRESHOLD,
                                         valid=valid)
    r_row = dict(name=name, m=m, n=n, valid=list(valid), max_abs_err=err,
                 ring=len(ring),
                 ms=device_ms(rb, ring, reps, "rollback_correct"),
                 wall_ms=time_ms(rb, ring, reps),
                 plain_ms=device_ms(rb_plain, ring, reps),
                 bound_ms=1e3 * rbytes / HBM_BYTES_PER_S, bound_by="bytes",
                 masked_elems=int(a[1].sum()))
    del ring
    return a_row, r_row


# ---------------------------------------------------------------- phases
def phase_kernels(torch, reps: int):
    from repro_torch.configs import get_config
    from repro_torch.core import fault
    from repro_torch.kernels import flash_attention as fk

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(ARCH)
    g = torch.Generator(device=dev)
    g.manual_seed(20261016)
    src = fault.PhiloxFlipSource(base_seed=7, batch_index=0, device=dev)
    abft_rows, rb_rows = [], []
    for i, (name, m, k, n, per_eval, valid) in enumerate(
            path_gemms(cfg, BUCKET)):
        a_row, r_row = _abft_rb_rows(torch, g, src,
                                     fault.FaultSite(0, i, name), name,
                                     (m, k, n), valid, reps)
        abft_rows.append(dict(a_row, per_eval=per_eval))
        rb_rows.append(dict(r_row, per_eval=per_eval))
    emit({"phase": "kernels", "kernel": "abft_matmul", "bit_equal": True,
          "shapes": abft_rows,
          "note": "int_mm_ms is torch._int_mm, the bare int8 product: a "
                  "yardstick, not the same function; int_mm_ratio is "
                  "ms / int_mm_ms; tops is the achieved int8 rate of the "
                  "product (2*M*N*K over ms)"})
    emit({"phase": "kernels", "kernel": "rollback_correct",
          "bit_equal": True, "policies": ["union", "cross"],
          "shapes": rb_rows})

    import torch.nn.functional as F
    from repro_torch.models.attention import full_attention
    # The DiT block's call: mha_flash on q, k, v each a (B*T, H*hd)
    # projection reshaped to (B, T, H, hd), so token stride H*hd and head
    # stride hd, read in place.
    b, s, h, d = BUCKET, cfg.tokens, cfg.n_heads, cfg.hd
    fl_rows = {}

    def plain(q_, k_, v_):
        return full_attention(q_, k_, v_, causal=False)
    # bf16 at 1e-2: typical |o| is ~0.04 here (softmax over 1024 keys
    # averages v), so the Pallas test's 3e-2 would leave room for a lost
    # key tile.
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 2e-5)):
        q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev
                               ).to(dtype) for _ in range(3))
        got = fk.mha_flash(q, k, v)
        want = plain(q, k, v)
        # The (BH, S, D) entry point, the case H = 1, on folded copies.
        fold = [x.transpose(1, 2).reshape(b * h, s, d) for x in (q, k, v)]
        got_bh = fk.flash_attention(*fold).view(b, h, s, d).transpose(1, 2)
        torch.cuda.synchronize()
        err = max_abs_err([got], [want])
        err_bh = max_abs_err([got_bh], [want])
        for label, out in (("mha_flash", got), ("flash_attention", got_bh)):
            if not torch.allclose(out.float(), want.float(), atol=tol,
                                  rtol=tol):
                raise AssertionError(
                    f"{label} {dtype} at {(b, s, h, d)}: max abs err "
                    f"{max_abs_err([out], [want])} beyond {tol}")
        work = fk.work(b, s, h, h, d, q.element_size())
        flops, bytes_ = work["flops"], work["bytes"]
        t_o, t_b = flops / flops_per_s(dtype), bytes_ / HBM_BYTES_PER_S
        ring = ring_of((q, k, v), bytes_)
        # SDPA on (B, H, S, D) transposed views of the same inputs.
        lib_ring = [tuple(x.transpose(1, 2) for x in r) for r in ring]
        bh_ring = ring_of(fold, bytes_)
        row = dict(
            shape=[b, s, h, d], tol=tol, max_abs_err=err,
            rel_l2_err=float((got.double() - want.double()).norm()
                             / want.double().norm()),
            ring=len(ring),
            ms=device_ms(fk.mha_flash, ring, reps),
            kernel_ms=device_ms(fk.mha_flash, ring, reps,
                                "flash_attention"),
            wall_ms=time_ms(fk.mha_flash, ring, reps),
            plain_ms=device_ms(plain, ring, reps),
            library_ms=device_ms(F.scaled_dot_product_attention, lib_ring,
                                 reps),
            bh_max_abs_err=err_bh,
            bh_ms=device_ms(fk.flash_attention, bh_ring, reps,
                            "flash_attention"),
            bound_ms=1e3 * max(t_o, t_b),
            bound_by="operations" if t_o >= t_b else "bytes")
        row.update(tflops=tflops(flops, row["ms"]),
                   library_tflops=tflops(flops, row["library_ms"]),
                   library_kernels=kernel_names(
                       F.scaled_dot_product_attention, lib_ring[0]))
        fl_rows[str(dtype).split(".")[-1]] = row
        del ring, lib_ring, bh_ring, fold
    emit({"phase": "kernels", "timers": sorted(TIMERS)})
    emit({"phase": "kernels", "kernel": "flash_attention",
          "per_eval": cfg.n_layers, "dtypes": fl_rows,
          "note": "the DiT's call: mha_flash on (B, T, H, hd) reshaped "
                  "projections, token stride H*hd; ms is every kernel of "
                  "the call, kernel_ms the attention kernel alone; bh_ms "
                  "and bh_max_abs_err are the (BH, S, D) entry point "
                  "flash_attention on folded copies; library_ms is "
                  "F.scaled_dot_product_attention on (B, H, S, D) "
                  "transposed views in the row's dtype; bound_ms takes the "
                  "bf16 tensor-core rate (989 TFLOP/s) for bf16 and the "
                  "f32 rate (67) for f32; tflops is achieved; tolerance vs "
                  "the plain full_attention (p in f32): 2e-5 f32 "
                  "(summation order), 1e-2 bf16 (p and output rounded to "
                  "bf16; typical |o| ~0.04)"})
    return abft_rows, rb_rows, fl_rows


def _check_equal(label, got, want) -> float:
    """Every output bit-equal (f32 compared on its int32 view, so NaN and
    -0 count too); returns ``max_abs_err`` over those views."""
    import torch
    views = [[t.view(torch.int32) if t.dtype == torch.float32 else t
              for t in ts] for ts in (got, want)]
    for i, (a, b) in enumerate(zip(*views)):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: output {i} differs from its "
                                 "plain version")
    return max_abs_err(*views)


def phase_kernels_ar(torch, reps: int):
    """The autoregressive slice's kernel and composites on the card."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core import fault, quant
    from repro_torch.kernels import fault_inject as fik
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops
    from repro_torch.kernels import abft_matmul as ak
    from repro_torch.kernels import stat_abft as sk
    from repro_torch.models.attention import full_attention
    from repro_torch.serving.ar import PROMPT_LEN

    dev = torch.device("cuda")
    cfg = get_config(AR_ARCH)
    g = torch.Generator(device=dev)
    g.manual_seed(20261017)
    src = fault.PhiloxFlipSource(base_seed=9, batch_index=0, device=dev)

    # fault_inject: a decode step's 5 GEMM outputs of width d and 2 of
    # width d_ff, and one large int32 array where bytes bind.
    fi_rows = []
    for i, (name, shape, dtype, per_step) in enumerate((
            ("attn.q/k/v/o, mlp.down", (BUCKET, 1, cfg.d_model),
             torch.float32, 5),
            ("mlp.gate/up", (BUCKET, 1, cfg.d_ff), torch.float32, 2),
            ("large int32", (8192, 8192), torch.int32, 0))):
        if dtype == torch.float32:
            x = torch.randn(shape, generator=g, device=dev)
        else:
            x = torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=g,
                              device=dev, dtype=torch.int32)
        mask = src(fault.FaultSite(1, i, name), shape, 3e-3)
        mask.view(-1)[0] = -2 ** 31                   # one bit-31 flip
        got = fik.fault_inject(x, mask)
        torch.cuda.synchronize()
        err = _check_equal(f"fault_inject {shape}", [got],
                           [fik.fault_inject_plain(x, mask)])
        n = x.numel()
        ring = ring_of((x, mask), 12 * n)
        # 10x the launches: at ~1.4 us a call, 20 leave the kernel and
        # torch.bitwise_xor within noise of each other.
        fr = 10 * reps

        def xor(a, m):
            return torch.bitwise_xor(a.view(torch.int32), m)
        # the kernel and the library call each the median of
        # FI_WINDOWS profiler windows, taken in turns
        windows = {"ms": [], "library_ms": []}
        for _ in range(FI_WINDOWS):
            windows["ms"].append(device_ms(fik.fault_inject, ring, fr,
                                           "fault_inject"))
            windows["library_ms"].append(device_ms(xor, ring, fr))
        fi_rows.append(dict(
            name=name, shape=list(shape), dtype=str(dtype).split(".")[-1],
            per_step=per_step, max_abs_err=err, ring=len(ring),
            ms=statistics.median(windows["ms"]),
            wall_ms=time_ms(fik.fault_inject, ring, fr),
            plain_ms=device_ms(fik.fault_inject_plain, ring, fr),
            library_ms=statistics.median(windows["library_ms"]),
            windows=windows,
            spread={k: max(v) / min(v) for k, v in windows.items()},
            bound_ms=1e3 * fik.work(n)["bytes"] / HBM_BYTES_PER_S,
            bound_by="bytes"))
        fi_rows[-1]["library_ratio"] = fi_rows[-1]["ms"] / \
            fi_rows[-1]["library_ms"]
        del ring
    emit({"phase": "kernels", "kernel": "fault_inject", "bit_equal": True,
          "shapes": fi_rows,
          "note": "library_ms is torch.bitwise_xor on the int32 views; the "
                  "plain version is the same xor; library_ratio is "
                  "ms / library_ms; ms and library_ms are each the median "
                  f"of {FI_WINDOWS} profiler windows taken in turns "
                  "(windows), spread the largest over the smallest"})

    # The prefill's attention call: (B, 8, H, 128), causal.
    b, s, h, d = BUCKET, PROMPT_LEN, cfg.n_heads, cfg.hd
    mha_rows = {}
    for dtype, tol in ((torch.bfloat16, 3e-2), (torch.float32, 2e-5)):
        q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev
                               ).to(dtype) for _ in range(3))
        got = fk.mha_flash(q, k, v, causal=True)
        want = full_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = max_abs_err([got], [want])
        if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
            raise AssertionError(f"mha_flash {dtype} at {(b, s, h, d)}: max "
                                 f"abs err {err} beyond {tol}")
        work = fk.work(b, s, h, h, d, q.element_size(), causal=True)
        flops = work["flops"]
        t_o = flops / flops_per_s(dtype)
        t_b = work["bytes"] / HBM_BYTES_PER_S
        ring = ring_of((q, k, v), 4 * q.numel() * q.element_size())
        lib_ring = [tuple(x.transpose(1, 2) for x in r) for r in ring]

        def mha(q_, k_, v_):
            return fk.mha_flash(q_, k_, v_, causal=True)

        def plain(q_, k_, v_):
            return full_attention(q_, k_, v_, causal=True)

        def sdpa(q_, k_, v_):
            return F.scaled_dot_product_attention(q_, k_, v_, is_causal=True)
        row = dict(
            shape=[b, s, h, d], tol=tol, max_abs_err=err, ring=len(ring),
            ms=device_ms(mha, ring, reps),
            kernel_ms=device_ms(mha, ring, reps, "flash_attention"),
            wall_ms=time_ms(mha, ring, reps),
            plain_ms=device_ms(plain, ring, reps),
            library_ms=device_ms(sdpa, lib_ring, reps),
            bound_ms=1e3 * max(t_o, t_b),
            bound_by="operations" if t_o >= t_b else "bytes")
        row.update(tflops=tflops(flops, row["ms"]),
                   library_tflops=tflops(flops, row["library_ms"]),
                   library_kernels=kernel_names(sdpa, lib_ring[0]))
        mha_rows[str(dtype).split(".")[-1]] = row
        del ring, lib_ring
    emit({"phase": "kernels", "kernel": "mha_flash", "rows": mha_rows,
          "note": "ms is every kernel of the call, kernel_ms the attention "
                  "kernel alone (equal: the call launches one kernel on the "
                  "(B, S, H, D) inputs in place); library_ms is "
                  "F.scaled_dot_product_attention(is_causal=True) on "
                  "(B, H, S, D) transposed views, in the row's dtype"})

    # stat_abft_matmul's kernel at the DiT's body shapes, timed, and at a
    # short M, K % 16 != 0 and row tiles with and without an instance of
    # their own (96 to 384: the 32-wide instance's residuals summed by a
    # second launch), held bit-equal.
    stat_shapes = []
    for m, kk, n, bn in ((2048, 1152, 1152, 128), (2048, 1152, 4608, 128),
                         (2048, 4608, 1152, 128), (32, 1152, 1152, 64),
                         (96, 50, 384, 32), (64, 1152, 3840, 96),
                         (64, 1152, 3840, 160), (64, 1152, 3840, 256),
                         (64, 1152, 3840, 384)):
        aq = torch.randint(-127, 128, (m, kk), generator=g, device=dev,
                           dtype=torch.int8)
        bq = torch.randint(-127, 128, (kk, n), generator=g, device=dev,
                           dtype=torch.int8)
        flips = src(fault.FaultSite(2, len(stat_shapes), "stat"), (m, n),
                    3e-3)
        flips[7, 9] = -2 ** 31                        # one bit-31 flip
        bm = 32 if m % bn else bn
        err = 0.0
        for thr in (0, THRESHOLD):
            got = sk.stat_abft_matmul(aq, bq, flips, thr, bm=bm, bn=bn)
            want = sk.stat_abft_matmul_plain(aq, bq, flips, thr, bm=bm,
                                             bn=bn)
            torch.cuda.synchronize()
            err = max(err, _check_equal(
                f"stat_abft_matmul {m}x{kk}x{n} bn {bn} threshold {thr}",
                got, want))
        row = dict(shape=[m, kk, n], bn=bn, threshold_mag=THRESHOLD,
                   flagged=int(got[1].sum()), max_abs_err=err)
        if m == 2048:
            work = sk.work(m, kk, n, bn)
            sbytes, sops = work["bytes"], work["int8_ops"]
            ring = ring_of((aq, bq, flips), sbytes)

            def stat(a, b_, f):
                return sk.stat_abft_matmul(a, b_, f, THRESHOLD, bm=bn, bn=bn)

            def stat_plain(a, b_, f):
                return sk.stat_abft_matmul_plain(a, b_, f, THRESHOLD, bm=bn,
                                                 bn=bn)

            def composite(a, b_, f):
                return sk._stat_abft(ak.abft_matmul, a, b_, f, THRESHOLD,
                                     bn, bn)

            t_b, t_o = sbytes / HBM_BYTES_PER_S, sops / INT8_OPS_PER_S
            # the call and the composite in turns (call, composite,
            # composite, call), each side's faster window kept: one
            # window can read several times slow on the card
            turns = [device_ms(fn, ring, reps)
                     for fn in (stat, composite, composite, stat)]
            row.update(
                ring=len(ring), ms=min(turns[0], turns[3]),
                ms_turns=[turns[0], turns[3]],
                kernel_ms=device_ms(stat, ring, reps, "stat_abft_kernel"),
                transpose_ms=device_ms(stat, ring, reps, "transpose_kernel"),
                wall_ms=time_ms(stat, ring, reps),
                plain_ms=device_ms(stat_plain, ring, max(1, reps // 4)),
                composite_ms=min(turns[1], turns[2]),
                composite_ms_turns=turns[1:3],
                bound_ms=1e3 * max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations",
                library_ms=None)
            row.update(tops=2 * m * n * kk / (row["kernel_ms"] * 1e-3) / 1e12,
                       share=row["bound_ms"] / row["ms"])
            del ring
            if not row["ms"] < row["composite_ms"]:
                raise AssertionError(f"stat_abft_matmul {m}x{kk}x{n}: "
                                     f"{row['ms']} ms, not below the "
                                     f"composite's {row['composite_ms']}")
        stat_shapes.append(row)
    stat_row = dict(stat_shapes[0], shapes=stat_shapes)
    emit({"phase": "kernels", "kernel": "stat_abft_matmul",
          "bit_equal": True, "shapes": stat_shapes,
          "note": "ms is every kernel of the call (the transpose of B "
                  "included), kernel_ms the wgmma kernel alone, "
                  "transpose_ms the transpose; composite_ms the "
                  "design it replaced (_stat_abft over abft_matmul); ms "
                  "and composite_ms the faster of two windows each, taken "
                  "in turns (ms_turns, composite_ms_turns); tops "
                  "the kernel's int8 rate (2*M*N*K over kernel_ms); share "
                  "bound_ms / ms; bit-equal at thresholds 0 and "
                  f"{THRESHOLD}"})

    m, kk, n = 2048, 1152, 1152
    x = torch.randn((m, kk), generator=g, device=dev)
    w = torch.randn((kk, n), generator=g, device=dev) / kk ** 0.5
    ckpt = torch.randn((m, n), generator=g, device=dev)
    dflips = src(fault.FaultSite(2, 1, "drift"), ops.padded_shape(m, n),
                 3e-3)
    got = ops.drift_gemm(x, w, ckpt, dflips)
    want = ops.drift_gemm_plain(x, w, ckpt, dflips)
    torch.cuda.synchronize()
    err = _check_equal("drift_gemm", got, want)
    # the kernel's work on the quantized operands, with the checkpoint
    # read where this run's masks need it, and x, w read as f32
    xq, wq = quant.quantize(x, axis=None), quant.quantize(w, axis=1)
    masked = int(ops.drift_gemm_fused(xq.q, wq.q, dflips, xq.scale,
                                      wq.scale.reshape(-1), ckpt, THRESHOLD,
                                      valid=(m, n))[3].sum())
    work = ops.work(m, kk, n, flip_words=dflips.numel(), ckpt_reads=masked)
    dbytes = work["bytes"] + 3 * (m * kk + kk * n)
    dops = work["int8_ops"]
    t_b, t_o = dbytes / HBM_BYTES_PER_S, dops / INT8_OPS_PER_S
    ring = ring_of((x, w, ckpt, dflips), dbytes)
    drift_row = dict(shape=[m, kk, n], flagged_tiles=int(got.n_flagged_tiles),
                     max_abs_err=err, ring=len(ring),
                     ms=device_ms(ops.drift_gemm, ring, reps),
                     kernel_ms=device_ms(ops.drift_gemm, ring, reps,
                                         ("drift_gemm_kernel",
                                          "transpose_kernel")),
                     wall_ms=time_ms(ops.drift_gemm, ring, reps),
                     plain_ms=device_ms(ops.drift_gemm_plain, ring,
                                        max(1, reps // 4)),
                     bound_ms=1e3 * max(t_b, t_o),
                     bound_by="bytes" if t_b >= t_o else "operations",
                     library_ms=None)
    del ring
    emit({"phase": "kernels", "kernel": "drift_gemm", "bit_equal": True,
          **drift_row,
          "note": "ms is every kernel of the composite (the quantization "
                  "included); kernel_ms the two kernels of its "
                  "drift_gemm_fused call (the transpose of B and the "
                  "wgmma kernel)"})

    # DriftDecode's projections: 2 valid rows in one 32-row tile.
    dd_abft, dd_rb = [], []
    for i, (name, m, k, n, per_layer, valid) in enumerate(
            decode_gemms(cfg, BUCKET)):
        a_row, r_row = _abft_rb_rows(torch, g, src,
                                     fault.FaultSite(3, i, name), name,
                                     (m, k, n), valid, reps)
        dd_abft.append(dict(a_row, per_layer=per_layer))
        dd_rb.append(dict(r_row, per_layer=per_layer))
    for kernel, rows in (("abft_matmul", dd_abft),
                         ("rollback_correct", dd_rb)):
        emit({"phase": "kernels", "kernel": kernel, "bit_equal": True,
              "path": "ar+drift", "shapes": rows,
              "note": f"DriftDecode's {AR_ARCH} projections at bucket "
                      f"{BUCKET}: valid rows {BUCKET} of a 32-row tile, "
                      "the rest zero as the path pads them"})
    return fi_rows, mha_rows, stat_row, drift_row, (dd_abft, dd_rb)


# (label, M, K, N) unpadded, as the fused kernel takes them: the GEMMs the
# PixArt and UNet drift paths add to the DiT's, at PixArt's M = 240 (120
# text tokens) and the UNet's M = 154 (77), each of bucket 2.
FUSED_FAMILY_GEMMS = (("pixart text", 240, 4096, 1152),
                      ("pixart xattn.k/v", 240, 1152, 1152),
                      ("unet cross.k/v 640", 154, 768, 640),
                      ("unet cross.k/v 1280", 154, 768, 1280))


def _fused_row(torch, g, src, site, name, mkn, reps):
    """``drift_gemm_fused`` at one unpadded GEMM shape: every output
    bit-equal to its plain version at BER 3e-3 plus a bit-31 flip (union
    with a checkpoint; cross without one) and at BER 0 (no mask, union,
    with a checkpoint); then timed in the first setting. The bound counts
    the checkpoint's reads where this run's mask needs them."""
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    m, k, n = mkn
    aq = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                       dtype=torch.int8)
    bq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                       dtype=torch.int8)
    flips = src(site, (m, n), 3e-3)
    flips[m // 2, n // 3] = -2 ** 31
    sx = torch.rand((), generator=g, device=dev) * 1e-2 + 1e-3
    sw = torch.rand((n,), generator=g, device=dev) * 1e-2 + 1e-3
    ckpt = torch.randn((m, n), generator=g, device=dev)
    err, counts = 0.0, {}
    for label, fl, ck, union in (("union", flips, ckpt, True),
                                 ("cross", flips, None, False),
                                 ("ber 0", None, ckpt, True)):
        got = ops.drift_gemm_fused(aq, bq, fl, sx, sw, ck, THRESHOLD,
                                   union=union, valid=(m, n))
        want = ops.drift_gemm_fused_plain(aq, bq, fl, sx, sw, ck, THRESHOLD,
                                          union=union, valid=(m, n))
        torch.cuda.synchronize()
        err = max(err, _check_equal(f"drift_gemm_fused {name} ({m}x{k}x{n})"
                                    f" {label}", got, want))
        counts[label] = got[3]
    if int(counts["ber 0"].sum()) != 0:
        raise AssertionError(f"drift_gemm_fused {name}: masks at BER 0")
    masked = int(counts["union"].sum())
    work = ops.work(m, k, n, flip_words=m * n, ckpt_reads=masked)
    bytes_, iops = work["bytes"], work["int8_ops"]
    t_b, t_o = bytes_ / HBM_BYTES_PER_S, iops / INT8_OPS_PER_S
    ring = ring_of((aq, bq, flips, sx, sw, ckpt), bytes_ + 4 * m * n)

    def fused(a, b, f, x, w, c):
        return ops.drift_gemm_fused(a, b, f, x, w, c, THRESHOLD,
                                    valid=(m, n))

    def plain(a, b, f, x, w, c):
        return ops.drift_gemm_fused_plain(a, b, f, x, w, c, THRESHOLD,
                                          valid=(m, n))
    kp, splits, slabs = ops.launch_plan(m, k, n)
    in_place = ops.reads_b_in_place(m, bq)
    row = dict(name=name, m=m, k=k, n=n, kp=kp, splits=splits,
               b_in_place=in_place,
               max_abs_err=err, masked_elems=masked,
               flagged_tiles=int((counts["union"] > 0).sum()),
               ring=len(ring),
               ms=device_ms(fused, ring, reps),
               kernel_ms=device_ms(fused, ring, reps, "drift_gemm_kernel"),
               transpose_ms=(0.0 if in_place else device_ms(
                   fused, ring, reps, "transpose_kernel")),
               wall_ms=time_ms(fused, ring, reps),
               plain_ms=device_ms(plain, ring, max(1, reps // 4)),
               bound_ms=1e3 * max(t_b, t_o),
               bound_by="bytes" if t_b >= t_o else "operations",
               library_ms=None)
    row.update(tops=2 * m * n * k / (row["kernel_ms"] * 1e-3) / 1e12,
               share=row["bound_ms"] / row["ms"])
    del ring
    return row


def phase_kernels_fused(torch, reps: int):
    """``drift_gemm_fused`` at the drift paths' shapes (``_fused_row``):
    the DiT's seven GEMMs (``path_gemms``, unpadded), PixArt's and the
    UNet's text GEMMs (``FUSED_FAMILY_GEMMS``) and ``DriftDecode``'s
    olmo-1b projections at M = 2 (``decode_gemms``). Returns the three
    lists of rows."""
    from repro_torch.configs import get_config
    from repro_torch.core import fault
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(20261018)
    src = fault.PhiloxFlipSource(base_seed=10, batch_index=0, device=dev)
    dit_rows, fam_rows, dd_rows = [], [], []
    for i, (name, _, k, _, per_eval, (m, n)) in enumerate(
            path_gemms(get_config(ARCH), BUCKET)):
        dit_rows.append(dict(_fused_row(
            torch, g, src, fault.FaultSite(4, i, name), name, (m, k, n),
            reps), per_eval=per_eval))
    for i, (name, m, k, n) in enumerate(FUSED_FAMILY_GEMMS):
        fam_rows.append(_fused_row(torch, g, src,
                                   fault.FaultSite(5, i, name), name,
                                   (m, k, n), reps))
    for i, (name, _, k, _, per_layer, (m, n)) in enumerate(
            decode_gemms(get_config(AR_ARCH), BUCKET)):
        dd_rows.append(dict(_fused_row(
            torch, g, src, fault.FaultSite(6, i, name), name, (m, k, n),
            reps), per_layer=per_layer))
    emit({"phase": "kernels", "kernel": "drift_gemm_fused",
          "bit_equal": True,
          "settings": ["BER 3e-3 union + ckpt", "BER 3e-3 cross",
                       "BER 0 union + ckpt"],
          "shapes": dit_rows, "family_shapes": fam_rows,
          "decode_shapes": dd_rows,
          "note": "unpadded (M, K, N) as the drift paths give them; ms is "
                  "the call's device time (the transpose of B to K-major "
                  "and the wgmma kernel), kernel_ms and transpose_ms each "
                  "alone (transpose_ms 0 where the kernel reads B in "
                  "place, b_in_place: M <= 64), timed in the first "
                  "setting; tops the kernel's "
                  "int8 rate (2*M*N*K over kernel_ms); share bound_ms / "
                  "ms; splits the CTAs along K a tile (ops.launch_plan); "
                  "bound_ms counts the checkpoint where the run's masks "
                  "read it; no PyTorch call computes this function"})
    return dit_rows, fam_rows, dd_rows


# (label, M, K, N) of the single-flip sweep: a DiT body GEMM at M > 64
# (``drift_gemm_fused`` transposes B and runs the wgmma mainloop whole),
# and M = 2, DriftDecode's rows, at K = 4608 (B read in place, K split
# over several CTAs of several slabs each)
FLIP_SHAPES = (("dit body, M > 64", 2048, 1152, 1152),
               ("M = 2, K = 4608: split K", 2, 4608, 1152))
FLIP_BITS = range(32)


def _flip_positions(m: int, n: int):
    """(0, 0), a tile corner, the next tile's first element and the last
    valid element, rows clipped to M."""
    return [(0, 0), (min(31, m - 1), 31), (min(32, m - 1), 32),
            (m - 1, n - 1)]


def phase_kernels_flips(torch):
    """Single-bit flips through the three ABFT kernels on the card: for
    each of ``FLIP_SHAPES``, each of four positions and every bit, a
    one-hot mask from ``fault.inject_at`` on a zero int32 mask on the
    card; each launch ``torch.equal`` (f32 on its int32 view) to its
    plain version on the same inputs, the unflipped operands made once.
    ``abft_matmul`` and ``drift_gemm_fused`` must flag iff ``bit >=
    threshold_bit`` (10), in the flipped element's tile row and column
    (``drift_gemm_fused``: its tile alone, the masked elements the
    checkpoint's); ``stat_abft_matmul``'s threshold is statistical, so
    its flagged bits are printed, not gated. abft_matmul and
    stat_abft_matmul take M padded to the 32-row tile, as the paths pad
    it. One line per kernel; returns the lines."""
    from repro_torch.core import fault
    from repro_torch.core.abft import _exceeds, wrap_i32
    from repro_torch.kernels import abft_matmul as ak
    from repro_torch.kernels import ops
    from repro_torch.kernels import stat_abft as sk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(20261019)
    thr_bit = THRESHOLD.bit_length() - 1
    t0 = time.perf_counter()
    rows = {"abft_matmul": [], "drift_gemm_fused": [],
            "stat_abft_matmul": []}
    before = dict(abft_matmul=ak.launches, drift_gemm_fused=ops.launches,
                  stat_abft_matmul=sk.launches)

    for label, m, k, n in FLIP_SHAPES:
        mp = -(-m // 32) * 32
        aq = torch.zeros((mp, k), dtype=torch.int8, device=dev)
        aq[:m] = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                               dtype=torch.int8)
        bq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                           dtype=torch.int8)
        sx = torch.rand((), generator=g, device=dev) * 1e-2 + 1e-3
        sw = torch.rand((n,), generator=g, device=dev) * 1e-2 + 1e-3
        ckpt = torch.randn((m, n), generator=g, device=dev)
        zero_p = torch.zeros((mp, n), dtype=torch.int32, device=dev)
        zero = torch.zeros((m, n), dtype=torch.int32, device=dev)
        bn = 128 if m > 64 else 32
        kp, splits, slabs = ops.launch_plan(m, k, n)
        flagged = {name: set() for name in rows}
        for i, j in _flip_positions(m, n):
            for bit in FLIP_BITS:
                tag = f"{label} ({i}, {j}) bit {bit}"
                big = bit >= thr_bit
                # abft_matmul: the per-tile differences flag the flipped
                # element's tile row and column, and nothing else
                fl = fault.inject_at(zero_p, i * n + j, bit)
                got = ak.abft_matmul(aq, bq, fl)
                _check_equal(f"abft_matmul {tag}", got,
                             ak.abft_matmul_plain(aq, bq, fl))
                rf = _exceeds(wrap_i32(got[1].long() - got[2].long()),
                              THRESHOLD)
                cf = _exceeds(wrap_i32(got[3].long() - got[4].long()),
                              THRESHOLD)
                want_r = torch.zeros_like(rf)
                want_c = torch.zeros_like(cf)
                want_r[i, j // 32] = want_c[i // 32, j] = big
                if not (torch.equal(rf, want_r) and torch.equal(cf, want_c)):
                    raise AssertionError(f"abft_matmul {tag}: flags "
                                         f"{int(rf.sum())}/{int(cf.sum())}")
                if big:
                    flagged["abft_matmul"].add(bit)
                # drift_gemm_fused, unpadded as the drift paths call it
                fl = fault.inject_at(zero, i * n + j, bit)
                args = (aq[:m], bq, fl, sx, sw, ckpt, THRESHOLD)
                got = ops.drift_gemm_fused(*args, valid=(m, n))
                _check_equal(f"drift_gemm_fused {tag}", got,
                             ops.drift_gemm_fused_plain(*args, valid=(m, n)))
                count = got[3]
                want_t = torch.zeros_like(count, dtype=torch.bool)
                want_t[i // 32, j // 32] = big
                if not torch.equal(count > 0, want_t):
                    raise AssertionError(f"drift_gemm_fused {tag}: "
                                         f"{int((count > 0).sum())} tiles")
                if big:
                    flagged["drift_gemm_fused"].add(bit)
                    if not torch.equal(got[0][i, j], ckpt[i, j]):
                        raise AssertionError(f"drift_gemm_fused {tag}: "
                                             "not rolled back")
                # stat_abft_matmul: its flags printed, not gated
                fl = fault.inject_at(zero_p, i * n + j, bit)
                got = sk.stat_abft_matmul(aq, bq, fl, THRESHOLD, bm=bn,
                                          bn=bn)
                _check_equal(f"stat_abft_matmul {tag}", got,
                             sk.stat_abft_matmul_plain(aq, bq, fl, THRESHOLD,
                                                       bm=bn, bn=bn))
                if bool(got[1][i, j // bn]):
                    flagged["stat_abft_matmul"].add(bit)
                if int(got[1].sum()) > int(bool(got[1][i, j // bn])):
                    raise AssertionError(f"stat_abft_matmul {tag}: flags "
                                         "away from the flip")
        torch.cuda.synchronize()
        want_bits = set(range(thr_bit, 32))
        for name in rows:
            bits = sorted(flagged[name])
            if name != "stat_abft_matmul" and set(bits) != want_bits:
                raise AssertionError(f"{name} {label}: flagged bits {bits}")
            rows[name].append(dict(
                label=label, shape=[m, k, n],
                padded_m=m if name == "drift_gemm_fused" else mp,
                lowest_flagged_bit=bits[0] if bits else None,
                unflagged_bits_above=[b for b in range(bits[0], 32)
                                      if b not in flagged[name]]
                if bits else None,
                **({"bn": bn} if name == "stat_abft_matmul" else {}),
                **({"splits": splits, "slabs": slabs,
                    "b_in_place": ops.reads_b_in_place(m, bq)}
                   if name == "drift_gemm_fused" else {})))
    wall = time.perf_counter() - t0
    after = dict(abft_matmul=ak.launches, drift_gemm_fused=ops.launches,
                 stat_abft_matmul=sk.launches)
    out = []
    for name, shapes in rows.items():
        out.append({"phase": "kernels", "kernel": name,
                    "sweep": "single_flip", "bit_equal": True,
                    "launches": after[name] - before[name],
                    "threshold_bit": thr_bit, "bits": [0, 31],
                    "positions": "(0, 0), (31, 31), (32, 32), last; rows "
                                 "clipped to M", "shapes": shapes,
                    "sweep_s": wall})
        emit(out[-1])
    return out


# The GQA language models' attention calls: (label, (B, S, H, Hkv, D),
# causal, window, softcap, tolerance), and the UNet's two self-attention
# shapes timed again over more launches.
LM_ATTN = (
    ("gemma2-9b prefill, local layer", (2, 8, 16, 8, 256), True, 4096, 50.0,
     3e-2),
    ("gemma2-9b prefill, global layer", (2, 8, 16, 8, 256), True, 0, 50.0,
     3e-2),
    ("gemma2-9b, binding window", (1, 8192, 16, 8, 256), True, 4096, 50.0,
     1e-2),
    ("gemma3-27b prefill, local layer", (2, 8, 32, 16, 168), True, 1024,
     0.0, 3e-2),
    ("gemma3-27b, local layer", (1, 2048, 32, 16, 168), True, 1024, 0.0,
     1e-2),
    ("glm4-9b, global layer", (1, 4096, 32, 2, 128), True, 0, 0.0, 1e-2),
    ("hymba-1.5b prefill, local layer", (2, 8, 25, 5, 64), True, 1024, 0.0,
     3e-2),
    ("hymba-1.5b, binding window", (1, 2048, 25, 5, 64), True, 1024, 0.0,
     1e-2),
    ("sd15-unet 32x32 self-attention", (2, 1024, 10, 10, 64), False, 0, 0.0,
     1e-2),
    ("sd15-unet 16x16 self-attention", (2, 256, 20, 20, 64), False, 0, 0.0,
     1e-2),
    ("whisper-base encoder self-attention", (8, 1500, 8, 8, 64), False, 0,
     0.0, 3e-3),
    ("olmo-1b train, causal: one process, (1, 2)", (8, 128, 16, 16, 128),
     True, 0, 0.0, 1e-2),
    ("olmo-1b train, causal: a (2, 1) rank", (4, 128, 16, 16, 128), True, 0,
     0.0, 1e-2),
)
# keys a K/V tile holds in the bf16 kernel (64 up to D 128, 32 above): a
# row whose S leaves a partial last tile after whole ones must also show
# that its tolerance tells the plain version apart from the same call with
# that last tile's keys dropped
KEY_TILE_D128, KEY_TILE_WIDE = 64, 32
# the train path's rows: S is whole key tiles, so the control drops the
# last whole tile (which the causal diagonal tile of the last query tile
# reads)
TRAIN_ATTN_ROWS = ("olmo-1b train, causal: one process, (1, 2)",
                   "olmo-1b train, causal: a (2, 1) rank")
# rows whose backward is timed too (the train path differentiates them)
BWD_ROWS = ("whisper-base encoder self-attention",) + TRAIN_ATTN_ROWS
UNET_REPS = 5           # the UNet rows: this many times --reps launches


def flex_softcap(torch, s: int, window: int, cap: float, dev):
    """The library call that computes a causal, softcapped row's function:
    ``flex_attention`` with the cap as its ``score_mod`` (which sees the
    scaled score, as the reference's ``full_attention`` caps it), the
    causal and window mask as a block mask, and ``enable_gqa``; compiled
    (``torch.compile``, Triton) on its first call, which the caller makes
    before timing it. A yardstick here only: the port never calls it.
    Inductor and Triton write their caches under ``build/``."""
    import os
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          str(ROOT / "build" / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))

    def score_mod(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    def mask_mod(b, h, qi, ki):
        keep = qi >= ki
        return keep & (qi - ki < window) if window else keep
    block_mask = create_block_mask(mask_mod, None, None, s, s, device=dev)
    compiled = torch.compile(flex_attention, dynamic=False)

    def call(q_, k_, v_):
        return compiled(q_, k_, v_, score_mod=score_mod,
                        block_mask=block_mask, enable_gqa=True)
    return call


def _backward_times(torch, F, fk, q, k, v, causal: bool, reps: int):
    """Device ms of one backward pass through ``mha_flash`` on the card
    (``_Attention``'s: the plain ``full_attention`` recomputed from q, k, v
    and differentiated) and through SDPA, each given the same output
    gradient; the bound: 5 products of 2 B H S^2 D flops (S = Q K^T
    recomputed, dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q) at the
    bf16 rate, or q, k, v, o, dO read and dq, dk, dv written once."""
    b, s, h, d = q.shape
    g = torch.Generator(device=q.device)
    g.manual_seed(7)
    go = torch.randn(q.shape, generator=g, device=q.device).to(q.dtype)
    ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
    n0 = fk.backward_calls
    out = fk.mha_flash(*ins, causal=causal)
    if out.grad_fn is None:
        raise AssertionError("mha_flash on the card returned no grad_fn")

    def bwd():
        torch.autograd.grad(out, ins, go, retain_graph=True)
    lib_ins = [t.detach().transpose(1, 2).requires_grad_(True)
               for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_ins, is_causal=causal)
    lib_go = go.transpose(1, 2)

    def lib_bwd():
        torch.autograd.grad(lib_out, lib_ins, lib_go, retain_graph=True)
    ms = device_ms(bwd, [()], reps)
    calls = fk.backward_calls - n0
    lib_ms = device_ms(lib_bwd, [()], reps)
    pairs = fk.attn_pairs(s, causal, 0)
    t_o = 10 * b * h * d * pairs / BF16_FLOPS_PER_S
    t_b = 8 * b * s * h * d * q.element_size() / HBM_BYTES_PER_S
    return dict(bwd_ms=ms, bwd_library_ms=lib_ms,
                bwd_bound_ms=1e3 * max(t_o, t_b),
                bwd_bound_by="operations" if t_o >= t_b else "bytes",
                bwd_calls_timed=calls,
                bwd_note="backward: the plain full_attention recomputed "
                         "in f32 and differentiated (no backward kernel, "
                         "as in the reference); library: SDPA's backward")


def phase_kernels_lm(torch, reps: int):
    """The attention kernel at the GQA models' calls (``LM_ATTN``), bf16:
    one launch on the (B, S, H, D) q and (B, S, Hkv, D) k, v, within the
    row's tolerance of the plain ``full_attention``; device ms over cold
    inputs beside the bound (4 D flops per attended pair and head at the
    bf16 rate, or q, k, v and o moved once), the plain version's ms and
    the library call: ``F.scaled_dot_product_attention(enable_gqa=True)``
    with a boolean mask for a window, or, where a softcap leaves SDPA a
    different function, ``flex_softcap`` (its error against the plain
    version recorded, or why it failed). Softcapped rows scale q by 8 so
    that scores of ~30 bend. A row whose S ends in a partial key tile after
    whole ones, or a train row (``TRAIN_ATTN_ROWS``, whose last whole tile
    stands in), also holds the plain version without that tile's keys to
    its tolerance, which must fail."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.models.attention import _mask, full_attention
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(20261018)
    rows = []
    for label, (b, s, h, hkv, d), causal, window, cap, tol in LM_ATTN:
        q = torch.randn((b, s, h, d), generator=g, device=dev)
        if cap:
            q = q * 8
        q = q.to(torch.bfloat16)
        k, v = (torch.randn((b, s, hkv, d), generator=g, device=dev
                            ).to(torch.bfloat16) for _ in range(2))

        def mha(q_, k_, v_, causal=causal, window=window, cap=cap):
            return fk.mha_flash(q_, k_, v_, causal=causal, window=window,
                                softcap=cap)

        def plain(q_, k_, v_, causal=causal, window=window, cap=cap):
            return full_attention(q_, k_, v_, causal=causal, window=window,
                                  attn_softcap=cap)
        n0 = fk.launches
        got = mha(q, k, v)
        torch.cuda.synchronize()
        launched = fk.launches - n0
        want = plain(q, k, v)
        err = max_abs_err([got], [want])
        if not (launched == 1 and bool(torch.isfinite(got).all())
                and torch.allclose(got.float(), want.float(), atol=tol,
                                   rtol=tol)):
            raise AssertionError(f"mha_flash {label} {(b, s, h, hkv, d)}: "
                                 f"{launched} launches, max abs err {err} "
                                 f"beyond {tol}")
        tile = KEY_TILE_D128 if d <= 128 else KEY_TILE_WIDE
        partial = s % tile if s > tile else 0
        if not partial and label in TRAIN_ATTN_ROWS:
            partial = tile
        dropped_gap = None
        if partial:
            dropped = plain(q, k[:, :s - partial], v[:, :s - partial])
            dropped_gap = max_abs_err([dropped], [want])
            if torch.allclose(dropped.float(), want.float(), atol=tol,
                              rtol=tol):
                raise AssertionError(f"mha_flash {label}: tolerance {tol} "
                                     f"passes the plain version without "
                                     f"its last {partial} keys")
            del dropped
        pairs = fk.attn_pairs(s, causal, window)
        work = fk.work(b, s, h, hkv, d, 2, causal, window)
        flops, bytes_ = work["flops"], work["bytes"]
        t_o, t_b = flops / BF16_FLOPS_PER_S, bytes_ / HBM_BYTES_PER_S
        ring = ring_of((q, k, v), bytes_)
        r = reps * (UNET_REPS if label.startswith("sd15") else 1)
        row = dict(name=label, shape=[b, s, h, hkv, d], causal=causal,
                   window=window, softcap=cap, tol=tol, max_abs_err=err,
                   launches_per_call=launched, ring=len(ring), reps=r,
                   ms=device_ms(mha, ring, r, "flash_attention"),
                   wall_ms=time_ms(mha, ring, r),
                   plain_ms=device_ms(plain, ring, max(1, r // 4)),
                   bound_ms=1e3 * max(t_o, t_b),
                   bound_by="operations" if t_o >= t_b else "bytes",
                   attended_pairs=pairs, library_ms=None,
                   library_kernels=None)
        if partial:
            row.update(dropped_tile_keys=partial,
                       dropped_tile_max_abs_gap=dropped_gap)
        lib_ring = [tuple(x.transpose(1, 2) for x in t) for t in ring]
        if cap:
            try:
                lib = flex_softcap(torch, s, window, cap, dev)
                lib_err = max_abs_err([lib(*lib_ring[0]).transpose(1, 2)],
                                      [want])
                row.update(library_call="flex_attention (compiled)",
                           library_max_abs_err=lib_err,
                           library_ms=device_ms(lib, lib_ring, r),
                           library_kernels=kernel_names(lib, lib_ring[0]))
            except Exception as e:      # recorded: the row keeps its null
                row.update(library_call="flex_attention (compiled)",
                           library_error=f"{type(e).__name__}: {e}"[:400])
        else:
            mask = None
            if window:
                pos = torch.arange(s, device=dev)
                mask = _mask(pos, pos, causal, window)

            def sdpa(q_, k_, v_, mask=mask, causal=causal):
                return F.scaled_dot_product_attention(
                    q_, k_, v_, attn_mask=mask,
                    is_causal=causal and mask is None, enable_gqa=True)
            row.update(library_call="F.scaled_dot_product_attention",
                       library_ms=device_ms(sdpa, lib_ring, r),
                       library_kernels=kernel_names(sdpa, lib_ring[0]))
        row["tflops"] = tflops(flops, row["ms"])
        if label in BWD_ROWS:
            row.update(_backward_times(torch, F, fk, q, k, v, causal, r))
        rows.append(row)
        del ring, lib_ring, q, k, v, got, want
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "mha_flash (GQA models, UNet)",
          "rows": rows,
          "note": "bf16; ms is the attention kernel's device time per "
                  "launch (torch.profiler, cold inputs), plain_ms the plain "
                  "full_attention's (scores in f32), library_ms one "
                  "library_call on (B, H, S, D) views: "
                  "F.scaled_dot_product_attention(enable_gqa=True), with a "
                  "boolean mask for a window, or, with a softcap, a "
                  "compiled flex_attention (score_mod cap, block mask, "
                  "enable_gqa; library_error where it failed); bound_ms at "
                  "989 TFLOP/s "
                  "(4 D flops per attended query-key pair and head, causal "
                  "and window clipped) or 3.35 TB/s (q, k, v, o once); the "
                  "UNet rows time UNET_REPS times as many launches"})
    return rows


def _perturb(torch, params, cfg, seed: int, device):
    """Small seeded random adaLN and final weights: with the adaLN-Zero
    init the model predicts eps = 0 and every quality number is vacuous."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    d = cfg.d_model
    for blk in params["blocks"]:
        blk["adaln_w"] = 0.02 * torch.randn(blk["adaln_w"].shape,
                                            generator=g, device=device)
    params["final_adaln_w"] = 0.02 * torch.randn(
        params["final_adaln_w"].shape, generator=g, device=device)
    params["final_w"] = torch.randn(params["final_w"].shape, generator=g,
                                    device=device) / d ** 0.5
    return params


def _perturb_any(torch, params, cfg, seed: int, device):
    """``_perturb`` for the DiT family; for the UNet a small seeded
    ``conv_out`` (zero at init, so eps = 0)."""
    if cfg.family != "unet":
        return _perturb(torch, params, cfg, seed, device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    params["conv_out"] = 0.05 * torch.randn(params["conv_out"].shape,
                                            generator=g, device=device)
    return params


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return None if tree is None else tree.to(device)


def check_energy(path, mode, results):
    """The perfmodel fields of each result, checked: present, and the
    ledger summing bit for bit to ``energy_j``. Returns their records."""
    from repro_torch.perfmodel import energy
    recs = []
    for r in results:
        fields = dict(energy_j=r.energy_j, latency_s=r.latency_s,
                      baseline_energy_j=r.baseline_energy_j,
                      baseline_latency_s=r.baseline_latency_s,
                      completed_at_s=r.completed_at_s,
                      energy_breakdown=r.energy_breakdown)
        if any(v is None for v in fields.values()):
            raise AssertionError(f"{path} {mode} request {r.request_id}: "
                                 f"perfmodel fields missing: {fields}")
        if energy.ledger_total(r.energy_breakdown) != r.energy_j:
            raise AssertionError(f"{path} {mode} request {r.request_id}: "
                                 "ledger does not sum to energy_j")
        recs.append(dict(path=path, mode=mode, request_id=r.request_id,
                         op=r.op, taylorseer=r.taylorseer,
                         precision=r.precision, ledger_exact=True,
                         source=ENERGY_SOURCE, **fields))
    return recs


def phase_reference(torch):
    """The SMOKE models on the card vs on the CPU, with the same params,
    inputs and flip masks (drawn on the CPU for both): the DiT for 3 drift
    steps and, with ``--taylorseer --precision int8-body4``, for 7 (3
    evaluations: forecasts and the narrowed ``eps`` checked on the card),
    olmo-1b for 8 stat_abft tokens (window 3), at undervolt."""
    from repro_torch.configs import get_config
    from repro_torch.core import fault
    from repro_torch.models import dit, transformer
    from repro_torch.serving import DriftServeEngine
    from repro_torch.serving.ar import prompt_tokens

    def engine(arch, device, params):
        eng = DriftServeEngine(arch=arch, smoke=True, bucket=2, base_seed=5,
                               device=device,
                               flip_source_factory=fault.philox_source_factory
                               (5, "cpu"))
        eng.set_params(arch, True, _to(params, device))
        return eng

    cfg = get_config(ARCH, smoke=True)
    cpu_params = _perturb(torch, dit.init_params(cfg, 3), cfg, 4, "cpu")
    lm_cfg = get_config(AR_ARCH, smoke=True)
    lm_params = transformer.init_params(lm_cfg, 8)
    prompts = prompt_tokens(lm_cfg, [0, 1])
    lat = torch.randn((2, 8, 8, 4), generator=torch.Generator().manual_seed(6))
    out, ts_out, lm_out = {}, {}, {}
    for device in ("cuda", "cpu"):
        for steps, knobs, into in ((3, {}, out),
                                   (TS_STEPS_SMOKE, TS_KNOBS, ts_out)):
            eng = engine(ARCH, device, cpu_params)
            eng.servable.batch_inputs = lambda c, seeds, d=device: (
                lat.to(d), torch.tensor([1, 2], device=d))
            for s in (0, 1):
                eng.submit(steps=steps, mode="drift", op="undervolt", seed=s,
                           **knobs)
            into[device] = eng.run()

        eng = engine(AR_ARCH, device, lm_params)
        eng.servable_for(AR_ARCH).batch_inputs = lambda c, seeds, d=device: (
            prompts.to(d),)
        for s in (0, 1):
            eng.submit(arch=AR_ARCH, steps=8, mode="stat_abft",
                       op="undervolt", seed=s, rollback_interval=3)
        lm_out[device] = eng.run()
    err = max(float((a.latents.cpu() - b.latents).abs().max())
              for a, b in zip(out["cuda"], out["cpu"]))
    ca = out["cuda"][0].batch_corrected_elems
    cb = out["cpu"][0].batch_corrected_elems
    # 1e-3 on latents in [-1, 1]: f32 on both sides, sums in other orders,
    # and an int8 rounding may tip at a boundary; the masks are the same.
    if not (err < 1e-3 and abs(ca - cb) <= 0.01 * max(cb, 1) and cb > 0):
        raise AssertionError(f"SMOKE card vs CPU: latents max err {err}, "
                             f"corrected {ca} vs {cb}")
    # TaylorSeer + int8-body4: the same masks reach the same computed
    # steps, so counts, evaluations and the bill are exact; the latents
    # are held as the drift run's are.
    ts_err = max(float((a.latents.cpu() - b.latents).abs().max())
                 for a, b in zip(ts_out["cuda"], ts_out["cpu"]))
    for a, b in zip(ts_out["cuda"], ts_out["cpu"]):
        if ((a.batch_corrected_elems, a.n_model_evals, a.energy_j)
                != (b.batch_corrected_elems, b.n_model_evals, b.energy_j)
                or b.n_model_evals != TS_EVALS_SMOKE
                or b.batch_corrected_elems <= 0):
            raise AssertionError(
                f"SMOKE TaylorSeer card vs CPU: corrected "
                f"{a.batch_corrected_elems} vs {b.batch_corrected_elems}, "
                f"evals {a.n_model_evals} vs {b.n_model_evals}, energy "
                f"{a.energy_j} vs {b.energy_j}")
    if not ts_err < 1e-3:
        raise AssertionError(f"SMOKE TaylorSeer card vs CPU: latents max "
                             f"err {ts_err}")
    # olmo-1b: tokens, rollbacks and evaluations exact; detections within
    # 2%, since a residual near its threshold may land on either side when
    # the f32 sums run in another order.
    da = lm_out["cuda"][0].ar_detections
    db = lm_out["cpu"][0].ar_detections
    for a, b in zip(lm_out["cuda"], lm_out["cpu"]):
        if (a.tokens, a.ar_rollbacks, a.n_model_evals,
                a.token_match_vs_clean) != (b.tokens, b.ar_rollbacks,
                                            b.n_model_evals,
                                            b.token_match_vs_clean):
            raise AssertionError(f"olmo-1b SMOKE card vs CPU: {a} vs {b}")
    if not (db > 0 and abs(da - db) <= 0.02 * db):
        raise AssertionError(f"olmo-1b SMOKE detections {da} vs {db}")
    for device in ("cuda", "cpu"):
        check_energy("reference", f"drift ({device})", out[device])
        check_energy("reference", f"drift+taylorseer+int8-body4 ({device})",
                     ts_out[device])
        check_energy("reference", f"stat_abft ({device})", lm_out[device])
    return dict(latents_max_abs_err=err, corrected_card=ca,
                corrected_cpu=cb, ts_latents_max_abs_err=ts_err,
                ts_corrected=ts_out["cpu"][0].batch_corrected_elems,
                ts_evals=ts_out["cpu"][0].n_model_evals,
                lm_detections_card=da,
                lm_detections_cpu=db,
                lm_rollbacks=lm_out["cpu"][0].ar_rollbacks,
                lm_tokens=[list(r.tokens) for r in lm_out["cpu"]],
                slice8=_reference_slice8(torch, engine, cpu_params, lat),
                gqa=_reference_lm(torch, engine, GQA_ARCHS),
                moe=_reference_lm(torch, engine, MOE_ARCHS),
                ssm=_reference_lm(torch, engine,
                                  [a for a, _ in SSM_ARCHS]),
                drift_decode=_reference_drift_decode(torch))


def _reference_lm(torch, engine, archs):
    """SMOKE language models (the GQA ones, the MoE ones, or the SSM and
    hybrid ones) on the card and the CPU with the same params, prompts
    and masks: 12 stat_abft tokens at undervolt, window 3, so that the
    decode passes the SMOKE window of 8. Tokens, token match, rollbacks
    and evaluations exact; detections within 2%, as olmo-1b's; modeled
    joules equal. mamba2-370m has no protected GEMM: no detection, no
    rollback, one evaluation a token. The served prompts have 8 tokens, so
    the window binds in decode only; a 12-token ``prefill`` on both sides
    binds it in the card's f32 attention kernel (GQA, gemma2's softcap and
    kimi-k2's head dim 8 included) and runs the SSD over two chunks of 8:
    one launch per attention layer, logits within 1e-4. An MoE row
    records, over the card's run, the smallest nonzero gap between a
    token's k-th and (k+1)-th router probability (routing may differ from
    the CPU's only below it) and the tokens whose gap is 0 (exact ties,
    which both sides break toward the lower expert index)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.models import moe, transformer
    from repro_torch.serving.ar import prompt_tokens
    route = moe.route
    margins = []

    def recording_route(cfg, router, x):
        r = route(cfg, router, x)
        top = torch.topk(r.probs, cfg.top_k + 1, dim=-1).values
        margins.append(top[:, -2] - top[:, -1])
        return r
    rows = []
    for arch in archs:
        cfg = get_config(arch, smoke=True)
        params = transformer.init_params(cfg, 8)
        # As the CPU tests scale them, so that greedy decoding does not
        # repeat one token: the embedding down, wo, w_down and the SSD's
        # out_proj up.
        params["embed"] = params["embed"] * 0.05
        for lp in params["layers"]:
            if "attn" in lp:
                lp["attn"]["wo"] = lp["attn"]["wo"] * 4.0
                ffn = lp["moe"] if cfg.family == "moe" else lp["mlp"]
                ffn["w_down"] = ffn["w_down"] * 4.0
                if "shared" in ffn:
                    ffn["shared"]["w_down"] = ffn["shared"]["w_down"] * 4.0
            if "ssm" in lp:
                lp["ssm"]["out_proj"] = lp["ssm"]["out_proj"] * 4.0
        long = torch.randint(0, cfg.vocab, (2, 12),
                             generator=torch.Generator().manual_seed(9))
        n0 = fk.launches
        card = transformer.prefill(cfg, _to(params, "cuda"), long.cuda(),
                                   16)[0].cpu()
        launched = fk.launches - n0
        prefill_err = float((card - transformer.prefill(
            cfg, params, long, 16)[0]).abs().max())
        attn_layers = 0 if cfg.family == "ssm" else cfg.n_layers
        if not (launched == attn_layers and prefill_err <= 1e-4):
            raise AssertionError(f"{arch} SMOKE 12-token prefill: "
                                 f"{launched} launches, logits max err "
                                 f"{prefill_err}")
        prompts = prompt_tokens(cfg, [0, 1])
        out = {}
        margins.clear()
        for device in ("cuda", "cpu"):
            eng = engine(arch, device, params)
            eng.servable_for(arch).batch_inputs = \
                lambda c, seeds, d=device: (prompts.to(d),)
            for s_ in (0, 1):
                eng.submit(arch=arch, steps=12, mode="stat_abft",
                           op="undervolt", seed=s_, rollback_interval=3)
            moe.route = recording_route if device == "cuda" else route
            try:
                out[device] = eng.run()
            finally:
                moe.route = route
        for a, b in zip(out["cuda"], out["cpu"]):
            if ((a.tokens, a.token_match_vs_clean, a.ar_rollbacks,
                 a.n_model_evals, a.energy_j)
                    != (b.tokens, b.token_match_vs_clean, b.ar_rollbacks,
                        b.n_model_evals, b.energy_j)):
                raise AssertionError(f"{arch} SMOKE card vs CPU: {a} vs {b}")
            if cfg.family == "ssm":
                if (a.ar_detections, b.ar_detections, b.ar_rollbacks,
                        b.n_model_evals) != (0, 0, 0, 12):
                    raise AssertionError(f"{arch} SMOKE: detections "
                                         f"{a.ar_detections}, "
                                         f"{b.ar_detections}, rollbacks "
                                         f"{b.ar_rollbacks}, evals "
                                         f"{b.n_model_evals}")
            elif not (b.ar_detections > 0 and b.ar_rollbacks >= 1 and abs(
                    a.ar_detections - b.ar_detections)
                    <= 0.02 * b.ar_detections):
                raise AssertionError(f"{arch} SMOKE detections "
                                     f"{a.ar_detections} vs "
                                     f"{b.ar_detections}")
            for r, dev in ((a, "cuda"), (b, "cpu")):
                check_energy("reference", f"{arch} stat_abft ({dev})", [r])
            row = dict(arch=arch, prefill12_max_abs_err=prefill_err,
                       prefill12_launches=launched,
                       request_id=b.request_id, tokens=list(b.tokens),
                       detections_card=a.ar_detections,
                       detections_cpu=b.ar_detections,
                       rollbacks=b.ar_rollbacks, evals=b.n_model_evals,
                       token_match_vs_clean=b.token_match_vs_clean)
            if cfg.family == "moe":
                gaps = torch.cat(margins)
                row.update(route_calls_card=len(margins),
                           min_topk_margin_card=float(gaps[gaps > 0].min()),
                           exact_topk_ties_card=int((gaps == 0).sum()))
            rows.append(row)
    return rows


def _reference_slice8(torch, engine, dit_params, lat):
    """The SMOKE DiT in the four Fig 12 baselines, and SMOKE PixArt and
    the SMOKE UNet in drift, on the card and on the CPU with the same
    params, inputs and masks, 3 steps at undervolt. Per request: latents
    within 1e-3 (f32 on both sides, sums in other orders; an int8 rounding
    may tip at a boundary) and corrected counts within 1% of each other,
    as for drift above; modeled joules within 1e-6 relative (they read
    the count). The UNet's rollback sets differ by a few tile rows
    (ROADMAP Queue C 13), which moves a few latents by up to ~1e-2 and
    their mean by ~2e-4: its latents are held within 2e-2 everywhere and
    1e-3 on average. dmr corrects nothing and its finals equal the clean
    reference's. cuDNN's TF32 is off for the UNet's f32 convolutions."""
    from repro_torch.configs import get_config
    from repro_torch.models import dit, unet
    fam_lat = {"pixart-alpha": lat,
               "sd15-unet": torch.randn((2, 16, 16, 4), generator=torch.
                                        Generator().manual_seed(7))}
    runs = [(ARCH, mode) for mode in BASELINE_MODES] + [
        (a, "drift") for a in FAMILY_ARCHS]
    params = {ARCH: dit_params}
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch, smoke=True)
        model = unet if cfg.family == "unet" else dit
        params[arch] = _perturb_any(torch, model.init_params(cfg, 3), cfg,
                                    4, "cpu")
    text = torch.randn((2, 8, 32), generator=torch.Generator().manual_seed(
        8)) * 0.1
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for device in ("cuda", "cpu"):
            for arch, mode in runs:
                eng = engine(arch, device, params[arch])
                if arch == ARCH:
                    eng.servable.batch_inputs = lambda c, seeds, d=device: (
                        lat.to(d), torch.tensor([1, 2], device=d))
                else:
                    eng.servable.batch_inputs = \
                        lambda c, seeds, d=device, a=arch: (
                            fam_lat[a].to(d), None, text.to(d))
                for s in (0, 1):
                    eng.submit(arch=arch, steps=3, mode=mode, op="undervolt",
                               seed=s)
                res = eng.run()
                (clean,) = eng._clean_samples.values()
                out[(device, arch, mode)] = (res, clean.cpu())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    rows = []
    for arch, mode in runs:
        (a, ca), (b, cb) = out[("cuda", arch, mode)], out[("cpu", arch,
                                                           mode)]
        tol, mean_tol = (2e-2, 1e-3) if arch == "sd15-unet" else (1e-3,
                                                                   1e-3)
        for x, y in zip(a, b):
            diff = (x.latents.cpu() - y.latents).abs()
            err, mean_err = float(diff.max()), float(diff.mean())
            n_a, n_b = x.batch_corrected_elems, y.batch_corrected_elems
            if not (err < tol and mean_err <= mean_tol
                    and abs(n_a - n_b) <= 0.01 * max(n_b, 1)
                    and abs(x.energy_j - y.energy_j) <= 1e-6 * y.energy_j
                    and x.n_model_evals == y.n_model_evals == 3):
                raise AssertionError(
                    f"SMOKE {arch} {mode} card vs CPU: latents max err "
                    f"{err} (mean {mean_err}), corrected {n_a} vs {n_b}, "
                    f"energy {x.energy_j} vs {y.energy_j}")
            if (mode == "dmr") != (n_b == 0):
                raise AssertionError(f"SMOKE {arch} {mode}: corrected {n_b}")
            if mode == "dmr":
                slot = x.request_id % 2
                if not (torch.equal(x.latents.cpu(), ca[slot])
                        and torch.equal(y.latents, cb[slot])):
                    raise AssertionError("SMOKE dmr finals differ from the "
                                         "clean reference's")
            for r, dev in ((x, "cuda"), (y, "cpu")):
                check_energy("reference", f"{arch} {mode} ({dev})", [r])
            rows.append(dict(arch=arch, mode=mode, request_id=x.request_id,
                             latents_max_abs_err=err,
                             latents_mean_abs_err=mean_err,
                             corrected_card=n_a,
                             corrected_cpu=n_b, energy_j_card=x.energy_j,
                             energy_j_cpu=y.energy_j,
                             counts_equal=n_a == n_b,
                             joules_equal=x.energy_j == y.energy_j))
    return rows


def _store_sizes(cfg) -> dict:
    """The drift checkpoint store of ``cfg`` at ``BUCKET`` (zeros on meta
    tensors, as ``sampler.init_stores`` allocates it): its bytes by
    ``rollback.store_bytes``, beside the offload planner's refresh volume
    (the perfmodel's ``activation_bytes``)."""
    from repro_torch.core.rollback import store_bytes
    from repro_torch.diffusion.sampler import init_stores
    from repro_torch.serving.offload.planner import OffloadPlanner
    stores = init_stores(cfg, BUCKET, "meta")
    stores = (stores,) if isinstance(stores, dict) else stores
    return dict(store_bytes=sum(store_bytes(s) for s in stores),
                refresh_bytes=OffloadPlanner().refresh_bytes(cfg, BUCKET))


def _meta_params(cfg) -> int:
    """``count_params`` of ``cfg``'s param tree drawn on meta tensors (the
    LMs' card weights are prepared without a param tree to count)."""
    from repro_torch.launch.dryrun import meta_init
    from repro_torch.models.common import count_params
    from repro_torch.train import steps
    return count_params(meta_init(
        lambda: steps.init_model_params(cfg, 0, "cpu")))


def phase_serve(torch):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import dit
    from repro_torch.models.common import count_params
    from repro_torch.serving import DriftServeEngine

    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    eng = DriftServeEngine(arch=ARCH, smoke=False, bucket=BUCKET,
                           device="cuda")
    params = _perturb(torch, dit.init_params(cfg, 11, dev), cfg, 12, dev)
    eng.set_params(ARCH, False, params)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    argv = ["--arch", ARCH, "--no-smoke", "--batch", str(BUCKET),
            "--steps", str(SERVE_STEPS), "--requests", "2", "--op",
            "undervolt", "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    drift = serve.main(argv + ["--mode", "drift"], engine=eng)
    torch.cuda.synchronize()
    t_drift = time.perf_counter() - t0
    t0 = time.perf_counter()
    faulty = serve.main(argv + ["--mode", "faulty"], engine=eng)
    torch.cuda.synchronize()
    t_faulty = time.perf_counter() - t0
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()

    gemms = sum(p[4] for p in path_gemms(cfg, BUCKET))        # 172
    evals = SERVE_STEPS
    # drift and its clean reference (drift at BER 0) run the fused
    # kernel, faulty the ABFT kernel
    want = {"abft_matmul": gemms * evals, "rollback_correct": 0,
            "drift_gemm_fused": gemms * evals * 2,
            "flash_attention": cfg.n_layers * evals * 3, "fault_inject": 0,
            "stat_abft_matmul": 0}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    reqs = []
    for mode, results in (("drift", drift), ("faulty", faulty)):
        for r in results:
            lat = r.latents
            if tuple(lat.shape) != (cfg.latent_size, cfg.latent_size,
                                    cfg.latent_channels):
                raise AssertionError(f"latents shape {tuple(lat.shape)}")
            finite = bool(torch.isfinite(lat).all())
            if mode == "drift" and not (finite and r.batch_corrected_elems
                                        > 0 and r.n_model_evals == evals):
                raise AssertionError(f"drift request {r.request_id}: finite "
                                     f"{finite}, corrected "
                                     f"{r.batch_corrected_elems}")
            if mode == "faulty" and r.batch_corrected_elems != 0:
                raise AssertionError("faulty mode corrected elements")
            reqs.append(dict(mode=mode, request_id=r.request_id,
                             psnr_vs_clean_db=r.psnr_vs_clean_db,
                             lpips_vs_clean=r.lpips_vs_clean,
                             batch_corrected_elems=r.batch_corrected_elems,
                             n_model_evals=r.n_model_evals,
                             monitor_ber=r.monitor_ber,
                             monitor_op_index=r.monitor_op_index,
                             finite=finite))
    if not all(q["finite"] for q in reqs if q["mode"] == "drift"):
        raise AssertionError("non-finite drift latents")

    # TaylorSeer + int8-body4, counted on its own: it and its clean
    # reference (TaylorSeer on, int8) each compute steps 0, 3, 6, 9.
    _zero_launches()
    t0 = time.perf_counter()
    ts_res = serve.main(argv + ["--mode", "drift"] + TS_ARGS, engine=eng)
    torch.cuda.synchronize()
    t_ts = time.perf_counter() - t0
    ts_launches = _launch_counts()
    peak = max(peak, torch.cuda.max_memory_allocated())
    ts_evals = len(range(0, SERVE_STEPS, 3))                   # 4
    ts_want = {"abft_matmul": 0, "rollback_correct": 0,
               "drift_gemm_fused": gemms * ts_evals * 2,
               "flash_attention": cfg.n_layers * ts_evals * 2,
               "fault_inject": 0, "stat_abft_matmul": 0}
    if ts_launches != ts_want:
        raise AssertionError(f"TaylorSeer launch counts {ts_launches} != "
                             f"{ts_want}")
    for r in ts_res:
        finite = bool(torch.isfinite(r.latents).all())
        if not (finite and r.n_model_evals == ts_evals
                and (r.taylorseer, r.precision) == (True, "int8-body4")):
            raise AssertionError(f"TaylorSeer request {r.request_id}: finite "
                                 f"{finite}, evals {r.n_model_evals}")
        reqs.append(dict(mode="drift+taylorseer+int8-body4",
                         request_id=r.request_id,
                         psnr_vs_clean_db=r.psnr_vs_clean_db,
                         lpips_vs_clean=r.lpips_vs_clean,
                         batch_corrected_elems=r.batch_corrected_elems,
                         n_model_evals=r.n_model_evals, finite=finite))
    for clean in eng._clean_samples.values():
        if not bool(torch.isfinite(clean).all()):
            raise AssertionError("non-finite clean reference latents")

    energy = (check_energy("serve", "drift", drift)
              + check_energy("serve", "faulty", faulty)
              + check_energy("serve", "drift+taylorseer+int8-body4",
                             ts_res))
    for d, t in zip(drift, ts_res):
        if not d.energy_j < d.baseline_energy_j:
            raise AssertionError(f"drift request {d.request_id} bills "
                                 f"{d.energy_j} J, not below its baseline "
                                 f"{d.baseline_energy_j} J")
        if not t.energy_j < d.energy_j:
            raise AssertionError(f"TaylorSeer request {t.request_id} bills "
                                 f"{t.energy_j} J, not below drift's "
                                 f"{d.energy_j} J")
    return dict(arch=ARCH, layers=cfg.n_layers, d_model=cfg.d_model,
                tokens=cfg.tokens, bucket=BUCKET, steps=SERVE_STEPS,
                n_params=count_params(params),
                n_params_dit_paper=DIT_XL2_PAPER_PARAMS,
                **_store_sizes(cfg),
                setup_s=setup_s, drift_run_s=t_drift, faulty_run_s=t_faulty,
                taylorseer_run_s=t_ts, peak_mem_bytes=peak,
                launches=launches, taylorseer_launches=ts_launches,
                requests=reqs, builds=eng.cache.builds,
                clean_samples=eng.stats.clean_samples_computed,
                energy=energy,
                breakdown=_profile_request(torch, eng, argv))


def _profile_request(torch, eng, argv):
    """Device time by kernel over one more drift request of 3 steps (after
    the counted run): where a served request's time goes on the card, and
    the device kernels a protected GEMM costs (every kernel of the request
    over its protected GEMMs: 172 an evaluation, 6 evaluations; a
    ``drift_gemm_fused`` call is the GEMM kernel, after a transpose of B
    to K-major, ``transpose_s``, where M > 64)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    argv = [a if a != str(SERVE_STEPS) else "3" for a in argv]
    argv += ["--mode", "drift", "--requests", "1", "--seed", "100"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve.main(argv, engine=eng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    fa = sum(r[0] for r in rows if "flash_attention" in r[1]) / 1e6
    ab = sum(r[0] for r in rows if "abft_matmul" in r[1]) / 1e6
    dg = sum(r[0] for r in rows if "drift_gemm" in r[1]) / 1e6
    tr = sum(r[0] for r in rows if "transpose_kernel" in r[1]) / 1e6
    n_kernels = sum(r[2] for r in rows)
    gemms = 6 * sum(p[4] for p in path_gemms(get_config(ARCH), BUCKET))
    return dict(what="1 drift request, 3 steps, plus its clean reference "
                     "(6 evaluations)", wall_s=wall, device_busy_s=busy,
                device_busy_share=busy / wall, flash_attention_s=fa,
                flash_attention_share_of_busy=fa / busy if busy else None,
                abft_matmul_s=ab,
                abft_matmul_share_of_busy=ab / busy if busy else None,
                drift_gemm_fused_s=dg,
                drift_gemm_fused_share_of_busy=dg / busy if busy else None,
                transpose_s=tr,
                transpose_calls=sum(r[2] for r in rows
                                    if "transpose_kernel" in r[1]),
                n_kernels=n_kernels, protected_gemms=gemms,
                kernels_per_protected_gemm=n_kernels / gemms,
                top=[dict(kernel=k[:80], device_s=us / 1e6, calls=c)
                     for us, k, c in rows[:12]])


def _launch_counts():
    """Every kernel's launches since the counters were zeroed."""
    return {k: mod.launches for k, mod in _counters().items()}


def _zero_launches():
    for mod in _counters().values():
        mod.launches = 0


def phase_offload(torch, smi):
    """The full-width DiT with checkpoint offload and streamed previews
    through the CLI, against the same requests without offload, and the
    SMOKE DiT with offload on the card against the CPU."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import dit
    from repro_torch.serving import DriftServeEngine, OffloadConfig
    from repro_torch.tree import tree_leaves

    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    params = _perturb(torch, dit.init_params(cfg, 11, dev), cfg, 12, dev)
    argv = ["--arch", ARCH, "--no-smoke", "--batch", str(BUCKET),
            "--steps", str(SERVE_STEPS), "--requests", "2", "--op",
            "undervolt", "--device", "cuda", "--mode", "drift",
            "--rollback-interval", str(OFFLOAD_INTERVAL)]
    # The flip source is keyed by batch index: each turn gets a fresh
    # engine with the same base seed, so the turns' batches draw the same
    # masks. Turns: plain, offload, offload, plain; each serves the same
    # 2 requests 1 + STEADY_BATCHES times. The first batch ("cold") runs
    # drift and its clean reference and, offloaded, allocates the pinned
    # host sets; the later ("steady") ones reuse both (the clean sample is
    # a cache hit), so they run drift alone.
    gemms = sum(p[4] for p in path_gemms(cfg, BUCKET))        # 172

    def want(evals):
        return {"abft_matmul": 0, "rollback_correct": 0,
                "drift_gemm_fused": gemms * evals,
                "flash_attention": cfg.n_layers * evals, "fault_inject": 0,
                "stat_abft_matmul": 0}
    wants = {"cold": want(SERVE_STEPS * 2), "steady": want(SERVE_STEPS)}
    commits = len(range(0, SERVE_STEPS, OFFLOAD_INTERVAL))      # 5
    windows = -(-SERVE_STEPS // OFFLOAD_INTERVAL) - 1            # 4
    nbytes = None
    turns, first = [], {}
    for turn, label in enumerate(("plain", "offload", "offload", "plain")):
        # drop the previous turn's engine (it holds a reference cycle)
        # before reading this turn's memory
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        offload = OffloadConfig() if label == "offload" else None
        eng = DriftServeEngine(arch=ARCH, smoke=False, bucket=BUCKET,
                               device="cuda", offload=offload)
        eng.set_params(ARCH, False, params)
        store = eng.offload_store
        extra = (["--offload", "--stream", str(OFFLOAD_INTERVAL)]
                 if offload is not None else [])
        batches = []
        for n, batch in enumerate(("cold",) + ("steady",) * STEADY_BATCHES):
            live = {}
            if turn == 1 and n == 1:
                # keep the live store for the restore check, made after
                # the batch's memory is read
                tap = eng._offload_on_carry

                def keep(done, carry, tap=tap):
                    live["stores"] = carry[1]
                    tap(done, carry)
                eng._offload_on_carry = keep
            st0 = store.stats.snapshot() if store is not None else None
            alloc0 = store.pinned_alloc_s if store is not None else 0.0
            previews0 = eng.stats.preview_events
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            _zero_launches()
            t0 = time.perf_counter()
            results = serve.main(argv + extra, engine=eng)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            b = dict(batch=batch, wall_s=wall, start_bytes=start,
                     peak_over_start_bytes=(torch.cuda.max_memory_allocated()
                                            - start),
                     launches=_launch_counts(),
                     results=results)
            if b["launches"] != wants[batch]:
                raise AssertionError(f"{label} {batch} launch counts "
                                     f"{b['launches']} != {wants[batch]}")
            first.setdefault(n, results)
            # compared as bits: a batch's drift latents may hold NaN
            # (ROADMAP Queue C 10), which torch.equal never calls equal
            b["finite"] = all(bool(torch.isfinite(r.latents).all())
                              for r in results)
            for x, y in zip(first[n], results):
                if not (torch.equal(x.latents.view(torch.int32),
                                    y.latents.view(torch.int32))
                        and x.batch_corrected_elems
                        == y.batch_corrected_elems > 0):
                    raise AssertionError(
                        f"{label} {batch} request {x.request_id}: not "
                        f"bit-identical to the plain run (corrected "
                        f"{x.batch_corrected_elems} vs "
                        f"{y.batch_corrected_elems})")
            batches.append(b)
            if store is None:
                continue
            if live:
                # the live store at the end of the batch holds the refresh
                # of the last committed step; restore() must give it back
                # bit for bit
                stores = tree_leaves(live.pop("stores"))
                nbytes = sum(-(-math.prod(t.shape[:-1]) // 32) * 32
                             * -(-t.shape[-1] // 32) * 32 * t.element_size()
                             for t in stores)
                restored = tree_leaves(store.restore())
                if not (len(restored) == len(stores) == 10
                        and all(torch.equal(x, y)
                                for x, y in zip(restored, stores))):
                    raise AssertionError("restore() differs from the live "
                                         "store")
                # untap, so later batches keep nothing alive and the
                # engine can be freed with its turn
                del eng._offload_on_carry
                del restored, stores, keep, tap
            st = store.stats.delta(st0)
            previews = eng.stats.preview_events - previews0
            if not (st.commits == commits and st.skipped == 0
                    and st.bytes_offloaded == commits
                    * store.committed_nbytes
                    and previews == windows * BUCKET
                    and store.committed_step
                    == SERVE_STEPS - OFFLOAD_INTERVAL
                    and len(store.commit_ms) == commits):
                raise AssertionError(
                    f"offload {batch}: {st}, committed "
                    f"{store.committed_nbytes} B at step "
                    f"{store.committed_step}, {previews} previews")
            b.update(waits=st.waits,
                     pinned_alloc_s=store.pinned_alloc_s - alloc0,
                     repack_ms=[r for r, _ in store.commit_ms],
                     d2h_ms=[c for _, c in store.commit_ms],
                     d2h_gb_per_s=[store.committed_nbytes / (c * 1e-3) / 1e9
                                   for _, c in store.commit_ms])
        rec = dict(label=label, batches=batches)
        if store is not None:
            if store.committed_nbytes != nbytes:
                raise AssertionError(f"committed {store.committed_nbytes} B"
                                     f", the live store has {nbytes} B")
            rec.update(
                stall=eng.offload_stall_s(ARCH, "undervolt", SERVE_STEPS,
                                          OFFLOAD_INTERVAL),
                auto=eng.auto_rollback_interval(ARCH, "undervolt",
                                                SERVE_STEPS))
        turns.append(rec)
        del eng, store

    plain, off = turns[0], turns[1]
    stall = off["stall"]
    for pb, ob in zip(plain["batches"], off["batches"]):
        for x, y in zip(pb["results"], ob["results"]):
            if y.latency_s != x.latency_s + stall or y.energy_j != x.energy_j:
                raise AssertionError(
                    f"{ob['batch']} request {x.request_id}: modeled latency"
                    f"/energy {y.latency_s}/{y.energy_j} vs {x.latency_s}/"
                    f"{x.energy_j} + stall")
    keys = ("wall_s", "start_bytes", "peak_over_start_bytes", "finite",
            "waits", "pinned_alloc_s", "repack_ms", "d2h_ms",
            "d2h_gb_per_s")
    rec = dict(
        card=smi, arch=ARCH, layers=cfg.n_layers, bucket=BUCKET,
        steps=SERVE_STEPS, rollback_interval=OFFLOAD_INTERVAL,
        stream=OFFLOAD_INTERVAL, commits=commits, commit_bytes=nbytes,
        pinned_bytes=2 * nbytes, previews=windows * BUCKET,
        turns=[dict(label=t["label"],
                    cold={k: t["batches"][0][k] for k in keys
                          if k in t["batches"][0]},
                    steady=[{k: b[k] for k in keys if k in b}
                            for b in t["batches"][1:]]) for t in turns],
        auto_interval=off["auto"], modeled_stall_s=stall,
        modeled_stall_source=ENERGY_SOURCE,
        launches={b["batch"]: b["launches"] for b in off["batches"][:2]},
        bit_identical=True, restore_equal=True,
        smoke=_offload_smoke(torch))
    emit({"offload": rec})
    energy = (check_energy("offload", "drift",
                           plain["batches"][0]["results"])
              + check_energy("offload", "drift+offload+stream",
                             off["batches"][0]["results"]))
    return dict(launches=off["batches"][0]["launches"],
                steady_launches=off["batches"][1]["launches"],
                energy=energy, commits=commits,
                waits=[b["waits"] for t in turns for b in t["batches"]
                       if "waits" in b])


def _offload_smoke(torch):
    """The SMOKE DiT with ``--offload --stream 1 --rollback-interval 2`` on
    the card and on the CPU with the same params, inputs and masks: held
    as the ``reference`` phase holds latents and corrected counts;
    commits and committed bytes equal."""
    from repro_torch.configs import get_config
    from repro_torch.core import fault
    from repro_torch.launch import serve
    from repro_torch.models import dit
    from repro_torch.serving import DriftServeEngine, OffloadConfig

    cfg = get_config(ARCH, smoke=True)
    params = _perturb(torch, dit.init_params(cfg, 3, "cpu"), cfg, 4, "cpu")
    lat = torch.randn((2, 8, 8, 4), generator=torch.Generator().manual_seed(6))
    out = {}
    for device in ("cuda", "cpu"):
        eng = DriftServeEngine(arch=ARCH, smoke=True, bucket=2, base_seed=5,
                               device=device, offload=OffloadConfig(),
                               flip_source_factory=fault.philox_source_factory
                               (5, "cpu"))
        eng.set_params(ARCH, True, _to(params, device))
        eng.servable.batch_inputs = lambda c, seeds, d=device: (
            lat.to(d), torch.tensor([1, 2], device=d))
        res = serve.main(["--steps", "3", "--requests", "2", "--mode",
                          "drift", "--op", "undervolt", "--device", device,
                          "--offload", "--stream", "1",
                          "--rollback-interval", "2"], engine=eng)
        out[device] = (res, eng.offload_store.stats.commits,
                       eng.offload_store.committed_nbytes,
                       eng.stats.preview_events)
    (ra, ca, na, pa), (rb, cb, nb, pb) = out["cuda"], out["cpu"]
    err = max(float((a.latents.cpu() - b.latents).abs().max())
              for a, b in zip(ra, rb))
    xa, xb = ra[0].batch_corrected_elems, rb[0].batch_corrected_elems
    if not (err < 1e-3 and abs(xa - xb) <= 0.01 * max(xb, 1) and xb > 0
            and (ca, na, pa) == (cb, nb, pb) == (2, nb, 4) and nb > 0):
        raise AssertionError(
            f"SMOKE offload card vs CPU: latents max err {err}, corrected "
            f"{xa} vs {xb}, commits {ca} vs {cb}, bytes {na} vs {nb}, "
            f"previews {pa} vs {pb}")
    return dict(latents_max_abs_err=err, corrected_card=xa,
                corrected_cpu=xb, commits=cb, commit_bytes=nb, previews=pb)


# telemetry and recorder on, then off; one turn each for the whole
# script's time limit
SCHED_TURNS = ("on", "off")
AUTO_BATCHES = 4
# Wall-clock samples and the build label: all an exposition may differ by.
WALL_METRICS = ("drift_engine_uptime_seconds", "drift_clock_skew_ratio")


def _mask_metrics(text: str) -> str:
    import re
    out = []
    for line in text.splitlines():
        if line.split("{")[0].split(" ")[0] in WALL_METRICS:
            line = line.rsplit(" ", 1)[0] + " <wall>"
        out.append(re.sub(r'version="[^"]*"', 'version="<v>"', line))
    return "\n".join(out)


def _span_view(tracer):
    """Spans without their wall-clock fields."""
    return [(s.name, s.kind, s.request_ids, s.batch_index, s.t0_virtual_s,
             s.t1_virtual_s, s.attrs) for s in tracer.spans()]


def _parse_sse(payload: str):
    events, kind = [], None
    for line in payload.splitlines():
        if line.startswith("event: "):
            kind = line[len("event: "):]
        elif line.startswith("data: "):
            events.append((kind, json.loads(line[len("data: "):])))
    return events


def _get(url: str):
    """(seconds, body) of one GET on the loopback front end."""
    import urllib.request
    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=600) as resp:
        body = resp.read().decode("utf-8")
    return time.perf_counter() - t0, body


def _sched_requests(sched, steps: int):
    """The full-width workload: 2 background requests at undervolt, 2
    interactive ones whose deadlines (from the scheduler's own projection)
    force overclock, one with ``step_budget=5`` and one whose energy
    budget the frontier resolves. Returns (requests, the numbers used)."""
    bucket = sched.engine.batcher.bucket
    uv = sched.batch_latency_s(ARCH, "undervolt", steps)
    oc = sched.batch_latency_s(ARCH, "overclock", steps)
    dl = (uv + oc) / 2
    pts = sched.frontier_builder().frontier(sched.engine._full_cfg(ARCH),
                                            steps, bucket)
    budget = sorted(p.energy_j for p in pts)[len(pts) // 2]
    base = dict(steps=steps, mode="drift", op="undervolt")
    reqs = [dict(base, priority="background", seed=0),
            dict(base, priority="background", seed=1),
            dict(base, priority="interactive", deadline_s=dl, seed=2),
            dict(base, priority="interactive", deadline_s=oc + dl, seed=3),
            dict(base, step_budget=5, seed=4),
            dict(base, energy_budget_j=budget, seed=5)]
    return reqs, dict(undervolt_s=uv, overclock_s=oc, deadline_s=dl,
                      second_deadline_s=oc + dl, energy_budget_j=budget,
                      source=ENERGY_SOURCE)


def _sched_smoke(torch):
    """The SMOKE DiT (4 requests, 3 steps) and olmo-1b (2 requests, 8
    tokens) through ``DeadlineScheduler`` with telemetry and the recorder
    on, on the card and on the CPU with the same params, inputs and flip
    masks: admissions, masked ``/metrics``, spans (wall fields dropped)
    and heatmaps equal."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import fault
    from repro_torch.models import dit, transformer
    from repro_torch.serving import DeadlineScheduler, DriftServeEngine
    from repro_torch.serving.ar import prompt_tokens

    cfg = get_config(ARCH, smoke=True)
    params = _perturb(torch, dit.init_params(cfg, 3, "cpu"), cfg, 4, "cpu")
    lm_cfg = get_config(AR_ARCH, smoke=True)
    lm_params = transformer.init_params(lm_cfg, 8)
    prompts = prompt_tokens(lm_cfg, [0, 1])
    lat = torch.randn((2, 8, 8, 4), generator=torch.Generator().manual_seed(6))
    out = {}
    for device in ("cuda", "cpu"):
        eng = DriftServeEngine(arch=ARCH, smoke=True, bucket=2, base_seed=5,
                               device=device,
                               flip_source_factory=fault.philox_source_factory
                               (5, "cpu"))
        eng.set_params(ARCH, True, _to(params, device))
        eng.set_params(AR_ARCH, True, _to(lm_params, device))
        eng.servable.batch_inputs = lambda c, seeds, d=device: (
            lat.to(d), torch.tensor([1, 2], device=d))
        eng.servable_for(AR_ARCH).batch_inputs = \
            lambda c, seeds, d=device: (prompts.to(d),)
        sched = DeadlineScheduler(eng)
        reqs, _ = _sched_requests(sched, 3)
        reqs = reqs[:4] + [dict(arch=AR_ARCH, steps=8, mode="stat_abft",
                                op="undervolt", rollback_interval=3,
                                priority=p, seed=10 + i)
                           for i, p in enumerate(("background",
                                                  "interactive"))]
        adms = [dataclasses.asdict(sched.submit(**f)) for f in reqs]
        res = sched.run()
        out[device] = dict(
            adms=adms, metrics=_mask_metrics(eng.telemetry.registry.expose()),
            spans=_span_view(eng.tracer),
            heat=[(r.detect_heatmap, r.detect_heatmap_blocks) for r in res],
            corrected=[r.batch_corrected_elems for r in res],
            replays=sum(1 for s in eng.tracer.spans() if s.kind == "replay"))
    a, b = out["cuda"], out["cpu"]
    same = {k: a[k] == b[k] for k in a}
    if not all(same.values()) or b["replays"] < 1:
        lines = [(x, y) for x, y in zip(a["metrics"].splitlines(),
                                        b["metrics"].splitlines()) if x != y]
        raise AssertionError(f"sched SMOKE card vs CPU differ: {same}, "
                             f"corrected {a['corrected']} vs "
                             f"{b['corrected']}, replays {b['replays']}, "
                             f"metric lines {lines[:6]}")
    return dict(equal=sorted(same), actions=[x["action"] for x in b["adms"]],
                corrected=b["corrected"], replay_spans=b["replays"],
                spans=len(b["spans"]))


def phase_sched(torch, smi):
    """``DeadlineScheduler`` with telemetry, the flight recorder and the
    HTTP front end on the full-width DiT, against a CPU twin's admissions
    and, in turns, engines with telemetry and the recorder off; then
    ``op="auto"`` batches under the guardband controller."""
    import dataclasses
    import gc
    import hashlib
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.models import dit
    from repro_torch.serving import (DeadlineScheduler, DriftServeEngine,
                                     EngineTelemetry, FlightRecorder,
                                     serve_telemetry)
    from repro_torch.serving.trace import write_chrome_trace

    smoke = _sched_smoke(torch)
    emit({"phase": "sched", "part": "smoke", **smoke})

    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    params = _perturb(torch, dit.init_params(cfg, 11, dev), cfg, 12, dev)
    gemms = sum(p[4] for p in path_gemms(cfg, BUCKET))        # 172
    twin = DeadlineScheduler(DriftServeEngine(arch=ARCH, smoke=False,
                                              bucket=BUCKET, device="cpu"))
    reqs, numbers = _sched_requests(twin, SERVE_STEPS)
    want_adms = [dataclasses.asdict(twin.submit(**f)) for f in reqs]
    actions = [a["action"] for a in want_adms]
    if actions != ["as-requested"] * 2 + ["escalated-op"] * 2 \
            + ["as-requested", "frontier"]:
        raise AssertionError(f"twin admissions: {actions}")
    emit({"phase": "sched", "part": "admissions", "requests": reqs,
          "projection": numbers, "admissions": want_adms})

    def want(evals):
        return {"abft_matmul": 0, "rollback_correct": 0,
                "drift_gemm_fused": gemms * evals,
                "flash_attention": cfg.n_layers * evals, "fault_inject": 0,
                "stat_abft_matmul": 0}

    def bits(t):
        return hashlib.sha256(t.view(torch.int32).cpu().numpy().tobytes()
                              ).hexdigest()

    turns, first, launches_on = [], None, None
    for label in SCHED_TURNS:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        kw = ({} if label == "on" else
              dict(telemetry=EngineTelemetry(enabled=False),
                   tracer=FlightRecorder(enabled=False)))
        eng = DriftServeEngine(arch=ARCH, smoke=False, bucket=BUCKET,
                               device="cuda", **kw)
        eng.set_params(ARCH, False, params)
        sched = DeadlineScheduler(eng)
        server = serve_telemetry(eng, port=0)
        rec = dict(label=label)
        try:
            with server.engine_lock:
                adms = [dataclasses.asdict(sched.submit(**f)) for f in reqs]
                if adms != want_adms:
                    raise AssertionError(f"{label}: admissions differ from "
                                         f"the CPU twin's: {adms}")
                torch.cuda.synchronize()
                _zero_launches()
                t0 = time.perf_counter()
                results = sched.run()
                torch.cuda.synchronize()
                rec["run_wall_s"] = time.perf_counter() - t0
            launches = _launch_counts()
            evals = sum({r.batch_index: 2 * r.n_model_evals
                         for r in results}.values())
            if launches != want(evals):
                raise AssertionError(f"{label} run launches {launches} != "
                                     f"{want(evals)} ({evals} evaluations)")
            # the background pair again, drained through /events on the
            # server's thread (its clean samples cached: drift alone)
            for f in reqs[:2]:
                sched.submit(**f)
            _zero_launches()
            rec["events_wall_s"], body = _get(server.url
                                              + "/events?interval=2")
            torch.cuda.synchronize()
            frames = _parse_sse(body)
            sse = [d for k, d in frames if k == "result"]
            ev_launches = _launch_counts()
            if (len(sse) != 2 or frames[-1][0] != "end"
                    or ev_launches != want(sse[0]["n_model_evals"])):
                raise AssertionError(f"{label} /events: {len(sse)} results,"
                                     f" launches {ev_launches}")
            # the off turns' recorder is disabled: /trace/<id> is a 404
            paths = ("/healthz", "/metrics", "/slo") + (
                ("/trace/2",) if label == "on" else ())
            rec["scrape_s"], text = {}, {}
            for path in paths:
                rec["scrape_s"][path], text[path] = _get(server.url + path)
            if label == "off" and text["/metrics"] != \
                    "# telemetry disabled\n":
                raise AssertionError("/metrics with telemetry off")
            if label == "on":
                tree = json.loads(text["/trace/2"])
                if tree["decision"]["action"] != "escalated-op":
                    raise AssertionError(f"/trace/2: {tree['decision']}")
                if "drift_requests_served_total 8" not in text["/metrics"]:
                    raise AssertionError("/metrics: not 8 served")
                rec.update(
                    trace_2_kinds=[s["kind"] for s in tree["spans"]],
                    metrics_lines=len(text["/metrics"].splitlines()),
                    slo_breached=[o for o, v in json.loads(
                        text["/slo"])["objectives"].items()
                        if v["breached"]])
                with tempfile.TemporaryDirectory() as d:
                    path = Path(d) / "flight.json"
                    write_chrome_trace(str(path), eng.tracer.spans())
                    chrome = json.loads(path.read_text())
                rec["chrome_events"] = len(chrome["traceEvents"])
                rec["spans"] = len(eng.tracer)
                rec["guard_index"] = eng.telemetry.controller.guard_index
                launches_on = launches_on or launches
        finally:
            server.close()
        finals = ([bits(r.latents) for r in results]
                  + [d["latents_sha256"] for d in sse])
        rec.update(finite=[bool(torch.isfinite(r.latents).all())
                           for r in results],
                   ops=[r.op for r in results],
                   steps=[r.steps for r in results],
                   evals=evals, launches=launches,
                   deadline_missed=[r.deadline_missed for r in results],
                   queue_wait_s=[r.queue_wait_s for r in results])
        if first is None:
            first = finals
            energy = check_energy("sched", "drift via DeadlineScheduler",
                                  results)
        elif finals[:len(results)] != first[:len(results)]:
            raise AssertionError(f"{label}: finals differ from the first "
                                 "turn's")
        sse_sha = finals[len(results):]
        rec["sse_equal_to_first_turn"] = sse_sha == first[len(results):]
        if not rec["sse_equal_to_first_turn"]:
            raise AssertionError(f"{label}: /events finals differ")
        emit({"phase": "sched", "part": "turn", **rec})
        turns.append(rec)
        del eng, sched, server, results

    # op="auto" under the guardband controller: 4 batches of the same
    # seeds (the clean sample cached after the first)
    gc.collect()
    eng = DriftServeEngine(arch=ARCH, smoke=False, bucket=BUCKET,
                           device="cuda")
    eng.set_params(ARCH, False, params)
    ctrl = eng.telemetry.controller
    auto = []
    _zero_launches()
    for b in range(AUTO_BATCHES):
        idx = eng.auto_op_index()
        for s in (0, 1):
            eng.submit(steps=SERVE_STEPS, mode="drift", op="auto", seed=s)
        (r, _) = eng.run()
        auto.append(dict(batch=b, auto_index=idx, op_served=r.op,
                         monitor_ber=r.monitor_ber,
                         monitor_index=r.monitor_op_index,
                         guard_floor=ctrl.guard_index,
                         action=ctrl.stats.last_action,
                         realized_ber=dict(ctrl.realized_ber),
                         corrected=r.batch_corrected_elems,
                         finite=bool(torch.isfinite(r.latents).all())))
    auto_launches = _launch_counts()
    emit({"phase": "sched", "part": "auto", "target_ber":
          eng.monitor_target_ber, "batches": auto})
    return dict(card=smi, arch=ARCH, bucket=BUCKET, steps=SERVE_STEPS,
                turns=[{k: t[k] for k in ("label", "run_wall_s",
                                          "events_wall_s", "scrape_s")}
                       for t in turns],
                run_wall_on_s=[t["run_wall_s"] for t in turns
                               if t["label"] == "on"],
                run_wall_off_s=[t["run_wall_s"] for t in turns
                                if t["label"] == "off"],
                bit_identical=True, launches=launches_on,
                auto_launches=auto_launches, smoke=smoke["equal"],
                energy=energy)


def phase_ar(torch):
    """Full-width olmo-1b through the CLI: stat_abft, then faulty."""
    return _serve_ar(torch, AR_ARCH, 21, "ar")


def phase_lm(torch):
    """Full-width gemma2-9b (42 layers, d 3584, 16 heads of 256 over 8 KV
    heads, windows of 4096 on alternate layers, softcaps 50 and 30, 9.24 B
    parameters: 18.5 GB of bf16 weights), then gemma3-27b (62 layers,
    d 5376, 32 heads of 168 over 16, windows of 1024 on 5 of 6 layers, a
    tied 262144 x 5376 embedding, 28.3 B parameters: 56.6 GB), then
    glm4-9b (40 layers, d 4096, 32 heads of 128 over 2, 9.40 B
    parameters: 18.8 GB) through the CLI as ``ar`` drives olmo-1b, each
    after every earlier engine is freed."""
    return _serve_archs(torch, LM_ARCHS, "lm")


def phase_ssm(torch):
    """Full-width mamba2-370m (48 SSD layers, d 1024, 32 SSM heads of 64,
    state 128; 367.6 M parameters: 0.74 GB of bf16 weights) and then
    hymba-1.5b (32 layers, each attention of 25 heads of 64 over 5, windows
    of 1024 but on layers 0, 15 and 31, beside an SSD block of 50 heads,
    state 16; 1.589 B parameters: 3.18 GB) through the CLI as ``ar``
    drives olmo-1b, each after every earlier engine is freed."""
    return _serve_archs(torch, SSM_ARCHS, "ssm")


def _serve_archs(torch, archs, path):
    """``_serve_ar`` for each (arch, seed) in turn, each after every
    earlier engine is freed. The phase's launches are the archs' summed;
    each arch's own are in its record."""
    runs, total, extra = [], {}, {}
    for arch, seed in archs:
        gc.collect()
        torch.cuda.empty_cache()
        runs.append(_serve_ar(torch, arch, seed, path))
        _add_launches(total, runs[-1]["launches"])
        extra.update(runs[-1].pop("extra_launches", {}))
    energy = [e for r in runs for e in r.pop("energy")]
    return dict(launches=total, archs=runs, energy=energy,
                extra_launches=extra)


def phase_moe(torch):
    """Full-width deepseek-moe-16b (28 layers, d 2048, 16 heads of 128, 2
    shared + 64 routed experts of 1408, top-6; 16.9 B parameters: 33.8 GB
    of bf16 weights) through the CLI as ``ar`` drives olmo-1b, after every
    earlier engine is freed."""
    gc.collect()
    torch.cuda.empty_cache()
    return _serve_ar(torch, MOE_ARCH, 23, "moe")


def _serve_ar(torch, arch, seed, path):
    """One full-width autoregressive arch through the CLI: its weights
    from ``transformer.init_weights`` on the card (no f32 masters), 2
    requests at bucket 2, 16 tokens, window 4, stat_abft then faulty at
    undervolt; exact launch counts, detections, rollbacks, token match
    1.0, ledgers; then ms per decode step and a profiled request. An SSM
    arch has no protected GEMM and no attention: no launch, no detection,
    no rollback, one evaluation a token, and its faulty tokens are the
    clean ones. Peak memory is read over the init and over the two runs.
    The engine is freed before it returns."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.serving import DriftServeEngine, ar

    dev = torch.device("cuda")
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    held0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = DriftServeEngine(arch=arch, smoke=False, bucket=BUCKET,
                           device="cuda")
    params = transformer.init_weights(cfg, seed, dev)
    eng.set_params(arch, False, params)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    weights_bytes = torch.cuda.memory_allocated() - held0
    init_peak = torch.cuda.max_memory_allocated()

    argv = ["--arch", arch, "--no-smoke", "--batch", str(BUCKET),
            "--steps", str(AR_STEPS), "--requests", "2",
            "--rollback-interval", str(AR_WINDOW), "--op", "undervolt",
            "--device", "cuda"]
    # each batch's decode (stat_abft, its clean reference, faulty): the
    # NaN-residual rows it rolled back on beside its detections
    decode, batches = ar.decode_batch, []

    def recording_decode(*args, **kw):
        out = decode(*args, **kw)
        batches.append(dict(detections=out.detections,
                            nan_rows=out.nan_rows, rollbacks=out.rollbacks,
                            evals=out.n_model_evals))
        return out
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    ar.decode_batch = recording_decode
    try:
        t0 = time.perf_counter()
        stat = serve.main(argv + ["--mode", "stat_abft"], engine=eng)
        torch.cuda.synchronize()
        t_stat = time.perf_counter() - t0
        t0 = time.perf_counter()
        faulty = serve.main(argv + ["--mode", "faulty"], engine=eng)
        torch.cuda.synchronize()
        t_faulty = time.perf_counter() - t0
    finally:
        ar.decode_batch = decode
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()

    # Layer 0 (the first-block class) and steps below nominal_steps run at
    # BER 0 and launch nothing; stat_abft's primary pass and the faulty
    # pass are faulted, replays and the clean reference are not.
    faulted_steps = sum(1 for i in range(1, AR_STEPS)
                        if i >= eng.nominal_steps)
    # protected GEMMs a faulted layer: attn q/k/v/o, and the dense or
    # hybrid MLP's gate/up/down (the MoE experts and the SSD blocks are
    # unprotected; an SSM layer has neither attention nor MLP)
    ssm = cfg.family == "ssm"
    per_step = (cfg.n_layers - 1) * {"moe": 4, "ssm": 0}.get(cfg.family, 7)
    prefills = 3                 # stat_abft, its clean reference, faulty
    want = {"fault_inject": 2 * faulted_steps * per_step,
            "flash_attention": prefills * (0 if ssm else cfg.n_layers),
            "abft_matmul": 0, "rollback_correct": 0,
            "drift_gemm_fused": 0, "stat_abft_matmul": 0}
    if launches != want:
        raise AssertionError(f"{arch} launch counts {launches} != {want}")
    reqs = []
    for mode, results in (("stat_abft", stat), ("faulty", faulty)):
        for r in results:
            if len(r.tokens) != AR_STEPS or r.latents is not None:
                raise AssertionError(f"{arch} {mode} request "
                                     f"{r.request_id}: {len(r.tokens)} "
                                     "tokens")
            if ssm and (r.ar_detections, r.ar_rollbacks,
                        r.token_match_vs_clean, r.n_model_evals) != (
                            0, 0, 1.0, AR_STEPS):
                raise AssertionError(
                    f"{arch} {mode} request {r.request_id}: detections "
                    f"{r.ar_detections}, rollbacks {r.ar_rollbacks}, match "
                    f"{r.token_match_vs_clean}, evals {r.n_model_evals}")
            if mode == "stat_abft" and not ssm and not (
                    r.ar_detections > 0 and r.ar_rollbacks >= 1
                    and r.token_match_vs_clean == 1.0
                    and r.n_model_evals > AR_STEPS):
                raise AssertionError(
                    f"stat_abft request {r.request_id}: detections "
                    f"{r.ar_detections}, rollbacks {r.ar_rollbacks}, match "
                    f"{r.token_match_vs_clean}, evals {r.n_model_evals}")
            if mode == "faulty" and r.ar_rollbacks != 0:
                raise AssertionError("faulty mode rolled back")
            reqs.append(dict(mode=mode, request_id=r.request_id,
                             tokens=list(r.tokens),
                             token_match_vs_clean=r.token_match_vs_clean,
                             ar_detections=r.ar_detections,
                             ar_rollbacks=r.ar_rollbacks,
                             n_model_evals=r.n_model_evals,
                             monitor_ber=r.monitor_ber,
                             monitor_op_index=r.monitor_op_index))
    (clean,) = eng._clean_samples.values()
    energy = (check_energy(path, f"{arch} stat_abft", stat)
              + check_energy(path, f"{arch} faulty", faulty))
    for r in stat:
        if (r.energy_breakdown["compute_replay"] > 0) != (r.ar_rollbacks > 0):
            raise AssertionError(f"stat_abft request {r.request_id}: "
                                 f"{r.ar_rollbacks} rollbacks billed "
                                 f"{r.energy_breakdown['compute_replay']} J "
                                 "of compute_replay")
    out = dict(arch=arch, family=cfg.family, layers=cfg.n_layers,
               d_model=cfg.d_model,
               heads=None if ssm else [cfg.n_heads, cfg.kv_heads, cfg.hd],
               d_ff=cfg.d_ff,
               vocab=cfg.vocab, params=transformer.param_count(cfg),
               n_params=_meta_params(cfg),
               bucket=BUCKET, steps=AR_STEPS, window=AR_WINDOW,
               setup_s=setup_s, stat_abft_run_s=t_stat,
               faulty_run_s=t_faulty, held_before_bytes=held0,
               weights_bytes=weights_bytes,
               init_peak_mem_bytes=init_peak, peak_mem_bytes=peak,
               launches=launches, requests=reqs, decode_batches=batches,
               energy=energy,
               clean_tokens=clean.tolist(), builds=eng.cache.builds,
               step_ms=_ar_step_ms(torch, eng, arch, cfg),
               breakdown=_profile_ar(torch, eng, argv))
    if arch in DECODE_PATHS:
        key, path_name, fn = DECODE_PATHS[arch]
        out[key], launches = fn(torch, eng, arch, cfg)
        out["extra_launches"] = {path_name: launches}
    if cfg.family in ("ssm", "hybrid"):
        out["ssm"] = dict(heads=cfg.ssm_heads, head_dim=cfg.ssm_head_dim,
                          state=cfg.ssm_state, chunk=cfg.ssm_chunk)
    out["peak_mem_bytes_with_timing"] = torch.cuda.max_memory_allocated()
    del eng, params, stat, faulty, clean
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _ar_step_ms(torch, eng, arch, cfg):
    """Per mode: host wall ms per decode step, each ended by a
    synchronize, over the faulted steps of one pass (a decoder built the
    way the engine builds it, on the engine's prepared weights: a second
    copy of gemma3-27b's 56.6 GB would not fit beside the first), and the
    device kernels one more faulted step runs, counted by the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import dvfs, fault
    from repro_torch.serving import ar
    (_, weights), = eng.servable_for(arch)._weights.values()
    tokens = ar.prompt_tokens(cfg, [0, 1], eng.device)
    schedule = dvfs.fine_grained_schedule(STEP_MS_STEPS + 1,
                                          dvfs.UNDERVOLT,
                                          nominal_steps=eng.nominal_steps)
    out = {}
    for mode in ("clean", "faulty", "stat_abft"):
        fns = ar.make_decoder(cfg, ar.DecodeConfig(STEP_MS_STEPS + 1,
                                                   AR_WINDOW, mode,
                                                   eng.monitor_target_ber),
                              schedule=schedule)
        src = fault.PhiloxFlipSource(3, 0, eng.device)
        monitor = dvfs.ber_monitor_init(eng.device)
        tok, cache = fns.prefill(weights, tokens)
        torch.cuda.synchronize()
        times = []
        for i in range(1, STEP_MS_STEPS):
            t0 = time.perf_counter()
            tok, cache, monitor, *_ = fns.step(weights, cache, tok, i,
                                               monitor, src, 1.0)
            torch.cuda.synchronize()
            if i >= eng.nominal_steps:
                times.append(1e3 * (time.perf_counter() - t0))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fns.step(weights, cache, tok, STEP_MS_STEPS, monitor, src, 1.0)
            torch.cuda.synchronize()
        kernels = sum(ev.count for ev in prof.key_averages()
                      if getattr(ev, "self_device_time_total",
                                 getattr(ev, "self_cuda_time_total", 0)) > 0)
        out[mode] = dict(ms=sum(times) / len(times), kernels=kernels)
    return out


def _profile_ar(torch, eng, argv):
    """Device time by kernel over one more stat_abft request of
    PROFILE_AR_STEPS tokens (its primary pass, replays and clean
    reference); ``profile_s`` is the whole measurement, the trace's
    processing included."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    argv = argv + ["--mode", "stat_abft", "--requests", "1", "--seed", "100",
                   "--steps", str(PROFILE_AR_STEPS)]
    t_all = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        (res,) = serve.main(argv, engine=eng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    fi = sum(r[0] for r in rows if "fault_inject" in r[1]) / 1e6
    return dict(what=f"1 stat_abft request at bucket 2, {PROFILE_AR_STEPS} "
                     "tokens: prefill, its faulted steps and replays, plus "
                     "its clean reference", wall_s=wall,
                profile_s=time.perf_counter() - t_all, device_busy_s=busy,
                token_match_vs_clean=res.token_match_vs_clean,
                ar_detections=res.ar_detections,
                ar_rollbacks=res.ar_rollbacks,
                device_busy_share=busy / wall, fault_inject_s=fi,
                fault_inject_share_of_busy=fi / busy if busy else None,
                n_kernels=sum(r[2] for r in rows),
                top=[dict(kernel=k[:80], device_s=us / 1e6, calls=c)
                     for us, k, c in rows[:12]])


def _serve_counted(torch, serve, eng, argv, counters):
    """One ``serve.main`` run with every launch counter zeroed just before
    and read just after: (results, launches, wall seconds)."""
    for mod in counters.values():
        mod.launches = 0
    t0 = time.perf_counter()
    res = serve.main(argv, engine=eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, {k: mod.launches for k, mod in counters.items()}, wall


def _counters():
    from repro_torch.kernels import abft_matmul as ak
    from repro_torch.kernels import fault_inject as fik
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops
    from repro_torch.kernels import rollback_correct as rk
    from repro_torch.kernels import stat_abft as sk
    return {"abft_matmul": ak, "rollback_correct": rk,
            "drift_gemm_fused": ops, "flash_attention": fk,
            "fault_inject": fik, "stat_abft_matmul": sk}


def _add_launches(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def phase_baselines(torch):
    """The full-width DiT-XL/2-512 serves the same 2 seeds at undervolt for
    10 steps in each Fig 12 baseline through the CLI, counters zeroed
    around each run. The first run also computes the clean reference
    (drift at BER 0, the fused drift kernel); no baseline launches it.
    dmr's
    finals must equal the clean reference's bit for bit (the same
    arithmetic on the same kernels: c ^ flips is the clean accumulator).
    Then one evaluation per mode, drift included, at the first undervolted
    step with the engine's masks, for its recovery costs."""
    from repro_torch.configs import get_config
    from repro_torch.core import dvfs
    from repro_torch.core.exec_ctx import DriftSystemConfig
    from repro_torch.launch import serve
    from repro_torch.models import dit
    from repro_torch.serving import DriftServeEngine

    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    eng = DriftServeEngine(arch=ARCH, smoke=False, bucket=BUCKET,
                           device="cuda")
    params = _perturb(torch, dit.init_params(cfg, 11, dev), cfg, 12, dev)
    eng.set_params(ARCH, False, params)
    argv = ["--arch", ARCH, "--no-smoke", "--batch", str(BUCKET),
            "--steps", str(SERVE_STEPS), "--requests", "2", "--op",
            "undervolt", "--device", "cuda"]
    counters = _counters()
    gemms = sum(p[4] for p in path_gemms(cfg, BUCKET))          # 172
    total, modes, energy = {}, {}, []
    for i, mode in enumerate(BASELINE_MODES):
        res, launches, wall = _serve_counted(
            torch, serve, eng, argv + ["--mode", mode], counters)
        runs = 1 if i else 2                  # + the clean reference
        want = {"abft_matmul": gemms * SERVE_STEPS, "rollback_correct": 0,
                "drift_gemm_fused": gemms * SERVE_STEPS * (runs - 1),
                "flash_attention": cfg.n_layers * SERVE_STEPS * runs,
                "fault_inject": 0, "stat_abft_matmul": 0}
        if launches != want:
            raise AssertionError(f"{mode} launch counts {launches} != "
                                 f"{want}")
        _add_launches(total, launches)
        (clean,) = eng._clean_samples.values()
        reqs = []
        for slot, r in enumerate(res):
            if r.n_model_evals != SERVE_STEPS or r.mode != mode:
                raise AssertionError(f"{mode} request {r.request_id}: "
                                     f"{r.n_model_evals} evaluations")
            if mode == "dmr" and not (torch.equal(r.latents, clean[slot])
                                      and r.batch_corrected_elems == 0):
                raise AssertionError("dmr finals differ from the clean "
                                     "reference's")
            if mode != "dmr" and r.batch_corrected_elems <= 0:
                raise AssertionError(f"{mode} corrected nothing")
            reqs.append(dict(request_id=r.request_id,
                             psnr_vs_clean_db=r.psnr_vs_clean_db,
                             lpips_vs_clean=r.lpips_vs_clean,
                             batch_corrected_elems=r.batch_corrected_elems,
                             finite=bool(torch.isfinite(r.latents).all()),
                             equal_to_clean=bool(torch.equal(
                                 r.latents, clean[slot]))))
        energy += check_energy("baselines", mode, res)
        modes[mode] = dict(run_s=wall, launches=launches, requests=reqs)

    # One evaluation per mode at the first undervolted step.
    step = eng.nominal_steps
    ber = dvfs.fine_grained_schedule(
        SERVE_STEPS, dvfs.UNDERVOLT,
        nominal_steps=eng.nominal_steps).ber_table[step]
    latents, cond = eng.servable.batch_inputs(cfg, [0, 1])
    t = torch.full((BUCKET,), 500.0, device=dev)
    for mode in ("drift",) + BASELINE_MODES:
        embed, block = dit.drift_store_spec(cfg, BUCKET, dev)
        ds = dit.DriftState(cfg=DriftSystemConfig(mode=mode),
                            flip_source=eng.flip_source_factory(0),
                            step=step, ber_by_class=ber, embed_store=embed,
                            block_store=block, have_ckpt=True)
        with torch.no_grad():
            _, st = dit.forward(cfg, params, latents, t, cond, drift=ds)
        modes.setdefault(mode, {})["per_eval"] = dict(
            step=step, corrected_elems=int(st["corrected_elems"]),
            detected_row_errors=int(st["detected_row_errors"]),
            extra_compute_flops=float(st["extra_compute_flops"]),
            extra_dram_bytes=float(st["extra_dram_bytes"]))
        del embed, block
    return dict(arch=ARCH, bucket=BUCKET, steps=SERVE_STEPS, modes=modes,
                launches=total, energy=energy,
                note="per_eval: one evaluation at the first undervolted "
                     "step, the engine's batch-0 masks, stores at zero; "
                     "extra_compute_flops / extra_dram_bytes are the "
                     "reference's modeled recovery costs (core.baselines)")


def _family_counts(cfg):
    """(protected GEMMs, attention-kernel launches) per evaluation."""
    from repro_torch.models import unet
    if cfg.family == "unet":
        return unet.protected_gemms(cfg), len(unet.attention_sites(cfg))
    per_block = 6 + (4 if cfg.cond_tokens else 0)
    embed = 4 + (1 if cfg.cond_tokens else 0)
    return cfg.n_layers * per_block + embed, cfg.n_layers


# (label, M, K, N) of the protected GEMMs the DiT path does not have, at
# bucket 2, M and N padded to the 32x32 checksum tile as the kernel sees
# them; and the UNet's self-attention calls (B, S, H, D).
FAMILY_GEMMS = (("pixart text", 256, 4096, 1152),
                ("pixart xattn.k/v", 256, 1152, 1152),
                ("unet 32x32 q/k/v/o", 2048, 640, 640),
                ("unet 16x16 q/k/v/o", 512, 1280, 1280),
                ("unet cross.k/v 640", 160, 768, 640),
                ("unet cross.k/v 1280", 160, 768, 1280))
FAMILY_ATTN = ((2, 1024, 10, 64), (2, 256, 20, 64))


def _family_kernel_rows(torch, reps: int):
    """``abft_matmul`` at ``FAMILY_GEMMS`` (flips at BER 3e-3 plus a bit-31
    flip; all five outputs bit-equal to the plain version) and
    ``mha_flash`` at ``FAMILY_ATTN`` in bf16 (within 1e-2 of the plain
    version): device ms per launch beside the bound, the plain version's
    ms and the library call's (``torch._int_mm``, the bare product, and
    SDPA)."""
    import torch.nn.functional as F
    from repro_torch.core import fault
    from repro_torch.kernels import abft_matmul as ak
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.models.attention import full_attention
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(20261017)
    src = fault.PhiloxFlipSource(base_seed=9, batch_index=0, device=dev)
    gemm_rows, attn_rows = [], []
    for i, (name, m, k, n) in enumerate(FAMILY_GEMMS):
        aq = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                           dtype=torch.int8)
        bq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                           dtype=torch.int8)
        flips = src(fault.FaultSite(0, i, name), (m, n), 3e-3)
        flips[m // 2, n // 3] = -2 ** 31
        got = ak.abft_matmul(aq, bq, flips)
        want = ak.abft_matmul_plain(aq, bq, flips)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"abft_matmul {name} differs from its "
                                 "plain version")
        work = ak.work(m, k, n)
        bytes_, ops = work["bytes"], work["int8_ops"]
        t_b, t_o = bytes_ / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
        ring = ring_of((aq, bq, flips), bytes_)
        try:
            int_mm = device_ms(torch._int_mm, [r[:2] for r in ring], reps)
        except RuntimeError:                       # shape it does not take
            int_mm = None
        gemm_rows.append(dict(
            name=name, m=m, k=k, n=n, max_abs_err=max_abs_err(got, want),
            ms=device_ms(ak.abft_matmul, ring, reps, "abft_matmul"),
            plain_ms=device_ms(ak.abft_matmul_plain, ring,
                               max(1, reps // 4)),
            bound_ms=1e3 * max(t_b, t_o),
            bound_by="bytes" if t_b >= t_o else "operations",
            int_mm_ms=int_mm))
        del ring

    def plain(q_, k_, v_):
        return full_attention(q_, k_, v_, causal=False)
    for shape in FAMILY_ATTN:
        b, s_, h, d = shape
        q, k, v = (torch.randn(shape, generator=g, device=dev
                               ).to(torch.bfloat16) for _ in range(3))
        got = fk.mha_flash(q, k, v)
        want = plain(q, k, v)
        torch.cuda.synchronize()
        if not torch.allclose(got.float(), want.float(), atol=1e-2,
                              rtol=1e-2):
            raise AssertionError(f"mha_flash at {shape}: max abs err "
                                 f"{max_abs_err([got], [want])}")
        work = fk.work(b, s_, h, h, d, q.element_size())
        flops, bytes_ = work["flops"], work["bytes"]
        t_o, t_b = flops / BF16_FLOPS_PER_S, bytes_ / HBM_BYTES_PER_S
        ring = ring_of((q, k, v), bytes_)
        lib_ring = [tuple(x.transpose(1, 2) for x in r) for r in ring]
        attn_rows.append(dict(
            shape=list(shape), dtype="bfloat16",
            max_abs_err=max_abs_err([got], [want]),
            ms=device_ms(fk.mha_flash, ring, reps, "flash_attention"),
            plain_ms=device_ms(plain, ring, reps),
            library_ms=device_ms(F.scaled_dot_product_attention, lib_ring,
                                 reps),
            bound_ms=1e3 * max(t_o, t_b),
            bound_by="operations" if t_o >= t_b else "bytes"))
        del ring, lib_ring
    return gemm_rows, attn_rows


def phase_families(torch, reps: int):
    """Full-width PixArt-alpha (28 layers, d 1152, 120 x 4096 stub text)
    and the SD1.5 UNet (channels 320/640/1280, 64 x 64 latents, 77 x 768
    stub text) each serve 2 requests through the CLI in drift and then in
    faulty at undervolt for 10 steps, counters zeroed around each run:
    exact launch counts per evaluation, finite drift latents, each
    result's ledger. Then a profiled drift request per arch, and the
    kernels at the GEMM and attention shapes these archs add."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import dit, unet
    from repro_torch.models.common import count_params
    from repro_torch.serving import DriftServeEngine

    dev = torch.device("cuda")
    counters = _counters()
    total, archs, energy = {}, {}, []
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch)
        model = unet if cfg.family == "unet" else dit
        t0 = time.perf_counter()
        eng = DriftServeEngine(arch=arch, smoke=False, bucket=BUCKET,
                               device="cuda")
        params = _perturb_any(torch, model.init_params(cfg, 11, dev), cfg,
                              12, dev)
        eng.set_params(arch, False, params)
        n_params = count_params(params)
        del params
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        argv = ["--arch", arch, "--no-smoke", "--batch", str(BUCKET),
                "--steps", str(SERVE_STEPS), "--requests", "2", "--op",
                "undervolt", "--device", "cuda"]
        gemms, attn = _family_counts(cfg)
        torch.cuda.reset_peak_memory_stats()
        runs, reqs = {}, []
        for mode in ("drift", "faulty"):
            res, launches, wall = _serve_counted(
                torch, serve, eng, argv + ["--mode", mode], counters)
            passes = 2 if mode == "drift" else 1    # + clean reference
            drift = mode == "drift"
            want = {"abft_matmul": 0 if drift else gemms * SERVE_STEPS,
                    "rollback_correct": 0,
                    "drift_gemm_fused": gemms * SERVE_STEPS * 2 * drift,
                    "flash_attention": attn * SERVE_STEPS * passes,
                    "fault_inject": 0, "stat_abft_matmul": 0}
            if launches != want:
                raise AssertionError(f"{arch} {mode} launch counts "
                                     f"{launches} != {want}")
            _add_launches(total, launches)
            runs[mode] = dict(run_s=wall, launches=launches)
            for r in res:
                finite = bool(torch.isfinite(r.latents).all())
                if mode == "drift" and not (
                        finite and r.batch_corrected_elems > 0
                        and r.n_model_evals == SERVE_STEPS):
                    raise AssertionError(
                        f"{arch} drift request {r.request_id}: finite "
                        f"{finite}, corrected {r.batch_corrected_elems}")
                if mode == "faulty" and r.batch_corrected_elems != 0:
                    raise AssertionError(f"{arch} faulty corrected")
                reqs.append(dict(mode=mode, request_id=r.request_id,
                                 psnr_vs_clean_db=r.psnr_vs_clean_db,
                                 lpips_vs_clean=r.lpips_vs_clean,
                                 batch_corrected_elems=r.
                                 batch_corrected_elems,
                                 monitor_ber=r.monitor_ber, finite=finite,
                                 detect_rows=len(r.detect_heatmap)))
            energy += check_energy("families", f"{arch} {mode}", res)
        for clean in eng._clean_samples.values():
            if not bool(torch.isfinite(clean).all()):
                raise AssertionError(f"{arch}: non-finite clean reference")
        archs[arch] = dict(
            layers=cfg.n_layers, d_model=cfg.d_model, n_params=n_params,
            **_store_sizes(cfg), unet_channels=list(cfg.unet_channels),
            cond=[cfg.cond_tokens, cfg.cond_dim], setup_s=setup_s,
            gemms_per_eval=gemms, attention_per_eval=attn, runs=runs,
            requests=reqs, peak_mem_bytes=torch.cuda.max_memory_allocated(),
            breakdown=_profile_request(torch, eng, argv))
        del eng
    gemm_rows, attn_rows = _family_kernel_rows(torch, reps)
    return dict(bucket=BUCKET, steps=SERVE_STEPS, archs=archs,
                launches=total, energy=energy,
                abft_matmul_shapes=gemm_rows, mha_flash_shapes=attn_rows,
                note="abft_matmul_shapes: the GEMM shapes PixArt and the "
                     "UNet add (M, N padded to the tile); int_mm_ms is the "
                     "bare int8 product, a yardstick; mha_flash_shapes: "
                     "the UNet's self-attention, library_ms bf16 SDPA")


# ---------------------------------------------- resilience (slice 21)
# The paper's Sec 4 probes (``examples.resilience_study``) at full width,
# a subset of each sweep: Fig 4's bits, Fig 5's faulted steps, Fig 6's
# sites; Fig 7's three trajectories whole.
RES_BITS = (0, 10, 30)
RES_STEPS = (0, 8)
RES_SITES = ("embed", 0, 27)
# SMOKE card against CPU, every probe whole at RES_SMOKE_STEPS steps, the
# step count of the CPU tests against the reference
# (``tests/test_torch_resilience.py``), and their limits: lpips, ssim and
# clip within RES_RTOL relative plus RES_ATOL; psnr as the mean squared
# error it encodes (4 * 10^(-psnr / 10), latents in [-1, 1]) within
# RES_RTOL relative plus RES_MSE_ATOL, since near clean a tiny gap moves it
# by many dB; each trajectory value within RES_TRAJ_ATOL; non-finite on
# one side only fails. The f32 model's int8 products are exact and the
# rest sums in other orders; from step 4 of 10 on, a rounding that tips
# an int8 level grows through the chain (card against CPU, and the port
# against the reference alike, up to ~4e-2 on a trajectory by step 9),
# which 4 steps mostly stay ahead of. At 4 steps a jump of that kind
# still shows in a sample or two whose faults are large (on the H100: 2
# of 23 samples, 3.2e-3 at most, every other number within ~1e-6): at
# most RES_TIPPED_MAX samples may leave the limits above ("tipped"),
# each number of theirs within RES_TIP_ATOL.
RES_SMOKE_STEPS = 4
RES_RTOL, RES_ATOL, RES_MSE_ATOL, RES_TRAJ_ATOL = 1e-3, 1e-6, 1e-7, 1e-4
RES_TIPPED_MAX, RES_TIP_ATOL = 3, 1e-2
# the clean reference scored against itself: psnr at the 1e-12 clamp
RES_CLAMP_PSNR = 10 * math.log10(4 / 1e-12)


class _KernelTally:
    """A ``kernels._count`` counter that tallies each wrapper's kernel
    calls and nothing else: no dispatch mode, so it costs nothing. A call
    on the card counts here and at its launch; a plain version would
    count here alone."""

    def __init__(self):
        self.kernels = {}

    def add_kernel(self, name, work):
        self.kernels[name] = self.kernels.get(name, 0) + 1

    def paused(self):
        import contextlib
        return contextlib.nullcontext()


def _res_want(cfg, mode: str, steps: int):
    """Launches of one sample of the class-conditional DiT: every
    protected GEMM of every evaluation one ``abft_matmul`` (faulty) or
    one ``drift_gemm_fused`` (clean: drift at BER 0), one attention a
    block."""
    gemms = (6 * cfg.n_layers + 4) * steps
    return {"abft_matmul": gemms * (mode == "faulty"),
            "rollback_correct": 0,
            "drift_gemm_fused": gemms * (mode == "clean"),
            "flash_attention": cfg.n_layers * steps,
            "fault_inject": 0, "stat_abft_matmul": 0}


def _res_study(torch, rs, cfg, params, inputs, bits, steps, sites,
               flip_source, n: int, check=None):
    """The four probes on ``(cfg, params, inputs)`` at ``n`` steps: the
    clean reference first, then each point and trajectory as its own
    sample. ``check(label, mode, fn)`` runs each sample (the launch
    checks on the card); None runs it as it is."""
    run = check or (lambda label, mode, fn: fn())
    run("clean reference", "clean",
        lambda: rs.clean_reference(cfg, params, inputs, n))
    out = dict(bits={}, steps={}, blocks={}, selfheal={})
    for bit in bits:
        out["bits"][bit] = run(f"bit {bit}", "faulty", lambda: rs.bit_sweep(
            cfg, params, inputs, [bit], n, flip_source)[bit])
    for step in steps:
        out["steps"][step] = run(f"step {step}", "faulty", lambda: rs.
                                 step_sweep(cfg, params, inputs, [step], n,
                                            flip_source)[step])
    for site in sites:
        out["blocks"][site] = run(f"site {site}", "faulty", lambda: rs.
                                  block_sweep(cfg, params, inputs, [site], n,
                                              flip_source)[site])
    heal = {"clean": ("clean", None), **{
        name: ("faulty", rs.schedule_single_step(ber, rs.HEAL_STEP, n))
        for name, ber in rs.HEAL_BERS}}
    for name, (mode, sched) in heal.items():
        out["selfheal"][name] = run(
            f"selfheal {name}", mode, lambda: rs.trajectory(
                cfg, params, inputs, mode, sched, n, flip_source))
    return out


def _res_gaps(got, want):
    """``got`` (card) against ``want`` (CPU): per metric the largest gap
    and where; the samples outside the RES_ limits but within
    RES_TIP_ATOL ("tipped"); and what fails: a number outside both, or
    more than RES_TIPPED_MAX tipped samples."""
    import numpy as np
    gaps, bad, tipped = {}, [], {}

    def close(where, key, a, b, rtol, atol):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if not (np.array_equal(np.isfinite(a), np.isfinite(b))
                and np.array_equal(np.isnan(a), np.isnan(b))):
            bad.append(f"{where} {key}: card {a}, CPU {b}: finite on one "
                       "side")
            return
        fin = np.isfinite(a)
        gap = np.abs(a[fin] - b[fin])
        if gap.size and gap.max() >= gaps.get(key, (0.0,))[0]:
            gaps[key] = (float(gap.max()), where)
        if (gap > RES_TIP_ATOL).any():
            bad.append(f"{where} {key}: card {a}, CPU {b}")
        elif (gap > atol + rtol * np.abs(b[fin])).any():
            tipped.setdefault(where, {})[key] = float(gap.max())

    def mse(psnr):
        return 4.0 * 10.0 ** (-np.float64(psnr) / 10.0)
    for probe in ("bits", "steps", "blocks"):
        for point, q in want[probe].items():
            g, where = got[probe][point], f"{probe} {point}"
            for key in ("lpips", "ssim", "clip"):
                close(where, key, g[key], q[key], RES_RTOL, RES_ATOL)
            close(where, "mse", mse(g["psnr"]), mse(q["psnr"]), RES_RTOL,
                  RES_MSE_ATOL)
    for name, traj in want["selfheal"].items():
        close(f"selfheal {name}", "trajectory", got["selfheal"][name],
              traj, 0, RES_TRAJ_ATOL)
    if len(tipped) > RES_TIPPED_MAX:
        bad.append(f"{len(tipped)} samples outside the limits: {tipped}")
    return gaps, tipped, bad


def _res_view(out) -> dict:
    """The probes' numbers as JSON: quality per point, trajectories."""
    return {probe: {str(k): ([float(x) for x in v] if probe == "selfheal"
                             else {m: float(x) for m, x in v.items()})
                    for k, v in out[probe].items()} for probe in out}


def _res_phenomena(rs, out) -> dict:
    """Whether a run shows each of the paper's Sec 4 phenomena (recorded,
    never asserted: the weights are random): the lpips of every bit at
    or below the ABFT threshold bit under half the top bit's; the first
    faulted step's lpips above the last's; the embeddings' and block 0's
    above the deepest block's; the small error's trajectory healed."""
    from repro_torch.core.abft import AbftConfig
    bits, steps, sites = out["bits"], out["steps"], out["blocks"]
    low = [k for k in bits if k <= AbftConfig().threshold_bit]
    s = sorted(steps)
    deep = max(k for k in sites if k != "embed")
    heal = rs.heal_summary(out["selfheal"])
    return dict(
        low_bits_harmless=bool(max(bits[k]["lpips"] for k in low)
                               < 0.5 * bits[max(bits)]["lpips"]),
        early_steps_fragile=bool(steps[s[0]]["lpips"]
                                 > steps[s[-1]]["lpips"]),
        embed_and_first_block_fragile=bool(
            min(sites["embed"]["lpips"], sites[0]["lpips"])
            > sites[deep]["lpips"]),
        small_errors_heal=heal["small_err"]["healed"], heal=heal)


def phase_resilience(torch, smi):
    """The paper's Sec 4 resilience analysis (``examples.resilience_study``)
    on the card. At full width, ``configs/dit_xl_512.py::FULL`` from
    ``tiny_model``'s recipe (random init, the adaLN and final weights
    perturbed; drawn on the card) at bucket 2, 10 DDIM steps: the clean
    reference, Fig 4 at RES_BITS, Fig 5 at RES_STEPS, Fig 6 at RES_SITES
    and Fig 7's three trajectories, masks drawn on the card. Each sample
    runs with the counters zeroed just before and read just after, its
    launches exact (``_res_want``) and equal to the kernel calls the op
    counter's hook (``kernels._count``, ``_KernelTally``) saw: every call
    reached its CUDA launch, none ran a plain version. The clean
    reference against itself gives lpips 0, psnr at the clamp and ssim
    1; every full-width number is finite or NaN. Whether each of the four
    phenomena shows is recorded, not asserted. Then every probe whole at
    SMOKE and RES_SMOKE_STEPS steps on the card and on the CPU, with the
    same params, inputs and CPU-drawn masks: the card's numbers within
    the RES_ limits of the CPU's, launches exact on the card."""
    from repro_torch.configs import get_config
    from repro_torch.core import fault
    from repro_torch.examples import resilience_study as rs
    from repro_torch.kernels import _count

    total, timings, walls = {}, {}, {}

    def counted(cfg, steps):
        def run(label, mode, fn):
            _zero_launches()
            tally = _KernelTally()
            t0 = time.perf_counter()
            _count.COUNTER = tally
            try:
                out = fn()
            finally:
                _count.COUNTER = None
            torch.cuda.synchronize()
            timings[f"{cfg.name} {label}"] = time.perf_counter() - t0
            got = _launch_counts()
            want = _res_want(cfg, mode, steps)
            if got != want:
                raise AssertionError(f"resilience {cfg.name} {label}: "
                                     f"launches {got} != {want}")
            if tally.kernels != {k: v for k, v in got.items() if v}:
                raise AssertionError(f"resilience {cfg.name} {label}: "
                                     f"kernel calls {tally.kernels} != "
                                     f"launches {got}")
            _add_launches(total, got)
            return out
        return run

    # full width
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, params = rs.tiny_model(ARCH, "cuda", smoke=False)
    inputs = rs.sample_inputs(cfg, rs.BATCH, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    full = _res_study(torch, rs, cfg, params, inputs, RES_BITS, RES_STEPS,
                      RES_SITES, fault.PhiloxFlipSource(rs.SEED + 2, 0,
                                                        "cuda"),
                      rs.STEPS, counted(cfg, rs.STEPS))
    peak = torch.cuda.max_memory_allocated()
    ref = rs.clean_reference(cfg, params, inputs, rs.STEPS)
    self_q = rs.quality_vs_clean(ref, cfg, params, inputs, rs.STEPS)
    if not (self_q["lpips"] == 0.0
            and abs(self_q["psnr"] - RES_CLAMP_PSNR) < 1e-3
            and abs(self_q["ssim"] - 1.0) < 1e-6):
        raise AssertionError(f"resilience: clean against itself {self_q}")
    walls["full"] = time.perf_counter() - t0
    view = _res_view(full)
    bad = [(p, k) for p, rows in view.items() for k, v in rows.items()
           for x in (v if p == "selfheal" else v.values())
           if not (math.isfinite(x) or math.isnan(x))]
    if bad:
        raise AssertionError(f"resilience: infinite numbers at {bad}")
    phen = _res_phenomena(rs, full)
    emit({"phase": "resilience", "part": "full", "card": smi, "arch": ARCH,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "tokens": cfg.tokens, "bucket": rs.BATCH, "steps": rs.STEPS,
          "setup_s": setup_s, "peak_mem_bytes": peak,
          "clean_vs_itself": self_q, "probes": view, "phenomena": phen})
    rs.clear_clean_cache()
    del params, inputs, ref
    gc.collect()
    torch.cuda.empty_cache()

    # SMOKE, card against CPU
    smoke_cfg = get_config(ARCH, smoke=True)
    sites = ("embed", *range(smoke_cfg.n_layers))
    n = RES_SMOKE_STEPS
    smoke = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        c, p = rs.tiny_model(ARCH, dev)
        smoke[dev] = _res_study(
            torch, rs, c, p, rs.sample_inputs(c, rs.BATCH, device=dev),
            rs.BITS, range(0, n, 2), sites,
            fault.PhiloxFlipSource(rs.SEED + 2, 0, "cpu"), n,
            counted(c, n) if dev == "cuda" else None)
        walls[f"smoke {dev}"] = time.perf_counter() - t0
    rs.clear_clean_cache()
    gaps, tipped, bad = _res_gaps(smoke["cuda"], smoke["cpu"])
    emit({"phase": "resilience", "part": "smoke", "card": smi,
          "steps": n, "card_vs_cpu_max_gap": gaps, "tipped": tipped,
          "failed": bad,
          "limits": dict(rtol=RES_RTOL, atol=RES_ATOL,
                         mse_atol=RES_MSE_ATOL, trajectory=RES_TRAJ_ATOL,
                         tipped_max=RES_TIPPED_MAX,
                         tip_atol=RES_TIP_ATOL),
          "probes_card": _res_view(smoke["cuda"]),
          "probes_cpu": _res_view(smoke["cpu"]),
          "phenomena_card": _res_phenomena(rs, smoke["cuda"]),
          "phenomena_cpu": _res_phenomena(rs, smoke["cpu"])})
    if bad:
        raise AssertionError(f"resilience SMOKE card against CPU: {bad}")
    return dict(card=smi, launches=total, energy=[], walls_s=walls,
                samples_s=timings, phenomena=phen, smoke_max_gap=gaps,
                smoke_tipped=tipped,
                note="samples_s: host wall of one sample ended by a "
                     "synchronize, its checks included; walls_s: the "
                     "full-width part (setup included) and each SMOKE "
                     "device's; a quality point's us is its sample alone; "
                     "phenomena are recorded, never asserted: the weights "
                     "are random")


# ------------------------------------------------------------- training
# One arch per family, SMOKE, card against CPU; then olmo-1b (the train
# launcher's default arch) and whisper-base at full width, at the
# launcher's default global batch and sequence length.
TRAIN_SMOKE_ARCHS = ("olmo-1b", "deepseek-moe-16b", "mamba2-370m",
                     "hymba-1.5b", "internvl2-76b", "whisper-base",
                     "dit-xl-512", "sd15-unet")
TRAIN_FULL_ARCHS = ("olmo-1b", "whisper-base")
TRAIN_SMOKE_STEPS, TRAIN_STEPS = 2, 3
TRAIN_BATCH, TRAIN_SEQ = 8, 128
WHISPER_PROMPT, WHISPER_DECODE = 8, 16
# card against CPU over TRAIN_SMOKE_STEPS AdamW steps, f32: loss and grad
# norm within TRAIN_LOSS_RTOL; each gradient leaf within TRAIN_GRAD_RTOL of
# its largest magnitude plus 1e-6 of the largest gradient anywhere; the
# card's update of the CPU's gradient (params and both moments) within
# TRAIN_STATE_RTOL of each leaf's largest magnitude.
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_STATE_RTOL = 1e-4, 1e-3, 1e-6


def attention_layers(cfg) -> int:
    """Attention-kernel launches of one teacher-forcing forward: one per
    whole-sequence self-attention (cross-attention and the SSD blocks run
    plain), and one backward call each."""
    from repro_torch.models import unet
    if cfg.family == "ssm":
        return 0
    if cfg.family == "encdec":
        return cfg.n_encoder_layers + cfg.n_layers
    if cfg.family == "unet":
        return len(unet.attention_sites(cfg))
    return cfg.n_layers


def _nudge_zero(torch, params, seed: int):
    """Seeded small values for every all-zero weight of rank >= 2 (the
    diffusion models' adaLN-Zero and output weights), so that every block
    has a gradient."""
    from repro_torch.tree import tree_map
    g = torch.Generator()
    g.manual_seed(seed)

    def nudge(t):
        if t.ndim >= 2 and not bool(t.any()):
            return 0.05 * torch.randn(t.shape, generator=g)
        return t
    return tree_map(nudge, params)


def _train_smoke(torch, arch: str, seed: int):
    """SMOKE ``arch``: TRAIN_SMOKE_STEPS AdamW steps from one set of params
    and batches on the CPU and on the card, each step in the two halves
    ``make_train_step`` runs (``steps.value_and_grad``, then
    ``optim.adamw.apply``). At every step the card's loss and gradient
    norm are within TRAIN_LOSS_RTOL of the CPU's, and each of its gradient
    leaves within TRAIN_GRAD_RTOL of the leaf's largest magnitude plus
    1e-6 of the largest gradient anywhere (a gradient that is zero by
    structure, as a SMOKE UNet ``temb_w`` ahead of a GroupNorm of one
    channel a group, is roundoff on each side). The card then applies the
    CPU's gradient, moved to the card, so that its update is held to the
    CPU's on the same numbers: params and both moments within
    TRAIN_STATE_RTOL of each leaf's largest magnitude. (AdamW's first steps
    divide a gradient by its own magnitude, so the two sides' roundoff in
    a gradient near eps would move a param by up to lr; the card's own
    convolution and scatter backward passes are not bit-reproducible
    either.) Attention launches and backward calls exact. cuDNN's TF32 is
    off for the card's f32 convolutions, as in ``phase_reference``."""
    from repro_torch import configs
    from repro_torch.data import synthetic
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.optim import adamw as optim
    from repro_torch.train import steps
    from repro_torch.tree import tree_leaves, tree_map
    cfg = configs.get_config(arch, smoke=True)
    ocfg = optim.OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = _nudge_zero(torch, steps.init_model_params(cfg, seed, "cpu"),
                         seed)
    dcfg = synthetic.for_model(cfg, 2, 16, seed=seed)
    batches = [synthetic.batch_at(dcfg, i) for i in range(TRAIN_SMOKE_STEPS)]
    if cfg.family == "vlm":
        g = synthetic.generator(seed, 99)
        for b in batches:
            b["vis_embeds"] = 0.1 * torch.randn(
                (2, cfg.vis_tokens, cfg.d_model), generator=g)

    def state_leaves(p, opt):
        return [t.cpu() for t in tree_leaves((p, opt.mu, opt.nu))]
    runs, cpu_grads = {}, []
    # f32 against f32: cuDNN would run the UNet's f32 convolutions in TF32
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev), params)
            opt = optim.init(ocfg, p)
            fk.launches = fk.backward_calls = 0
            metrics, grads, states = [], [], []
            for i, b in enumerate(batches):
                loss, _, gr = steps.value_and_grad(
                    cfg, p, {k: v.to(dev) for k, v in b.items()},
                    synthetic.generator(seed, i))
                metrics.append((float(loss), float(optim.global_norm(gr))))
                grads.append([t.cpu() for t in tree_leaves(gr)])
                if dev == "cpu":
                    cpu_grads.append(gr)
                else:
                    gr = tree_map(lambda t: t.to(dev), cpu_grads[i])
                p, opt, _ = optim.apply(ocfg, opt, p, gr)
                states.append(state_leaves(p, opt))
            if dev == "cuda":
                torch.cuda.synchronize()
            runs[dev] = (metrics, grads, states, fk.launches,
                         fk.backward_calls)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (cm, cg, cs, _, _), (gm, gg, gs, launched, bwd) = (runs["cpu"],
                                                       runs["cuda"])
    want = TRAIN_SMOKE_STEPS * attention_layers(cfg)
    if not (launched == bwd == want):
        raise AssertionError(f"train {arch} SMOKE: {launched} attention "
                             f"launches and {bwd} backward calls, want "
                             f"{want} each")
    for (lc, nc), (lg, ng) in zip(cm, gm):
        if not (math.isfinite(lg) and abs(lg - lc) <= TRAIN_LOSS_RTOL
                * abs(lc) and abs(ng - nc) <= TRAIN_LOSS_RTOL * abs(nc)):
            raise AssertionError(f"train {arch} SMOKE: card loss, grad "
                                 f"norm {gm} against the CPU's {cm}")
    worst_g = worst_s = 0.0
    for step, (gc_, gg_, sc_, sg_) in enumerate(zip(cg, gg, cs, gs)):
        top = max(float(t.abs().max()) for t in gc_)
        for a, b in zip(gg_, gc_):
            err = float((a - b).abs().max())
            lim = TRAIN_GRAD_RTOL * float(b.abs().max()) + 1e-6 * top
            worst_g = max(worst_g, err / lim)
            if not err <= lim:
                raise AssertionError(f"train {arch} SMOKE step {step}: a "
                                     f"gradient leaf {tuple(b.shape)} is "
                                     f"{err} off the CPU's (limit {lim})")
        for a, b in zip(sg_, sc_):
            err = float((a - b).abs().max())
            lim = TRAIN_STATE_RTOL * float(b.abs().max())
            worst_s = max(worst_s, err / lim if lim else float(err > 0))
            if not err <= lim:
                raise AssertionError(f"train {arch} SMOKE step {step}: the "
                                     f"card's update of the CPU's gradient "
                                     f"leaves a state leaf {tuple(b.shape)} "
                                     f"{err} off the CPU's (limit {lim})")
    return dict(arch=arch, steps=TRAIN_SMOKE_STEPS, loss_card=[m[0] for m
                in gm], loss_cpu=[m[0] for m in cm],
                grad_norm_card=[m[1] for m in gm],
                grad_norm_cpu=[m[1] for m in cm],
                worst_grad_err_over_limit=worst_g,
                worst_state_err_over_limit=worst_s,
                attention_launches=launched, backward_calls=bwd)


def _tree_sums(torch, tree):
    from repro_torch.tree import tree_leaves
    return [float(t.double().sum()) for t in tree_leaves(tree)]


def _train_full(torch, arch: str, seed: int, root: Path, counters):
    """Full-width ``arch``: TRAIN_STEPS AdamW steps from the port's init on
    the card at global batch TRAIN_BATCH and sequence TRAIN_SEQ (the
    launcher's defaults), each timed with a synchronize. Every loss is
    finite and every param leaf moved; the state is checkpointed after
    step 2 and restored, every leaf bit-equal, and step 3 runs from the
    restored state. Returns its record and its launch counts (zeroed just
    before the first step, read after the last)."""
    import shutil
    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data import synthetic
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.optim.adamw import OptimConfig
    from repro_torch.models.common import count_params
    from repro_torch.train import steps
    from repro_torch.tree import tree_leaves
    cfg = configs.get_config(arch)
    ocfg = OptimConfig(lr=3e-4, warmup_steps=max(TRAIN_STEPS // 20, 1),
                       total_steps=TRAIN_STEPS)
    t0 = time.perf_counter()
    state = steps.init_train_state(cfg, ocfg, seed, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = count_params(state.params)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves((state.params, state.opt.mu,
                                            state.opt.nu)))
    dcfg = synthetic.for_model(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=seed)
    batches = [synthetic.batch_at(dcfg, i, device="cuda")
               for i in range(TRAIN_STEPS)]
    step_fn = steps.make_train_step(cfg, ocfg)
    sums0 = _tree_sums(torch, state.params)
    ck = root / f"train_{arch}"
    shutil.rmtree(ck, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in counters.values():
        mod.launches = 0
    fk.backward_calls = 0
    step_ms, losses, norms, ckpt = [], [], [], {}
    for i, b in enumerate(batches):
        if i == 2:                      # checkpoint after step 2, restore
            mgr = CheckpointManager(str(ck), keep_last=1)
            t0 = time.perf_counter()
            mgr.save(2, state, extra={"data_step": 2})
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            got_step, restored, _ = mgr.restore_latest(state)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            equal = got_step == 2 and all(
                torch.equal(a, b_) if isinstance(a, torch.Tensor)
                else a == b_ for a, b_ in zip(tree_leaves(restored),
                                              tree_leaves(state)))
            if not equal:
                raise AssertionError(f"train {arch}: the restored state is "
                                     "not bit-equal to the saved one")
            ckpt = dict(step=2, leaves=len(tree_leaves(state)),
                        bytes=state_bytes, save_s=save_s, restore_s=load_s,
                        bit_equal=equal)
            state = restored
            shutil.rmtree(ck, ignore_errors=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    launches = {k: mod.launches for k, mod in counters.items()}
    bwd = fk.backward_calls
    peak = torch.cuda.max_memory_allocated()
    want = TRAIN_STEPS * attention_layers(cfg)
    sums1 = _tree_sums(torch, state.params)
    unmoved = sum(a == b_ for a, b_ in zip(sums0, sums1))
    if not (launches["flash_attention"] == bwd == want
            and all(math.isfinite(x) for x in losses + norms)
            and unmoved == 0 and sum(launches.values()) == want):
        raise AssertionError(f"train {arch} full width: launches "
                             f"{launches}, backward calls {bwd} (want "
                             f"{want}), losses {losses}, {unmoved} leaves "
                             "unmoved")
    rec = dict(arch=arch, params=n_params, state_bytes=state_bytes,
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
               init_s=init_s, step_ms=step_ms, loss=losses,
               grad_norm=norms, peak_mem_bytes=peak, checkpoint=ckpt,
               attention_launches=launches["flash_attention"],
               backward_calls=bwd, leaves_moved=len(sums1))
    return rec, launches, bwd, state


def _whisper_serve(torch, state, seed: int, counters):
    """Full-width whisper-base after training: ``make_prefill_step`` on
    WHISPER_PROMPT-token prompts over 1500 frames, then a decode cache from
    ``encode`` and the prompt fed through ``make_decode_step`` one token at
    a time (its last logits against the prefill's, bf16: within 5% of
    their largest magnitude), then
    WHISPER_DECODE greedy steps. Launches: 12 for the prefill (6 at
    S = 1500), 6 for the cache's ``encode``, none in decode."""
    from repro_torch import configs
    from repro_torch.data import synthetic
    from repro_torch.models import encdec
    from repro_torch.train import steps
    cfg = configs.get_config("whisper-base")
    params = state.params
    dcfg = synthetic.for_model(cfg, TRAIN_BATCH, WHISPER_PROMPT,
                               seed=seed + 1)
    b = synthetic.batch_at(dcfg, 0, device="cuda")
    prompt = b["tokens"][:, :WHISPER_PROMPT]
    for mod in counters.values():
        mod.launches = 0
    t0 = time.perf_counter()
    logits = steps.make_prefill_step(cfg, WHISPER_PROMPT)(
        params, {"frames": b["frames"], "tokens": prompt})
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    n_prefill = counters["flash_attention"].launches
    with torch.no_grad():
        memory = encdec.encode(cfg, params, b["frames"])
        cache = encdec.init_decode_cache(cfg, params, memory,
                                         WHISPER_PROMPT + WHISPER_DECODE)
    n_encode = counters["flash_attention"].launches - n_prefill
    decode = steps.make_decode_step(cfg)
    for i in range(WHISPER_PROMPT):
        step_logits, cache = decode(params, cache, prompt[:, i:i + 1])
    gap = float((step_logits[:, 0] - logits[:, -1]).abs().max())
    scale = float(logits[:, -1].abs().max())
    tok = step_logits[:, -1].argmax(-1, keepdim=True)
    out, finite = [], bool(torch.isfinite(step_logits).all())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(WHISPER_DECODE):
        step_logits, cache = decode(params, cache, tok)
        finite = finite and bool(torch.isfinite(step_logits).all())
        tok = step_logits[:, -1].argmax(-1, keepdim=True)
        out.append(tok)
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0) / WHISPER_DECODE
    launches = {k: mod.launches for k, mod in counters.items()}
    want = 2 * cfg.n_encoder_layers + cfg.n_layers
    if not (finite and bool(torch.isfinite(logits).all())
            and gap <= 0.05 * scale
            and n_prefill == cfg.n_encoder_layers + cfg.n_layers
            and n_encode == cfg.n_encoder_layers
            and launches["flash_attention"] == want
            and sum(launches.values()) == want):
        raise AssertionError(f"whisper-base serve steps: finite {finite}, "
                             f"prefill/decode gap {gap}, launches "
                             f"{launches} ({n_prefill} in the prefill)")
    return dict(prompt=WHISPER_PROMPT, frames=cfg.encoder_seq,
                decode_steps=WHISPER_DECODE, prefill_ms=prefill_ms,
                decode_step_ms=decode_ms, prefill_launches=n_prefill,
                encode_launches=n_encode, decode_launches=0,
                prefill_vs_decode_max_abs_gap=gap, logits_max_abs=scale,
                tokens=torch.cat(out, dim=1)[0].tolist()), launches


def phase_train(torch, smi):
    """The training path: SMOKE card against CPU for one arch per family
    (``_train_smoke``), then full-width olmo-1b and whisper-base
    (``_train_full``), whisper-base's prefill and decode after
    (``_whisper_serve``)."""
    counters = _counters()
    root = ROOT / "build"
    smoke = []
    for i, arch in enumerate(TRAIN_SMOKE_ARCHS):
        smoke.append(_train_smoke(torch, arch, 30 + i))
    full, total, bwd_total, serve = [], {}, 0, None
    for i, arch in enumerate(TRAIN_FULL_ARCHS):
        gc.collect()
        torch.cuda.empty_cache()
        rec, launches, bwd, state = _train_full(torch, arch, 40 + i, root,
                                                counters)
        _add_launches(total, launches)
        bwd_total += bwd
        if arch == "whisper-base":
            serve, launches = _whisper_serve(torch, state, 40 + i, counters)
            _add_launches(total, launches)
            rec["serve"] = serve
        full.append(rec)
        del state
    emit({"phase": "train", "part": "smoke", "card": smi, "archs": smoke})
    return dict(card=smi, full=full, launches=total,
                backward_calls=bwd_total, energy=[],
                note="step_ms: host wall per AdamW step ended by a "
                     "synchronize (the first one includes warm-up); "
                     "state_bytes: params and both moments, f32")


# ------------------------------------------- training across ranks (slice 14)
# full-width olmo-1b cut 16 -> TS_LAYERS layers (0.24 B params), which
# keeps the whole script inside its time limit with the MoE part
TS_ARCH, TS_LAYERS, TS_SEED, TS_WORLD = "olmo-1b", 2, 60, 2
# the (2, 1) mesh's gradient (a half batch per rank, summed and halved)
# against the one-process twin's at the same params, bf16 activations:
# each leaf within TS_GRAD_RTOL of its largest magnitude plus 1e-4 of the
# largest anywhere, the loss within TS_LOSS_RTOL relative. The gradient of
# rank 0's half batch alone (rank 1's dropped from the reduction) must
# fail that limit. Measured on the H100 with olmo-1b's 16 layers: worst
# 0.41 and 0.49 of the limit at steps 1 and 2, the half batch alone ~100x
# it; deepseek-moe-16b's 2 layers: 0.49 and 0.38, the half ~100x.
TS_GRAD_RTOL, TS_LOSS_RTOL = 1e-2, 1e-3
TS_JOIN_S = 900
TS_CLI_MESH = "[train] olmo-1b-smoke on mesh {'data': 1, 'model': 2}"
# the MoE part: full-width deepseek-moe-16b cut 28 -> TS_MOE_LAYERS layers
# (1.01 B params; every layer is an MoE layer), the same batches and
# limits, on (data 2, model 1); one step, for the whole script's time
# limit
TS_MOE_ARCH, TS_MOE_LAYERS, TS_MOE_STEPS = "deepseek-moe-16b", 1, 1
TS_MOE_CLI_MESH = ("[train] deepseek-moe-smoke on mesh {'data': 2, "
                   "'model': 1}")


def _coords_view(mesh, rank: int):
    """``mesh`` as rank ``rank`` sees it, for its block slices (no
    collective is made through it)."""
    import types
    from repro_torch.launch.mesh import _unravel
    shape = tuple(mesh.shape[a] for a in mesh.axis_names)
    return types.SimpleNamespace(
        axis_names=mesh.axis_names, shape=mesh.shape,
        coords=dict(zip(mesh.axis_names, _unravel(rank, shape))))


def _ts_twin(torch, cfg, ocfg, batches, mesh):
    """The one-process twin's steps 1 and 2 on this rank alone (the other
    waits): ``value_and_grad`` and AdamW as ``make_train_step`` runs them.
    At each step, for every rank of ``mesh``, ``sharded_update`` of the
    twin's gradient on that rank's blocks of the twin's state must be
    bit-equal to those blocks of the twin's next state. Returns the
    twin's losses and gradient norms."""
    from repro_torch.data import synthetic
    from repro_torch.distributed import sharding
    from repro_torch.optim import adamw as optim
    from repro_torch.train import steps
    from repro_torch.tree import tree_leaves
    state = steps.init_train_state(cfg, ocfg, TS_SEED, "cuda")
    out = dict(loss=[], grad_norm=[], update_blocks_checked=0)
    for s, b in enumerate(batches[:2]):
        loss, _, grads = steps.value_and_grad(
            cfg, state.params, b, synthetic.generator(state.seed, state.step))
        norm = optim.global_norm(grads)
        p, opt, _ = optim.apply(ocfg, state.opt, state.params, grads)
        new = steps.TrainState(p, opt, state.step + 1, state.seed)
        for r in range(mesh.size):
            view = _coords_view(mesh, r)
            blocks = sharding.shard_state(state, view)
            got_p, got_opt, _ = steps.sharded_update(ocfg, blocks, grads,
                                                     norm, view)
            got = tree_leaves((got_p, got_opt.mu, got_opt.nu))
            want = tree_leaves(sharding.block_of(
                (p, opt.mu, opt.nu), (blocks.params, blocks.opt.mu,
                                      blocks.opt.nu), view))
            for a, w in zip(got, want):
                a = a.local if isinstance(a, sharding.Shard) else a
                if not torch.equal(a, w):
                    raise AssertionError(
                        f"train_sharded: the mesh's AdamW update of the "
                        f"twin's step-{s + 1} gradient differs on rank "
                        f"{r}'s block of a leaf {tuple(w.shape)}")
            out["update_blocks_checked"] += len(got)
            del blocks, got_p, got_opt, got, want
        out["loss"].append(float(loss))
        out["grad_norm"].append(float(norm))
        state = new
        del grads, p, opt, new
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _ts_grad_ratio(got, want) -> tuple:
    """(worst error over its limit, that leaf's shape): gradient leaves
    ``got`` against ``want`` (TS_GRAD_RTOL of each leaf's largest
    magnitude plus 1e-4 of the largest anywhere); above 1 fails."""
    top = max(float(w.abs().max()) for w in want)
    worst, where = 0.0, ()
    for a, w in zip(got, want):
        w = w.to(a.device)
        lim = TS_GRAD_RTOL * float(w.abs().max()) + 1e-4 * top
        ratio = float((a - w).abs().max()) / lim
        if not ratio <= worst:
            worst, where = ratio, tuple(w.shape)
    return worst, where


def _ts_twin_at(torch, cfg, state, mesh, batch, step: int):
    """The twin's gradient at the mesh's params: ``state``'s params
    gathered whole (every rank takes part), then, on rank 0 alone,
    ``value_and_grad`` of the whole batch and of rank 0's rows alone (the
    gradient with rank 1's half dropped from the reduction); the other
    rank waits. Returns (loss, host gradient leaves, the dropped half's
    worst ratio to the limit) on rank 0, None elsewhere."""
    from repro_torch.data import synthetic
    from repro_torch.distributed import constraints, sharding
    from repro_torch.train import steps
    from repro_torch.tree import tree_leaves
    params = constraints.gather(state.params, mesh)
    out = None
    if mesh.rank == 0:
        gen = lambda: synthetic.generator(state.seed, state.step)  # noqa
        loss, _, grads = steps.value_and_grad(cfg, params, batch, gen())
        want = [g.cpu() for g in tree_leaves(grads)]
        del grads
        rows = sharding.batch_rows(next(iter(batch.values())).shape[0], mesh)
        _, _, half = steps.value_and_grad(
            cfg, params, {k: v[rows] for k, v in batch.items()}, gen())
        dropped, _ = _ts_grad_ratio(tree_leaves(half), want)
        if not dropped > 1:
            raise AssertionError(f"train_sharded step {step}: the limit "
                                 f"passes rank 0's half batch alone "
                                 f"(ratio {dropped})")
        out = (float(loss), want, dropped)
        del half
    del params
    gc.collect()
    torch.cuda.empty_cache()
    mesh.barrier()
    return out


def _saved_leaves(torch, path: Path):
    """The leaves of a checkpoint directory as written (no hash check):
    host tensors and ints."""
    import numpy as np
    meta = json.loads((path / "MANIFEST.json").read_text())["leaves"]
    out = []
    for i, m in enumerate(meta):
        a = np.load(path / f"leaf_{i:05d}.npy")
        if m["dtype"] == "int":
            out.append(int(a))
            continue
        t = torch.from_numpy(a)
        out.append(t.view(torch.bfloat16) if m["dtype"] == "bfloat16" else t)
    return out


def _ts_moe(torch, mesh, run_step):
    """The MoE part of a train_sharded rank: TS_MOE_ARCH at full width cut
    to TS_MOE_LAYERS layers, TS_MOE_STEPS AdamW steps on ``mesh`` (data 2,
    model 1), each MoE layer routing the global batch (``moe.moe_layer``).
    Before
    each step rank 0 takes the twin's gradient at the mesh's params
    (``_ts_twin_at``: the whole batch, then rank 0's half alone, which
    must fail the limit); the reduced gradient must pass it. In each step
    every MoE layer's gather and routing are tapped: the gathered tokens
    the same bits on every rank, this rank's rows its own input, the
    routing ``torch.equal`` to ``moe.route`` of the gathered tokens; the
    assignments of this rank's rows that a per-rank route drops and the
    global route keeps are counted, and on rank 0 where the twin's MoE
    inputs and routing differ from the mesh's. Returns the record."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.data import synthetic
    from repro_torch.distributed import constraints, sharding
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.models import moe
    from repro_torch.optim.adamw import OptimConfig
    from repro_torch.train import steps
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(configs.get_config(TS_MOE_ARCH),
                              n_layers=TS_MOE_LAYERS)
    ocfg = OptimConfig(lr=3e-4, warmup_steps=max(TRAIN_STEPS // 20, 1),
                       total_steps=TRAIN_STEPS)
    dcfg = synthetic.for_model(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=TS_SEED)
    batches = [synthetic.batch_at(dcfg, i, device="cuda")
               for i in range(TS_MOE_STEPS)]
    t0 = t = time.perf_counter()
    state = sharding.shard_state(
        steps.init_train_state(cfg, ocfg, TS_SEED, "cuda"), mesh)
    torch.cuda.synchronize()
    rec = dict(arch=cfg.name, layers=cfg.n_layers,
               n_params=sum(math.prod(x.shape) for x in tree_leaves(
                   state.params) if isinstance(x, sharding.Shard)),
               init_s=time.perf_counter() - t, steps=[], layers_checked=[])
    step_fn = steps.make_train_step(cfg, ocfg, mesh=mesh)
    route, gather, update = (moe.route, constraints.gather_rows_grad,
                             steps.sharded_update)
    tap = dict(routes=[], gathers=[], grads=None)

    def tap_route(cfg_, router, x):
        r = route(cfg_, router, x)
        # kept detached, the router copied: a tensor of the graph, or a
        # view of the gathered params, would keep all of them alive
        tap["routes"].append((router.detach().clone(), x.detach(),
                              moe.Routing(*(v.detach() if isinstance(
                                  v, torch.Tensor) else v for v in r))))
        return r

    def tap_gather(x, mesh_):
        full = gather(x, mesh_)
        tap["gathers"].append(x.detach())
        return full

    def tap_update(ocfg_, state_, grads, gnorm, mesh_, params=None):
        tap["grads"] = grads
        return update(ocfg_, state_, grads, gnorm, mesh_, params)

    counters = _counters()
    i_blk, _ = constraints.data_block(mesh)
    k = cfg.top_k
    t_global = batches[0]["tokens"][:, :-1].numel()    # the MoE's T
    fields = ("flat_e", "rank", "keep", "slot")
    for i in range(TS_MOE_STEPS):
        # the twin's launches compare, and count on no path; its routes
        # of the whole batch are kept (the half batch's are not)
        held = counters["flash_attention"].launches, fk.backward_calls
        moe.route = tap_route
        try:
            ref = _ts_twin_at(torch, cfg, state, mesh, batches[i], i + 1)
        finally:
            moe.route = route
        counters["flash_attention"].launches, fk.backward_calls = held
        twin = [(x, r) for _, x, r in tap["routes"]
                if x.shape[0] == t_global]
        tap["routes"].clear()
        moe.route, constraints.gather_rows_grad = tap_route, tap_gather
        steps.sharded_update = tap_update
        try:
            state, m = run_step(mesh, step_fn, state, batches[i], i,
                                cfg.n_layers, rec["steps"])
        finally:
            moe.route, constraints.gather_rows_grad = route, gather
            steps.sharded_update = update
        if not len(tap["routes"]) == len(tap["gathers"]) == cfg.n_layers:
            raise AssertionError(f"train_sharded {cfg.name} step {i + 1}: "
                                 f"{len(tap['routes'])} routes, "
                                 f"{len(tap['gathers'])} gathers")
        layers = []
        for j, ((router, xg, r), x) in enumerate(zip(tap["routes"],
                                                     tap["gathers"])):
            rows = slice(i_blk * x.shape[0], (i_blk + 1) * x.shape[0])
            words = xg.reshape(-1).view(torch.int32)
            hi, lo = words.clone(), words.clone()
            mesh.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.data_group)
            mesh.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.data_group)
            again = route(cfg, router, xg)
            local = route(cfg, router, xg[rows])
            out = dict(
                layer=j, tokens=xg.shape[0], capacity=r.capacity,
                local_capacity=local.capacity,
                same_on_every_rank=bool(torch.equal(hi, words)
                                        and torch.equal(lo, words)),
                own_rows_equal=bool(torch.equal(xg[rows], x)),
                routing_equal=bool(again.capacity == r.capacity and all(
                    torch.equal(getattr(again, f), getattr(r, f))
                    for f in fields)),
                dropped_global=int((~r.keep).sum()),
                per_rank_drops_kept_globally=int(
                    (r.keep[rows.start * k:rows.stop * k]
                     & ~local.keep).sum()))
            if twin:
                tx, tr = twin[j]
                out.update(twin_input_equal=bool(torch.equal(tx, xg)),
                           twin_expert_diff=int(
                               (tr.flat_e != r.flat_e).sum()),
                           twin_keep_diff=int((tr.keep != r.keep).sum()))
            if not (out["same_on_every_rank"] and out["own_rows_equal"]
                    and out["routing_equal"]):
                raise AssertionError(f"train_sharded {cfg.name} step "
                                     f"{i + 1}: {out}")
            layers.append(out)
        rec["layers_checked"].append(layers)
        if ref is not None:
            loss, want, drop = ref
            ratio, shape = _ts_grad_ratio(tree_leaves(tap["grads"]), want)
            rec.setdefault("twin", []).append(dict(
                step=i + 1, loss=loss, mesh_loss=float(m["loss"]),
                worst_grad_err_over_limit=ratio, worst_grad_leaf=list(shape),
                dropped_half_over_limit=drop))
            if not ratio <= 1:
                raise AssertionError(f"train_sharded {cfg.name} step "
                                     f"{i + 1}: a reduced gradient leaf "
                                     f"{shape} is {ratio} of its limit off "
                                     f"the twin's")
            if not abs(float(m["loss"]) - loss) <= TS_LOSS_RTOL * abs(loss):
                raise AssertionError(f"train_sharded {cfg.name} step "
                                     f"{i + 1}: loss {float(m['loss'])}, "
                                     f"twin {loss}")
            del want
        tap.update(routes=[], gathers=[], grads=None)
        del ref, twin
    del state, step_fn, batches
    gc.collect()
    torch.cuda.empty_cache()
    mesh.barrier()
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def _ts_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of the train_sharded phase (a spawned process; ranks share
    cuda:0 over gloo). Saves its record to ``tmp``; every check raises."""
    import dataclasses
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data import synthetic
    from repro_torch.distributed import sharding
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim.adamw import OptimConfig
    from repro_torch.train import steps
    from repro_torch.tree import tree_leaves, tree_unflatten

    torch.cuda.set_device(0)
    m21 = mesh_lib.make_mesh(
        (2, 1), ("data", "model"), device="cuda",
        init_method=f"file://{tmp}/rdzv", rank=rank, world_size=world,
        timeout_s=TS_JOIN_S)
    m12 = mesh_lib.make_mesh((1, 2), ("data", "model"), device="cuda")
    cfg = dataclasses.replace(configs.get_config(TS_ARCH), n_layers=TS_LAYERS)
    ocfg = OptimConfig(lr=3e-4, warmup_steps=max(TRAIN_STEPS // 20, 1),
                       total_steps=TRAIN_STEPS)
    dcfg = synthetic.for_model(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=TS_SEED)
    batches = [synthetic.batch_at(dcfg, i, device="cuda")
               for i in range(TRAIN_STEPS)]
    rec = dict(rank=rank, backend=m21.backend, steps=[])
    t0 = time.perf_counter()
    twin = _ts_twin(torch, cfg, ocfg, batches, m21) if rank == 0 else None
    m21.barrier()
    rec["twin_s"] = time.perf_counter() - t0

    # the gradient each step reduces, seen where the update takes it
    seen = {}
    update = steps.sharded_update

    def tap(ocfg_, state_, grads, gnorm, mesh_, params=None):
        seen["grads"] = grads
        return update(ocfg_, state_, grads, gnorm, mesh_, params)
    steps.sharded_update = tap

    counters = _counters()
    for mod in counters.values():
        mod.launches = 0
    fk.backward_calls = 0

    def run_step(mesh, step_fn, state, batch, i, layers, into):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        n0, b0, c0 = (counters["flash_attention"].launches,
                      fk.backward_calls, mesh.collectives)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        out = dict(step=i + 1, mesh=dict(mesh.shape),
                   ms=1e3 * (time.perf_counter() - t),
                   loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   collectives=mesh.collectives - c0,
                   attention_launches=(counters["flash_attention"].launches
                                       - n0),
                   backward_calls=fk.backward_calls - b0,
                   peak_mem_bytes=torch.cuda.max_memory_allocated())
        if not out["attention_launches"] == out["backward_calls"] == layers:
            raise AssertionError(f"train_sharded step {i + 1} on rank "
                                 f"{rank}: {out}")
        into.append(out)
        return state, m

    # (data 2, model 1): steps 1 and 2, each reduced gradient held on rank
    # 0 to the twin's gradient at the mesh's params, taken before the step
    state = sharding.shard_state(
        steps.init_train_state(cfg, ocfg, TS_SEED, "cuda"), m21)
    step21 = steps.make_train_step(cfg, ocfg, mesh=m21)
    worst, where, dropped, ref_loss = [], [], [], []
    for i in range(2):
        # the twin's launches compare, and count on no path
        held = counters["flash_attention"].launches, fk.backward_calls
        ref = _ts_twin_at(torch, cfg, state, m21, batches[i], i + 1)
        counters["flash_attention"].launches, fk.backward_calls = held
        state, m = run_step(m21, step21, state, batches[i], i, cfg.n_layers,
                            rec["steps"])
        if ref is not None:
            loss, want, drop = ref
            ratio, shape = _ts_grad_ratio(tree_leaves(seen["grads"]), want)
            if not ratio <= 1:
                raise AssertionError(f"train_sharded step {i + 1}: a "
                                     f"reduced gradient leaf {shape} is "
                                     f"{ratio} of its limit off the twin's")
            if not abs(float(m["loss"]) - loss) <= TS_LOSS_RTOL * abs(loss):
                raise AssertionError(f"train_sharded step {i + 1}: loss "
                                     f"{float(m['loss'])}, twin {loss}")
            worst.append(ratio)
            where.append(list(shape))
            dropped.append(drop)
            ref_loss.append(loss)
        seen.clear()
    if twin is not None:
        rec["twin"] = dict(loss=twin["loss"], grad_norm=twin["grad_norm"],
                           update_blocks_checked=twin[
                               "update_blocks_checked"],
                           loss_at_mesh_params=ref_loss,
                           worst_grad_err_over_limit=worst,
                           worst_grad_leaf=where,
                           dropped_half_over_limit=dropped)
        del twin

    # save from (2, 1), restore onto (1, 2)
    ck = Path(tmp) / "ck"
    mgr = CheckpointManager(str(ck), keep_last=1)
    c0 = m21.collectives
    t = time.perf_counter()
    mgr.save(2, state, extra={"data_step": 2}, mesh=m21)
    rec["save_s"] = time.perf_counter() - t
    rec["save_collectives"] = m21.collectives - c0
    t = time.perf_counter()
    got, restored, _ = mgr.restore_resharded(state, m12)
    torch.cuda.synchronize()
    rec["restore_s"] = time.perf_counter() - t
    del state
    saved = _saved_leaves(torch, ck / "step_00000002")
    for a, w in zip(tree_leaves(restored), saved):
        if isinstance(a, sharding.Shard):
            w = w[sharding.block_slices(m12, w.shape, a.spec)]
            ok = torch.equal(a.local.cpu(), w)
        else:
            ok = a == w if not isinstance(a, torch.Tensor) \
                else torch.equal(a.cpu(), w)
        if not (got == 2 and ok):
            raise AssertionError(f"train_sharded: rank {rank}'s restored "
                                 "block differs from the saved state")
    rec["restored_bit_equal"] = True
    if rank != 0:
        del saved

    # (data 1, model 2): step 3 from the restored state
    state3, m3 = run_step(m12, steps.make_train_step(cfg, ocfg, mesh=m12),
                          restored, batches[2], 2, cfg.n_layers, rec["steps"])
    steps.sharded_update = update
    seen.clear()
    rec["launches"] = {k: mod.launches for k, mod in counters.items()}
    rec["backward_calls"] = fk.backward_calls
    del restored
    gc.collect()
    torch.cuda.empty_cache()
    m12.barrier()

    # the twin's step 3 from the restored state, on rank 0; each rank's
    # block of it (rank 1's sent through an exact integer sum) torch.equal
    # to the mesh's
    full = None
    if rank == 0:
        start = tree_unflatten(state3, [
            x.to("cuda") if isinstance(x, torch.Tensor) else x
            for x in saved])
        del saved
        full, tm3 = steps.make_train_step(cfg, ocfg)(start, batches[2])
        del start
        if (float(tm3["loss"]), float(tm3["grad_norm"])) != \
                (float(m3["loss"]), float(m3["grad_norm"])):
            raise AssertionError(f"train_sharded step 3: loss, grad norm "
                                 f"{float(m3['loss'])}, "
                                 f"{float(m3['grad_norm'])}; twin "
                                 f"{float(tm3['loss'])}, "
                                 f"{float(tm3['grad_norm'])}")
        full = tree_leaves(full)
    peers = [_coords_view(m12, r) for r in range(m12.size)]
    for i, a in enumerate(tree_leaves(state3)):
        if not isinstance(a, sharding.Shard):
            if full is not None and not (
                    a == full[i] if not isinstance(a, torch.Tensor)
                    else torch.equal(a, full[i])):
                raise AssertionError("train_sharded step 3: a replicated "
                                     "leaf differs from the twin's")
            continue
        for r in range(1, m12.size):
            sl = sharding.block_slices(peers[r], a.shape, a.spec)
            buf = torch.zeros(tuple(s.stop - s.start for s in sl),
                              dtype=a.local.dtype, device="cuda")
            if full is not None:
                buf.copy_(full[i][sl])
            m12.sum_bytes(buf)
            if rank == r and not torch.equal(buf, a.local):
                raise AssertionError(f"train_sharded step 3: rank {r}'s "
                                     "block differs from the twin's")
        if full is not None and not torch.equal(
                a.local, full[i][sharding.block_slices(m12, a.shape,
                                                       a.spec)]):
            raise AssertionError("train_sharded step 3: rank 0's block "
                                 "differs from the twin's")
    rec["step3_bit_equal"] = True
    del state3, full, batches
    gc.collect()
    torch.cuda.empty_cache()

    # full-width deepseek-moe-16b, cut in depth, on (data 2, model 1)
    for mod in counters.values():
        mod.launches = 0
    fk.backward_calls = 0
    rec["moe"] = _ts_moe(torch, m21, run_step)
    _add_launches(rec["launches"], {k: mod.launches
                                    for k, mod in counters.items()})
    rec["backward_calls"] += fk.backward_calls
    rec["collectives"] = m21.collectives + m12.collectives
    torch.save(rec, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


def phase_train_sharded(torch, smi):
    """Training across ranks (``train.steps.make_sharded_train_step``,
    ``checkpoint.manager`` from a mesh, ``restore_resharded``):
    full-width olmo-1b cut to TS_LAYERS layers at global batch TRAIN_BATCH
    and sequence TRAIN_SEQ from the port's init, on 2 spawned ranks
    sharing cuda:0 over gloo.
    Rank 0 first runs a one-process twin's steps 1 and 2 alone (the
    mesh's AdamW update of its gradient bit-equal on every rank's block);
    then 2 steps on (data 2, model 1), each reduced gradient within
    TS_GRAD_RTOL of the twin's gradient at the mesh's params before the
    step (gathered whole), a limit that the gradient of rank 0's half
    batch alone must fail; a save from that mesh; a restore onto
    (data 1, model 2), every rank's blocks bit-equal to the saved state as
    written; step 3 there, every block `torch.equal` to the twin's step 3
    from the restored state. Every step launches TS_LAYERS attentions and
    backward calls on every rank, counted from the first mesh step to the
    last. Then, in the same ranks, the MoE part (``_ts_moe``), counted
    from its first step to its last. Beside the ranks, started with them,
    the SMOKE CLI, ``--model-parallel 2`` and ``--arch deepseek-moe-16b``
    on (2, 1), each under ``python -m torch.distributed.run`` (2 ranks,
    cuda:0), must exit 0 and print its mesh line once."""
    import shutil
    import torch.multiprocessing as mp
    gc.collect()
    torch.cuda.empty_cache()
    tmp = ROOT / "build" / "train_sharded"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    # the SMOKE launcher, olmo-1b on (1, 2) and deepseek-moe-16b on
    # (2, 1), both started with the ranks
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    clis = [(line, subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(TS_WORLD), "-m", "repro_torch.launch.train",
         *args, "--global-batch", "2", "--seq", "16", "--device", "cuda"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)) for line, args in (
            (TS_CLI_MESH, ["--model-parallel", "2", "--steps", "3"]),
            (TS_MOE_CLI_MESH, ["--arch", TS_MOE_ARCH, "--steps", "2"]))]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_ts_rank, args=(r, TS_WORLD, str(tmp)))
             for r in range(TS_WORLD)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(TS_JOIN_S)
        command_s = time.perf_counter() - t0
        outs = [(line, p.communicate(timeout=TS_JOIN_S), p.returncode)
                for line, p in clis]
        cli_s = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        for _, p in clis:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.exitcode for p in procs]
    if codes != [0] * TS_WORLD:
        raise AssertionError(f"train_sharded ranks exited {codes}")
    for line, (out, err), code in outs:
        if code != 0 or out.count(line) != 1 or \
                out.count("[train] done") != 1:
            raise AssertionError(f"train_sharded CLI exited {code}:\n"
                                 f"{out[-2000:]}\n{err[-2000:]}")
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(TS_WORLD)]
    shutil.rmtree(tmp, ignore_errors=True)
    launches, bwd = {}, 0
    for rec in ranks:
        if not (rec["restored_bit_equal"] and rec["step3_bit_equal"]):
            raise AssertionError(f"train_sharded rank {rec['rank']}: {rec}")
        _add_launches(launches, rec.pop("launches"))
        bwd += rec.pop("backward_calls")
    moe_ranks = [rec.pop("moe") for rec in ranks]
    return dict(arch=TS_ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                world=TS_WORLD, card=smi, command_s=command_s, ranks=ranks,
                moe=dict(arch=TS_MOE_ARCH, layers=TS_MOE_LAYERS,
                         batch=TRAIN_BATCH, seq=TRAIN_SEQ, ranks=moe_ranks),
                launches=launches, backward_calls=bwd,
                cli=dict(wall_s=cli_s,
                         mesh_lines=[TS_CLI_MESH, TS_MOE_CLI_MESH],
                         note="started with the ranks; wall_s to the "
                              "later of their ends and the ranks'"),
                energy=[],
                note="ms: host wall of one train step ended by a "
                     "synchronize (the first includes warm-up); "
                     "peak_mem_bytes: max_memory_allocated over that step "
                     "in the rank's process; collectives: the rank's "
                     "calls that step; twin_s: rank 0's one-process twin "
                     "and its update checks (rank 1 waits); the SMOKE CLI "
                     "ran beside the ranks' start")


# ----------------------------------------------- decode paths (slice 13)
def _recording_contexts(transformer):
    """Patch ``transformer.ExecContext`` with a subclass that keeps every
    context a ``DriftDecode`` step builds; returns (list, restore)."""
    ctxs = []
    base = transformer.ExecContext

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            ctxs.append(self)
    transformer.ExecContext = Recording

    def restore():
        transformer.ExecContext = base
    return ctxs, restore


def _ctx_counts(ctxs, tile_bytes: int = 32 * 32 * 4):
    """(detected rows, corrected elements, flagged tiles) summed over the
    contexts: a drift GEMM's DRAM cost is one repacked tile a flag."""
    det = sum(int(c.stats["detected_row_errors"]) for c in ctxs)
    corr = sum(int(c.stats["corrected_elems"]) for c in ctxs)
    tiles = sum(int(round(float(c.stats["extra_dram_bytes"]) / tile_bytes))
                for c in ctxs)
    return det, corr, tiles


def _drift_decode(torch, eng, arch, cfg):
    """``DriftDecode`` on the engine's full-width weights: 2 prompts of 8
    tokens, then AR_STEPS protected decode steps at the undervolt BER
    table (steps below ``nominal_steps`` and layer 0 at BER 0), refresh
    interval AR_WINDOW, greedy tokens. Every protected projection runs
    through ``drift_gemm_fused`` at M = 2 inside one 32-row tile: exactly
    7 x 16 launches a step for olmo-1b, and no ``abft_matmul`` or
    ``rollback_correct`` (the ``kernels`` phase holds the fused kernel
    bit-equal at these shapes).
    Counters zeroed just before the prefill and read after the last
    step; ms per step (synchronized)."""
    from repro_torch.core import dvfs, fault
    from repro_torch.core.exec_ctx import DriftSystemConfig
    from repro_torch.core.rollback import RollbackConfig
    from repro_torch.models import transformer
    from repro_torch.serving import ar

    (_, weights), = eng.servable_for(arch)._weights.values()
    counters = _counters()
    tokens = ar.prompt_tokens(cfg, [0, 1], eng.device)
    table = dvfs.fine_grained_schedule(
        AR_STEPS, dvfs.UNDERVOLT, nominal_steps=eng.nominal_steps).ber_table
    dcfg = DriftSystemConfig(mode="drift",
                             rollback=RollbackConfig(interval=AR_WINDOW))
    src = fault.PhiloxFlipSource(7, 0, eng.device)
    store = transformer.drift_store_spec(cfg, BUCKET, eng.device)
    ctxs, restore = _recording_contexts(transformer)
    for mod in counters.values():
        mod.launches = 0
    try:
        logits, cache = transformer.prefill(cfg, weights, tokens,
                                            tokens.shape[1] + AR_STEPS)
        tok = logits[:, -1:].argmax(-1)
        prefill_launches = {k: m.launches for k, m in counters.items()}
        per_step, times, counts = [], [], []
        for step in range(AR_STEPS):
            before = {k: m.launches for k, m in counters.items()}
            ctxs.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache, store = transformer.decode_step(
                cfg, weights, cache, tok, transformer.DriftDecode(
                    dcfg, src, table[step], store, step))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            per_step.append({k: m.launches - before[k]
                             for k, m in counters.items()})
            counts.append(_ctx_counts(ctxs))
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{arch} DriftDecode step {step}: "
                                     "non-finite logits")
            tok = logits[:, -1:].argmax(-1)
    finally:
        restore()
    launches = {k: m.launches for k, m in counters.items()}
    gemms = cfg.n_layers * {"moe": 4, "ssm": 0}.get(cfg.family, 7)
    want_step = {"abft_matmul": 0, "rollback_correct": 0,
                 "drift_gemm_fused": gemms, "flash_attention": 0,
                 "fault_inject": 0, "stat_abft_matmul": 0}
    if any(s != want_step for s in per_step) or prefill_launches != {
            "abft_matmul": 0, "rollback_correct": 0, "drift_gemm_fused": 0,
            "flash_attention": cfg.n_layers, "fault_inject": 0,
            "stat_abft_matmul": 0}:
        raise AssertionError(f"{arch} DriftDecode launches: prefill "
                             f"{prefill_launches}, steps {per_step}")
    shapes = {k: tuple(v.shape) for k, v in store.items()}
    if (len(store) != 7 or any(s[:2] != (cfg.n_layers, BUCKET)
                               for s in shapes.values())
            or not all(bool(torch.isfinite(v).all())
                       for v in store.values())):
        raise AssertionError(f"{arch} DriftDecode store {shapes}")
    if not sum(c[1] for c in counts) > 0:
        raise AssertionError(f"{arch} DriftDecode corrected nothing at "
                             "undervolt")
    steady = times[eng.nominal_steps:]
    return dict(steps=AR_STEPS, window=AR_WINDOW, bucket=BUCKET,
                prompt=int(tokens.shape[1]), launches_per_step=want_step,
                store_shapes=shapes, step_ms=times,
                step_ms_mean_faulted=sum(steady) / len(steady),
                detected_corrected_tiles=counts,
                note="step_ms: host wall per DriftDecode step ended by a "
                     "synchronize; faulted: steps >= nominal_steps"), \
        launches


def _mixed_decode(torch, eng, arch, cfg):
    """gemma3-27b's windowed decode on the engine's full-width weights: a
    prompt of window + 16 = 1040 tokens (every local layer's ring
    wrapped), then AR_STEPS steps of ``decode_step`` on the full cache and
    of ``decode_step_mixed`` on the ring layout, fed the same seeded
    tokens; logits held to each other within MIXED_LOGITS_LIMIT (bf16),
    a limit a ring written one slot off (position p in slot (p + 1) % W,
    so each step evicts a key inside the window and keeps one outside)
    must exceed. Beside the largest difference, the mean one and the
    share of logits that differ. ms per step of each (synchronized).
    Counters zeroed before the prefill: its attention launches, and none
    in decode."""
    from repro_torch.models import transformer

    (_, weights), = eng.servable_for(arch)._weights.values()
    dev = eng.device
    counters = _counters()
    s = cfg.window + 16
    g = torch.Generator(device=dev)
    g.manual_seed(31)
    prompts = torch.randint(0, cfg.vocab, (BUCKET, s), generator=g,
                            device=dev)
    toks = torch.randint(0, cfg.vocab, (AR_STEPS, BUCKET, 1), generator=g,
                         device=dev)
    for mod in counters.values():
        mod.launches = 0
    logits, full = transformer.prefill(cfg, weights, prompts, s + AR_STEPS)
    del logits
    prefill_launches = {k: m.launches for k, m in counters.items()}
    mixed = transformer.mixed_from_full(cfg, full)
    # a cache of its own (decode writes in place), its rings one slot off
    off = mixed._replace(k_local=torch.roll(mixed.k_local, 1, dims=2),
                         v_local=torch.roll(mixed.v_local, 1, dims=2),
                         k_global=mixed.k_global.clone(),
                         v_global=mixed.v_global.clone())
    torch.cuda.synchronize()
    full_ms, mixed_ms, errs = [], [], []
    off_errs, off_mean, off_share = [], [], []
    for t in toks:
        t0 = time.perf_counter()
        lf, full, _ = transformer.decode_step(cfg, weights, full, t)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lm, mixed = transformer.decode_step_mixed(cfg, weights, mixed, t)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        lo, off = transformer.decode_step_mixed(cfg, weights, off, t)
        full_ms.append(1e3 * (t1 - t0))
        mixed_ms.append(1e3 * (t2 - t1))
        errs.append(float((lm - lf).abs().max()))
        gap = (lo - lf).abs()
        off_errs.append(float(gap.max()))
        off_mean.append(float(gap.mean()))
        off_share.append(float((gap > 0).float().mean()))
        if not (bool(torch.isfinite(lf).all())
                and bool(torch.isfinite(lm).all())):
            raise AssertionError(f"{arch} decode logits not finite")
    launches = {k: m.launches for k, m in counters.items()}
    rec = dict(prompt=s, window=cfg.window, steps=AR_STEPS, bucket=BUCKET,
               limit=MIXED_LOGITS_LIMIT, max_abs_err=errs,
               one_slot_off_max_abs_err=off_errs,
               one_slot_off_mean_abs_err=off_mean,
               one_slot_off_share_differing=off_share,
               logits_absmax=float(lf.abs().max()),
               decode_step_ms=full_ms, decode_step_mixed_ms=mixed_ms,
               decode_step_ms_mean=sum(full_ms[1:]) / (len(full_ms) - 1),
               decode_step_mixed_ms_mean=sum(mixed_ms[1:])
               / (len(mixed_ms) - 1),
               note="ms: host wall per step ended by a synchronize; the "
                    "means leave out the first step")
    emit({"phase": "lm", "part": "mixed_decode", **rec})
    want = {"abft_matmul": 0, "rollback_correct": 0, "drift_gemm_fused": 0,
            "flash_attention": cfg.n_layers, "fault_inject": 0,
            "stat_abft_matmul": 0}
    if prefill_launches != want or launches != want:
        raise AssertionError(f"{arch} mixed decode launches: prefill "
                             f"{prefill_launches}, total {launches}")
    if not max(errs) <= MIXED_LOGITS_LIMIT < max(off_errs):
        raise AssertionError(
            f"{arch} decode_step_mixed vs decode_step: max err {max(errs)}, "
            f"one slot off {max(off_errs)}, limit {MIXED_LOGITS_LIMIT}")
    return rec, launches


def _reference_drift_decode(torch):
    """SMOKE ``DriftDecode`` on the card and the CPU for a dense, an MoE
    and a hybrid arch: the same params and prompts, masks drawn on the
    CPU for both, 4 steps at BER 1e-2 (layer 0 at 0), refresh interval 2.
    Per step the argmax tokens and the detected rows, corrected elements
    and flagged tiles equal, logits within 1e-4 (the other LM rows'
    limit), and the store's shape (L, 2, n_out)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import fault
    from repro_torch.core.exec_ctx import DriftSystemConfig
    from repro_torch.core.rollback import RollbackConfig
    from repro_torch.models import transformer
    from repro_torch.serving.ar import prompt_tokens

    row = np.array([0.0, 1e-2, 1e-2], np.float32)
    dcfg = DriftSystemConfig(mode="drift",
                             rollback=RollbackConfig(interval=2))
    rows = []
    for arch in ("olmo-1b", "deepseek-moe-16b", "hymba-1.5b"):
        cfg = get_config(arch, smoke=True)
        params = transformer.init_params(cfg, 8)
        prompts = prompt_tokens(cfg, [0, 1])
        out = {}
        for device in ("cuda", "cpu"):
            w = transformer.prepare(cfg, _to(params, device))
            src = fault.PhiloxFlipSource(5, 0, "cpu")
            store = transformer.drift_store_spec(cfg, 2, device)
            logits, cache = transformer.prefill(cfg, w, prompts.to(device),
                                                prompts.shape[1] + 4)
            tok = logits[:, -1:].argmax(-1)
            ctxs, restore = _recording_contexts(transformer)
            steps = []
            try:
                for step in range(4):
                    ctxs.clear()
                    logits, cache, store = transformer.decode_step(
                        cfg, w, cache, tok, transformer.DriftDecode(
                            dcfg, src, row, store, step))
                    tok = logits[:, -1:].argmax(-1)
                    steps.append((logits.cpu(), tok.cpu(),
                                  _ctx_counts(ctxs)))
            finally:
                restore()
            out[device] = (steps, {k: tuple(v.shape)
                                   for k, v in store.items()})
        err = max(float((a[0] - b[0]).abs().max())
                  for a, b in zip(out["cuda"][0], out["cpu"][0]))
        same = all(torch.equal(a[1], b[1]) and a[2] == b[2]
                   for a, b in zip(out["cuda"][0], out["cpu"][0]))
        counts = [s[2] for s in out["cpu"][0]]
        if not (same and err <= 1e-4 and out["cuda"][1] == out["cpu"][1]
                and sum(c[2] for c in counts) > 0):
            raise AssertionError(f"{arch} SMOKE DriftDecode card vs CPU: "
                                 f"tokens/counts equal {same}, logits max "
                                 f"err {err}, counts {counts}")
        rows.append(dict(arch=arch, family=cfg.family, logits_max_abs_err=err,
                         detected_corrected_tiles=counts,
                         store_shapes=out["cpu"][1]))
    return rows


# arch -> (record key, path name, driver) of the decode paths its
# full-width engine also runs in ``_serve_ar``
DECODE_PATHS = {"olmo-1b": ("drift_decode", "ar+drift", _drift_decode),
                "gemma3-27b": ("mixed_decode", "lm+mixed", _mixed_decode)}


# ------------------------------------------------------ sharded serving
# denoising steps of the sharded phase's requests, cut to keep the whole
# script inside its time limit: step 2 is faulted (steps 0 and 1 run at
# the nominal point), so the ranks hold corrected counts to one process
SHARDED_STEPS = 3
SHARDED_ARGV = ["--arch", ARCH, "--no-smoke", "--batch", str(BUCKET),
                "--steps", str(SHARDED_STEPS), "--requests", "2", "--op",
                "undervolt", "--mode", "drift", "--device", "cuda"]
SHARDED_WORLD = 2
SHARDED_JOIN_S = 600


def _sharded_view(torch, eng, results):
    """What the sharded engine must reproduce bit for bit."""
    mon = eng.monitor
    return dict(
        results=[dict(request_id=r.request_id, latents=r.latents.cpu(),
                      corrected=r.batch_corrected_elems,
                      heatmap=r.detect_heatmap,
                      monitor=(r.monitor_ber, r.monitor_op_index),
                      energy_j=r.energy_j, breakdown=r.energy_breakdown,
                      psnr=r.psnr_vs_clean_db, evals=r.n_model_evals)
                 for r in results],
        monitor=(int(mon.n_updates), int(mon.op_index),
                 float(mon.ema_ber)))


def _sharded_rank(rank: int, world: int, model_parallel: int, tmp: str,
                  kind: str) -> None:
    """One rank of the sharded phase (``kind`` "dit") or of the sharded_lm
    phase ("lm") on a (data, model) mesh of model axis ``model_parallel``,
    a spawned process; ranks share cuda:0 over gloo. Saves what it served
    and measured, and the seconds from building the mesh to its last run
    (``mesh_s``)."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serving.sharded import ShardedDriftServeEngine

    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    mesh = mesh_lib.make_serving_mesh(
        model_parallel, device="cuda", init_method=f"file://{tmp}/rdzv",
        rank=rank, world_size=world, timeout_s=SHARDED_JOIN_S)

    def make(arch, smoke):
        return ShardedDriftServeEngine(mesh=mesh, arch=arch, smoke=smoke,
                                       bucket=BUCKET, device="cuda")
    if kind == "dit":
        rec = _sharded_dit(torch, make(ARCH, False), mesh)
    else:
        rec = dict(full=_sharded_lm_full(torch, make, mesh),
                   smoke=_sharded_lm_smoke(torch, make))
    rec.update(rank=rank, mesh=dict(mesh.shape), backend=mesh.backend,
               mesh_s=time.perf_counter() - t0)
    torch.save(rec, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


def _sharded_dit(torch, eng, mesh):
    """A sharded rank's DiT run: the serve phase's full-width request pair
    on ``eng`` with its seeded weights."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import dit

    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    eng.set_params(ARCH, False,
                   _perturb(torch, dit.init_params(cfg, 11, dev), cfg, 12,
                            dev))
    gc.collect()
    torch.cuda.empty_cache()
    counters = _counters()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    mesh.collectives = 0
    res, launches, wall = _serve_counted(torch, serve, eng, SHARDED_ARGV,
                                         counters)
    rec = _sharded_view(torch, eng, res)
    rec.update(launches=launches, wall_s=wall, held_bytes=held,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               collectives_per_batch=mesh.collectives / eng.stats.batches,
               batches=eng.stats.batches)
    return rec


def _equal_view(torch, got, want) -> bool:
    if got["monitor"] != want["monitor"]:
        return False
    for a, b in zip(got["results"], want["results"], strict=True):
        if not (torch.equal(a["latents"].view(torch.int32),
                            b["latents"].view(torch.int32))
                and all(a[k] == b[k] for k in a if k != "latents")):
            return False
    return True


def _spawn_ranks(torch, root: Path, kind: str):
    """SHARDED_WORLD ranks of ``kind`` (``_sharded_rank``) on a (data 2,
    model 1) mesh and as many on a (data 1, model 2) mesh, all spawned
    together, each mesh's ranks over a ``file://`` rendezvous of their
    own under ``root``: every mesh's records, rank by rank, and the
    command's seconds. A rank that exits non-zero, or does not join
    within SHARDED_JOIN_S, fails the phase."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    splits = (1, SHARDED_WORLD)
    for mp_ in splits:
        (root / f"model{mp_}").mkdir(parents=True)
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_sharded_rank,
                         args=(r, SHARDED_WORLD, mp_,
                               str(root / f"model{mp_}"), kind))
             for mp_ in splits for r in range(SHARDED_WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(SHARDED_JOIN_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * len(procs):
        raise AssertionError(f"sharded {kind} ranks (model axes "
                             f"{splits}, {SHARDED_WORLD} ranks each) "
                             f"exited {codes}")
    return ([[torch.load(root / f"model{mp_}" / f"rank{r}.pt",
                         weights_only=False)
              for r in range(SHARDED_WORLD)] for mp_ in splits],
            time.perf_counter() - t0)


def _sharded_cli(args):
    """The SMOKE ``launch.serve --sharded`` under ``python -m
    torch.distributed.run`` (SHARDED_WORLD ranks on cuda:0), started."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(SHARDED_WORLD), "-m",
         "repro_torch.launch.serve", "--sharded", *args, "--device", "cuda"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)


def _stop_cli(cli) -> None:
    """Stop ``cli`` (``_sharded_cli``): the launcher stops its ranks."""
    cli.terminate()
    try:
        cli.communicate(timeout=30)
    except subprocess.TimeoutExpired:
        cli.kill()
        cli.communicate()


def _check_cli(cli, lines) -> None:
    """``cli`` (``_sharded_cli``) must exit 0 within SHARDED_JOIN_S and
    print each of ``lines`` once."""
    try:
        out, err = cli.communicate(timeout=SHARDED_JOIN_S)
    except subprocess.TimeoutExpired:
        _stop_cli(cli)
        raise AssertionError(f"sharded CLI {cli.args[-6:]} did not finish "
                             f"in {SHARDED_JOIN_S} s")
    if cli.returncode != 0 or any(out.count(s) != 1 for s in lines):
        raise AssertionError(f"sharded CLI exited {cli.returncode}, each of "
                             f"{lines} once wanted:\n{out[-2000:]}\n"
                             f"{err[-2000:]}")


def phase_sharded(torch, smi):
    """Serving across ranks (``serving.sharded``): the serve phase's 2
    full-width DiT-XL/2-512 requests (bucket 2, SHARDED_STEPS steps, drift
    at undervolt, its seeded weights) in one process, each correcting
    elements, then on a (data 2, model 1) and a (data 1, model 2) mesh,
    each of 2 spawned ranks, the 4 ranks run together sharing cuda:0 over
    gloo (NCCL refuses two ranks on one card). Every rank's
    latents, heatmap of detections, corrected counts, monitor state and
    billed joules equal the single process's (latents on their int32
    views), and so do its launch counts, zeroed just before and read just
    after each run. Per rank: wall, peak memory over the run and the
    collectives a batch. Beside the ranks, the SMOKE CLI ``--sharded``
    under ``python -m torch.distributed.run`` (2 ranks, cuda:0) must exit
    0 and print the mesh line."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import dit
    from repro_torch.serving import DriftServeEngine

    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    counters = _counters()
    eng = DriftServeEngine(arch=ARCH, smoke=False, bucket=BUCKET,
                           device="cuda")
    eng.set_params(ARCH, False,
                   _perturb(torch, dit.init_params(cfg, 11, dev), cfg, 12,
                            dev))
    torch.cuda.reset_peak_memory_stats()
    res, single_launches, single_wall = _serve_counted(
        torch, serve, eng, SHARDED_ARGV, counters)
    single = _sharded_view(torch, eng, res)
    single_peak = torch.cuda.max_memory_allocated()
    if not all(r["corrected"] > 0 for r in single["results"]):
        raise AssertionError("sharded: one process corrected "
                             f"{[r['corrected'] for r in single['results']]}")
    del eng, res
    gc.collect()
    torch.cuda.empty_cache()

    root = ROOT / "build" / "sharded"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    mesh_line = "[serve] mesh {'data': 2, 'model': 1} backend gloo"
    cli = _sharded_cli(["--steps", "3"])
    try:
        per_mesh, command_s = _spawn_ranks(torch, root, "dit")
    except BaseException:
        _stop_cli(cli)
        raise
    _check_cli(cli, [mesh_line])
    cli_s = time.perf_counter() - t0
    meshes, total = {}, {}
    for recs in per_mesh:
        for rec in recs:
            if not _equal_view(torch, rec, single):
                raise AssertionError(f"sharded rank {rec['rank']} on "
                                     f"{rec['mesh']} differs from one "
                                     "process")
            if rec["launches"] != single_launches:
                raise AssertionError(f"sharded rank {rec['rank']} launches "
                                     f"{rec['launches']} != "
                                     f"{single_launches}")
            _add_launches(total, rec["launches"])
        name = "data{data}_model{model}".format(**recs[0]["mesh"])
        meshes[name] = dict(
            backend=recs[0]["backend"],
            ranks=[{k: r[k] for k in ("rank", "mesh_s", "wall_s",
                                      "held_bytes", "peak_mem_bytes",
                                      "collectives_per_batch", "batches",
                                      "launches")} for r in recs])
    return dict(arch=ARCH, bucket=BUCKET, steps=SHARDED_STEPS,
                world=SHARDED_WORLD, card=smi,
                single=dict(wall_s=single_wall, peak_mem_bytes=single_peak,
                            launches=single_launches,
                            corrected=[r["corrected"]
                                       for r in single["results"]],
                            monitor=single["monitor"]),
                meshes=meshes, command_s=command_s, launches=total,
                cli=dict(wall_s=cli_s, mesh_line=mesh_line,
                         note="run beside the spawned ranks"),
                energy=[],
                note="wall_s: host wall of one serve.main run (drift and "
                     "its clean reference) ended by a synchronize; "
                     "peak_mem_bytes: max_memory_allocated over that run "
                     "in the rank's process; launches: the rank's own "
                     "counters; the phase's launches sum every rank of "
                     "both meshes; mesh_s: the rank's seconds from "
                     "building the mesh to its last run, beside the other "
                     "mesh's ranks; command_s: the 4 ranks' command, both "
                     "meshes run together, while the CLI ran beside them")


# ---------------------------------------------- sharded language models
# full-width olmo-1b's request pair: 4 tokens give 2 faulted decode steps
# above the engine's nominal_steps = 2, each gathering every layer
SHARDED_LM_STEPS = 4
SHARDED_LM_WINDOW = 2
SHARDED_LM_ARGV = ["--arch", AR_ARCH, "--no-smoke", "--batch", str(BUCKET),
                   "--requests", "2", "--steps", str(SHARDED_LM_STEPS),
                   "--rollback-interval", str(SHARDED_LM_WINDOW), "--op",
                   "undervolt", "--mode", "stat_abft", "--device", "cuda"]
# every other LM family at SMOKE, stat_abft then faulty on one engine
SHARDED_LM_SMOKE = ("gemma2-9b", "glm4-9b", "gemma3-27b", "deepseek-moe-16b",
                    "kimi-k2-1t-a32b", "mamba2-370m", "hymba-1.5b")
SHARDED_LM_SMOKE_STEPS, SHARDED_LM_SMOKE_WINDOW = 6, 3


def _lm_view(eng, results):
    """What a sharded rank must reproduce: every field of every result
    (tokens, detections, rollbacks, evaluations, joules and their ledger,
    the monitor after the batch), and the engine's monitor."""
    mon = eng.monitor
    return dict(results=[dataclasses.asdict(r) for r in results],
                monitor=(int(mon.n_updates), int(mon.op_index),
                         float(mon.ema_ber)))


def _gather_bytes(torch, weights) -> int:
    """The bytes one evaluation sums over the mesh to gather ``weights``
    (``transformer.Weights``): each weight of rank >= 1 (those
    ``shard_tree`` shards) in its 512-byte-aligned region of a gather
    buffer (``constraints._gather_shards``)."""
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves([weights.embed, weights.layers, weights.final_norm,
                          weights.lm_head])
    return sum(-(-t.numel() * t.element_size() // 512) * 512 for t in leaves
               if isinstance(t, torch.Tensor) and t.ndim >= 1)


def _sharded_lm_full(torch, make, mesh=None):
    """Full-width olmo-1b through ``serve.main`` (SHARDED_LM_ARGV) on
    ``make(AR_ARCH, False)`` with the ar phase's weights
    (``transformer.init_weights`` on the card, seed 21): the view, the
    launches zeroed just before and read just after, the wall, the
    evaluations of every decode batch (stat_abft's and its clean
    reference's), held and peak memory; on a mesh also the collectives
    and the bytes summed over it (``mesh.sum_bytes``) an evaluation,
    which must be ``_gather_bytes`` of the weights. The engine is freed
    before it returns."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.serving import ar

    cfg = get_config(AR_ARCH)
    eng = make(AR_ARCH, False)
    weights = transformer.init_weights(cfg, 21, torch.device("cuda"))
    per_eval = _gather_bytes(torch, weights)
    eng.set_params(AR_ARCH, False, weights)
    del weights
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    decode, evals = ar.decode_batch, []

    def recording_decode(*args, **kw):
        out = decode(*args, **kw)
        evals.append(out.n_model_evals)
        return out
    summed = [0]
    if mesh is not None:
        sum_bytes = mesh.sum_bytes

        def counting_sum_bytes(full, group=None):
            summed[0] += full.numel() * full.element_size()
            return sum_bytes(full, group=group)
        mesh.sum_bytes = counting_sum_bytes
        mesh.collectives = 0
    torch.cuda.reset_peak_memory_stats()
    ar.decode_batch = recording_decode
    try:
        res, launches, wall = _serve_counted(torch, serve, eng,
                                             SHARDED_LM_ARGV, _counters())
    finally:
        ar.decode_batch = decode
        if mesh is not None:
            del mesh.sum_bytes
    n_evals = sum(evals)
    out = dict(view=_lm_view(eng, res), launches=launches, wall_s=wall,
               tokens=sum(len(r.tokens) for r in res), evals=evals,
               held_bytes=held,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               energy=check_energy("sharded_lm", f"{AR_ARCH} stat_abft",
                                   res))
    out["wall_per_token_s"] = wall / out["tokens"]
    if mesh is not None:
        if summed[0] != per_eval * n_evals:
            raise AssertionError(f"sharded_lm: {summed[0]} bytes summed over "
                                 f"the mesh in {n_evals} evaluations, not "
                                 f"{per_eval} each")
        out.update(collectives_per_eval=mesh.collectives / n_evals,
                   gathered_bytes_per_eval=per_eval,
                   gathered_gb_per_s_of_wall=summed[0] / wall / 1e9)
    del eng, res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _sharded_lm_smoke(torch, make):
    """Each SHARDED_LM_SMOKE arch at SMOKE through ``serve.main``, 2
    requests at bucket 2, SHARDED_LM_SMOKE_STEPS tokens, window
    SHARDED_LM_SMOKE_WINDOW, stat_abft then faulty at undervolt on one
    engine: per "arch mode" the view, the launches zeroed just before and
    read just after, and the checked ledgers."""
    from repro_torch.launch import serve
    counters = _counters()
    out = {}
    for arch in SHARDED_LM_SMOKE:
        eng = make(arch, True)
        for mode in ("stat_abft", "faulty"):
            argv = ["--arch", arch, "--batch", str(BUCKET), "--requests",
                    "2", "--steps", str(SHARDED_LM_SMOKE_STEPS),
                    "--rollback-interval", str(SHARDED_LM_SMOKE_WINDOW),
                    "--op", "undervolt", "--mode", mode, "--device", "cuda"]
            res, launches, _ = _serve_counted(torch, serve, eng, argv,
                                              counters)
            out[f"{arch} {mode}"] = dict(
                view=_lm_view(eng, res), launches=launches,
                energy=check_energy("sharded_lm", f"{arch} {mode}", res))
    return out


def _check_lm_single(full, smoke) -> None:
    """One process's sharded_lm runs, before any rank is held to them:
    full-width olmo-1b's exact launches (SHARDED_LM_STEPS - 2 faulted
    steps of 105 ``fault_inject`` launches; 16 attention launches in
    each of 2 prefills, stat_abft's and its clean reference's),
    detections, rollbacks, token match 1.0, replays billed; each SMOKE
    arch's stat_abft back on the clean tokens, detecting and rolling
    back where it has a protected GEMM (mamba2-370m has none), its
    faulty run never rolling back; every arch's kernels launched."""
    from repro_torch.configs import get_config
    cfg = get_config(AR_ARCH)
    faulted = SHARDED_LM_STEPS - 2        # engine.nominal_steps = 2
    want = {"abft_matmul": 0, "rollback_correct": 0, "drift_gemm_fused": 0,
            "flash_attention": 2 * cfg.n_layers,
            "fault_inject": faulted * (cfg.n_layers - 1) * 7,
            "stat_abft_matmul": 0}
    if full["launches"] != want:
        raise AssertionError(f"sharded_lm {AR_ARCH} launches "
                             f"{full['launches']} != {want}")
    for r in full["view"]["results"]:
        if not (len(r["tokens"]) == SHARDED_LM_STEPS
                and r["ar_detections"] > 0 and r["ar_rollbacks"] >= 1
                and r["token_match_vs_clean"] == 1.0
                and r["n_model_evals"] > SHARDED_LM_STEPS
                and r["energy_breakdown"]["compute_replay"] > 0):
            raise AssertionError(f"sharded_lm {AR_ARCH} request: {r}")
    for key, run in smoke.items():
        arch, mode = key.split()
        protected = arch != "mamba2-370m"
        if run["launches"]["fault_inject"] == 0 and protected:
            raise AssertionError(f"sharded_lm {key}: no fault_inject launch")
        for r in run["view"]["results"]:
            ok = (len(r["tokens"]) == SHARDED_LM_SMOKE_STEPS
                  and (r["ar_rollbacks"] == 0 if mode == "faulty" else
                       r["token_match_vs_clean"] == 1.0
                       and (r["ar_detections"] > 0
                            and r["ar_rollbacks"] >= 1) == protected))
            if not ok:
                raise AssertionError(f"sharded_lm {key} request: {r}")


def phase_sharded_lm(torch, smi):
    """The sharded engine's language-model buckets (``serving.sharded``:
    a bucket runs whole on every rank, each layer's weights, sharded at
    rest, gathered at its boundary). In one process, full-width olmo-1b
    (the ar phase's weights) serves 2 stat_abft requests of
    SHARDED_LM_STEPS tokens at window SHARDED_LM_WINDOW through the CLI's
    ``main``; then every other LM family at SMOKE (SHARDED_LM_SMOKE) 2
    requests of SHARDED_LM_SMOKE_STEPS tokens in stat_abft and in faulty,
    while the SMOKE ``--sharded --arch olmo-1b`` CLI runs on 2 ranks
    under ``torch.distributed.run`` (exit 0, the mesh line and each
    request's line once). Then the same on a (data 2, model 1) and a
    (data 1, model 2) mesh, each of 2 spawned ranks, the 4 ranks run
    together sharing cuda:0 over gloo: every rank's results, field for
    field, and monitor equal the one
    process's, and so do its launch counts. Per rank: the wall, the wall
    per token, the collectives and the bytes gathered per evaluation,
    held and peak memory."""
    import shutil
    from repro_torch.serving import DriftServeEngine

    def make(arch, smoke):
        return DriftServeEngine(arch=arch, smoke=smoke, bucket=BUCKET,
                                device="cuda")
    full = _sharded_lm_full(torch, make)
    t0 = time.perf_counter()
    cli = _sharded_cli(["--arch", AR_ARCH, "--steps",
                        str(SHARDED_LM_STEPS)])
    try:
        smoke = _sharded_lm_smoke(torch, make)
    except BaseException:
        _stop_cli(cli)
        raise
    cli_lines = ["[serve] mesh {'data': 2, 'model': 1} backend gloo",
                 "  req 0 (", "  req 1 ("]
    _check_cli(cli, cli_lines)
    cli_s = time.perf_counter() - t0
    _check_lm_single(full, smoke)

    root = ROOT / "build" / "sharded_lm"
    shutil.rmtree(root, ignore_errors=True)
    per_mesh, command_s = _spawn_ranks(torch, root, "lm")
    meshes, total = {}, {}
    for recs in per_mesh:
        for rec in recs:
            where = f"sharded_lm rank {rec['rank']} on {rec['mesh']}"
            if rec["backend"] != "gloo":
                raise AssertionError(f"{where}: backend {rec['backend']}")
            if rec["smoke"].keys() != smoke.keys():
                raise AssertionError(f"{where} served {list(rec['smoke'])}")
            runs = {AR_ARCH: (rec["full"], full), **{
                k: (v, smoke[k]) for k, v in rec["smoke"].items()}}
            for key, (got, want) in runs.items():
                if got["view"] != want["view"]:
                    raise AssertionError(f"{where}: {key} differs from one "
                                         "process")
                if got["launches"] != want["launches"]:
                    raise AssertionError(f"{where}: {key} launches "
                                         f"{got['launches']} != "
                                         f"{want['launches']}")
                _add_launches(total, got["launches"])
        name = "data{data}_model{model}".format(**recs[0]["mesh"])
        meshes[name] = dict(backend=recs[0]["backend"],
                            ranks=[dict(rank=r["rank"], mesh_s=r["mesh_s"], **{
                                k: r["full"][k] for k in (
                                    "wall_s", "wall_per_token_s", "tokens",
                                    "evals", "collectives_per_eval",
                                    "gathered_bytes_per_eval",
                                    "gathered_gb_per_s_of_wall",
                                    "held_bytes", "peak_mem_bytes",
                                    "launches")}) for r in recs])
    energy = full.pop("energy") + [e for run in smoke.values()
                                   for e in run.pop("energy")]
    return dict(
        arch=AR_ARCH, bucket=BUCKET, steps=SHARDED_LM_STEPS,
        window=SHARDED_LM_WINDOW, world=SHARDED_WORLD, card=smi,
        single={k: full[k] for k in ("wall_s", "wall_per_token_s", "tokens",
                                     "evals", "held_bytes",
                                     "peak_mem_bytes", "launches")},
        requests=[{k: r[k] for k in ("request_id", "tokens",
                                     "ar_detections", "ar_rollbacks",
                                     "n_model_evals", "token_match_vs_clean",
                                     "energy_j")}
                  for r in full["view"]["results"]],
        monitor=full["view"]["monitor"],
        smoke={k: dict(launches=v["launches"],
                       detections=[r["ar_detections"]
                                   for r in v["view"]["results"]],
                       rollbacks=[r["ar_rollbacks"]
                                  for r in v["view"]["results"]])
               for k, v in smoke.items()},
        meshes=meshes, command_s=command_s, launches=total,
        cli=dict(wall_s=cli_s, lines=cli_lines,
                 note="run beside the one process's SMOKE archs"),
        energy=energy,
        note="wall_s: host wall of one serve.main run (stat_abft and its "
             "clean reference) ended by a synchronize; tokens: the "
             "requests' tokens; evals: each decode batch's evaluations "
             "(stat_abft's, then its clean reference's); "
             "gathered_bytes_per_eval: the gather buffers one evaluation "
             "sums over the mesh, checked against the bytes mesh.sum_bytes "
             "summed; gathered_gb_per_s_of_wall: all of them over the "
             "run's wall, not a profile of the gathers; peak_mem_bytes: "
             "max_memory_allocated over the run in the rank's process; "
             "launches: the rank's own counters; the phase's launches sum "
             "every rank of both meshes, olmo-1b's and the SMOKE archs'; "
             "mesh_s: the rank's seconds from building the mesh to its "
             "last run; every rank's numbers with the other mesh's ranks "
             "beside it; command_s: the 4 ranks' command, both meshes run "
             "together")


# ----------------------------------------------------------- roofline
ROOFLINE_REPS = 5           # timed calls a path, after one warm-up
ROOFLINE_SHARE_LIMIT = 1.05  # bound / measured above this: a count is wrong


def _roof_serve(torch):
    """The full-width DiT's drift evaluation at bucket 2: one denoising
    step with DRIFT on every GEMM (``dryrun.drift_sample_step``) on the
    engine's f32 params, BER 3e-3 in the body class."""
    from repro_torch.configs import get_config
    from repro_torch.core import fault
    from repro_torch.launch import dryrun
    from repro_torch.models import dit
    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    g = torch.Generator(device=dev)
    g.manual_seed(31)
    params = dit.init_params(cfg, 31, dev)
    lat = torch.randn((BUCKET, cfg.latent_size, cfg.latent_size,
                       cfg.latent_channels), generator=g, device=dev)
    labels = torch.arange(BUCKET, device=dev)
    stores = dit.drift_store_spec(cfg, BUCKET, dev)
    step = dryrun.drift_sample_step(cfg)
    src = fault.PhiloxFlipSource(31, 0, dev)
    return (f"{ARCH} drift evaluation, bucket {BUCKET}", step,
            (params, lat, 500, labels, *stores), {"flip_source": src})


def _roof_train(torch):
    """Full-width olmo-1b's train step at TRAIN_BATCH x TRAIN_SEQ, one
    process (the ``train`` phase's)."""
    from repro_torch import configs
    from repro_torch.data import synthetic
    from repro_torch.optim.adamw import OptimConfig
    from repro_torch.train import steps
    cfg = configs.get_config(AR_ARCH)
    ocfg = OptimConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    state = steps.init_train_state(cfg, ocfg, 32, "cuda")
    batch = synthetic.batch_at(
        synthetic.for_model(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=32), 0,
        device="cuda")
    return (f"{AR_ARCH} train step, batch {TRAIN_BATCH} x seq "
            f"{TRAIN_SEQ}", steps.make_train_step(cfg, ocfg),
            (state, batch), {})


def _roof_ar(torch):
    """Full-width olmo-1b's stat_abft decode step at bucket 2 (the ``ar``
    phase's decoder, a faulted step after an 8-token prefill)."""
    from repro_torch.configs import get_config
    from repro_torch.core import dvfs, fault
    from repro_torch.launch import op_analysis
    from repro_torch.models import transformer
    from repro_torch.serving import ar
    dev = torch.device("cuda")
    cfg = get_config(AR_ARCH)
    weights = transformer.init_weights(cfg, 33, dev)
    schedule = dvfs.fine_grained_schedule(AR_STEPS + 1, dvfs.UNDERVOLT)
    fns = ar.make_decoder(cfg, ar.DecodeConfig(AR_STEPS + 1, AR_WINDOW,
                                               "stat_abft", 3e-3),
                          schedule=schedule)
    tok, cache = fns.prefill(weights, ar.prompt_tokens(cfg, [0, 1], dev))
    src = fault.PhiloxFlipSource(33, 0, dev)

    def step(weights, cache, tok, monitor):
        return fns.step(weights, cache, tok, 4, monitor,
                        op_analysis.uncounted_source(src, tok.device), 1.0)
    return (f"{AR_ARCH} stat_abft decode step, bucket {BUCKET}", step,
            (weights, cache, tok, dvfs.ber_monitor_init(dev)), {})


def phase_roofline(torch, smi):
    """Three card paths (``_roof_serve``, ``_roof_train``, ``_roof_ar``),
    each: (a) counted on meta tensors through ``op_analysis.analyze``;
    (b) counted again on the card with its tensors and kernels under the
    same counter, FLOPs, int8 ops, bytes and each kernel's calls equal to
    (a)'s (both come from shapes); (c) timed, synchronised, the median of
    ROOFLINE_REPS calls after a warm-up; (d) its roofline on ``perfmodel.hw.H100_SXM``
    (``launch.roofline.roofline_row``): the dominant term, the bound and
    the share bound / measured, which must not pass
    ROOFLINE_SHARE_LIMIT."""
    from repro_torch.launch import dryrun, op_analysis, roofline
    rows = []
    for build in (_roof_serve, _roof_train, _roof_ar):
        name, fn, args, kw = build(torch)
        meta = op_analysis.analyze(fn, *dryrun.to_meta(args),
                                   **dryrun.to_meta(kw))
        card = op_analysis.analyze(fn, *args, **kw)
        torch.cuda.synchronize()
        for key in ("flops", "int8_ops", "bytes", "kernels"):
            if meta[key] != card[key]:
                raise AssertionError(f"roofline {name}: {key} on meta "
                                     f"{meta[key]} != on the card "
                                     f"{card[key]}")
        fn(*args, **kw)
        torch.cuda.synchronize()
        times = []
        for _ in range(ROOFLINE_REPS):
            t0 = time.perf_counter()
            fn(*args, **kw)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        ms = sorted(times)[len(times) // 2]
        rr = roofline.roofline_row(dict(
            arch=name, shape="", mesh=[1], n_devices=1, model_flops=0.0,
            flops_per_device=card["flops"],
            int8_ops_per_device=card["int8_ops"],
            bytes_per_device=card["bytes"],
            collective_bytes_per_device=0.0))
        bound_ms = 1e3 * max(rr["t_compute_s"], rr["t_memory_s"],
                             rr["t_collective_s"])
        row = dict(path=name, flops=card["flops"],
                   int8_ops=card["int8_ops"], bytes=card["bytes"],
                   kernels=card["kernels"], dominant=rr["dominant"],
                   t_compute_ms=1e3 * rr["t_compute_s"],
                   t_memory_ms=1e3 * rr["t_memory_s"], bound_ms=bound_ms,
                   ms=ms, times_ms=times, share=bound_ms / ms,
                   meta_count_s=meta["count_s"],
                   card_count_s=card["count_s"],
                   top_ops=card["top_ops"][:5])
        rows.append(row)
        del fn, args, kw
        gc.collect()
        torch.cuda.empty_cache()
        if row["share"] > ROOFLINE_SHARE_LIMIT:
            raise AssertionError(f"roofline {name}: bound {bound_ms} ms over "
                                 f"measured {ms} ms is {row['share']}")
    emit({"phase": "roofline", "nvidia_smi": smi, "paths": rows,
          "note": "counts from shapes (launch.op_analysis), equal on meta "
                  "and on the card; bound_ms is the H100 SXM roofline "
                  "(perfmodel.hw.H100_SXM: 989 TFLOP/s bf16, 1979 TOP/s "
                  "int8, 3.35 TB/s) of those counts, elementwise ops "
                  "unfused as eager PyTorch runs them; ms the median of "
                  f"{ROOFLINE_REPS} synchronised calls; share = "
                  "bound_ms / ms"})
    return {"paths": [dict(path=r["path"], share=r["share"],
                           dominant=r["dominant"]) for r in rows]}


# ----------------------------------------------------------- examples
EXAMPLES = (("quickstart", []),
            ("drift_serve", ["--requests", "2", "--batch", "2",
                             "--steps", "3"]),
            ("resilience_study", ["--probe", "bits"]))
EXAMPLES_TIMEOUT_S = 120


def phase_examples(torch):
    """The port's examples on the card at SMOKE, as subprocesses started
    together, each with ``PYTHONPATH=src``: each must exit 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.examples.{name}", *argv],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, argv in EXAMPLES}
    out = {}
    try:
        for name, proc in procs.items():
            t0 = time.perf_counter()
            text, _ = proc.communicate(timeout=EXAMPLES_TIMEOUT_S)
            out[name] = dict(rc=proc.returncode,
                             tail=text.strip().splitlines()[-3:],
                             wait_s=time.perf_counter() - t0)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    bad = {n: r for n, r in out.items() if r["rc"] != 0}
    if bad:
        raise AssertionError(f"examples failed: {bad}")
    return {"examples": out}


def kernel_summary(kernels_out, path_launches, backward_calls):
    """One row per TPU kernel of the repo. ``launches`` sums the counts
    of the paths that ran (``launches_by_path``). ``mha_flash`` launches
    nothing of its own: its row carries the ``flash_attention`` launches
    of the ar, lm, moe, ssm, sharded_lm, train and train_sharded paths,
    all made through it, and the train paths' backward calls (the plain version's
    gradient, recomputed; ``backward_calls_by_path``). The composites keep no count
    (``launches`` null): each call's launches are counted under the
    kernels it calls."""
    (abft_rows, rb_rows, fl_rows, fi_rows, mha_rows, stat_row, drift_row,
     (dd_abft, dd_rb), (fused_rows, fused_fam, dd_fused),
     lm_rows) = kernels_out

    def launches(name, paths=None):
        by = {p: c[name] for p, c in path_launches.items()
              if paths is None or p in paths}
        return (sum(by.values()) if by else None), by

    def row(name, source, replaces, stats, bound_by, per, library_ms,
            counted=None, paths=None, note=None):
        n, by = launches(counted or name, paths)
        out = dict(name=name, route="cuda", source=source,
                   replaces=replaces, launches=n, launches_by_path=by,
                   max_abs_err=stats["max_abs_err"], ms=stats["ms"],
                   plain_ms=stats["plain_ms"], bound_ms=stats["bound_ms"],
                   bound_by=bound_by, library_ms=library_ms, per=per)
        if note:
            out["launches_note"] = note
        for key in ("kernel_ms", "transpose_ms"):
            if key in stats:
                out[key] = stats[key]
        return out

    def composite(name, source, replaces, stats, per, kernels):
        return row(name, source, replaces, stats, stats["bound_by"], per,
                   None, paths=(), note="composite; launches counted under "
                   + "/".join(kernels))

    def mix(rows, per_key):
        live = [r for r in rows if r[per_key]]
        out = {k: sum(r[k] * r[per_key] for r in live)
               / sum(r[per_key] for r in live)
               for k in ("ms", "kernel_ms", "transpose_ms", "plain_ms",
                         "bound_ms", "library_ms")
               if live[0].get(k) is not None}
        out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
        return out

    csrc = "src/repro_torch/kernels/csrc/"
    fl, mha = fl_rows["bfloat16"], mha_rows["bfloat16"]
    fi = mix(fi_rows, "per_step")

    def decode_shapes(rows):
        return [{k: r[k] for k in ("name", "m", "k", "n", "valid",
                                   "per_layer", "max_abs_err", "ms",
                                   "kernel_ms", "transpose_ms", "splits",
                                   "plain_ms", "bound_ms", "bound_by")
                 if k in r} for r in rows]
    return [
        dict(row("abft_matmul", csrc + "abft_matmul.cu",
                 "src/repro/kernels/abft_matmul.py:79",
                 mix(abft_rows, "per_eval"), "bytes",
                 "mean per launch over one DiT-XL evaluation's 172 GEMMs "
                 "at bucket 2; decode_shapes: DriftDecode's", None),
             decode_shapes=decode_shapes(dd_abft)),
        dict(row("rollback_correct", csrc + "rollback_correct.cu",
                 "src/repro/kernels/rollback_correct.py:34",
                 mix(rb_rows, "per_eval"), "bytes",
                 "mean per launch over one DiT-XL evaluation's 172 GEMMs "
                 "at bucket 2; decode_shapes: DriftDecode's", None),
             decode_shapes=decode_shapes(dd_rb)),
        dict(row("drift_gemm_fused", csrc + "drift_gemm.cu",
                 "src/repro/kernels/ops.py:44",
                 mix(fused_rows, "per_eval"), "bytes",
                 "mean per launch over one DiT-XL evaluation's 172 GEMMs "
                 "at bucket 2, unpadded; family_shapes: PixArt's and the "
                 "UNet's text GEMMs; decode_shapes: DriftDecode's", None),
             family_shapes=decode_shapes(fused_fam),
             decode_shapes=decode_shapes(dd_fused)),
        row("flash_attention", csrc + "flash_attention.cu",
            "src/repro/kernels/flash_attention.py:71", fl, fl["bound_by"],
            "one launch through mha_flash on the DiT's (2, 1024, 16, 72) "
            "bf16 projections in place (token stride 1152)",
            fl["library_ms"]),
        dict(row("mha_flash", "src/repro_torch/kernels/flash_attention.py",
                 "src/repro/kernels/flash_attention.py:105", mha,
                 mha["bound_by"], "one call, (2, 8, 16, 128) bf16 causal "
                 "(the olmo-1b prefill's), one kernel on the tensors in "
                 "place; lm_shapes: the GQA models' calls",
                 mha["library_ms"],
                 counted="flash_attention",
                 paths=("ar", "ar+drift", "lm", "lm+mixed", "moe", "ssm",
                        "sharded_lm", "train", "train_sharded"),
                 note="the flash_attention launches of the ar, ar+drift, "
                      "lm, lm+mixed, moe, ssm, sharded_lm, train and "
                      "train_sharded paths, each made through mha_flash; "
                      "not a kernel of its own"),
             backward_calls=sum(backward_calls.values()) if backward_calls
             else None, backward_calls_by_path=backward_calls,
             lm_shapes=[{k: r.get(k) for k in (
                 "name", "shape", "window", "softcap", "max_abs_err", "ms",
                 "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "library_call", "bwd_ms", "bwd_bound_ms",
                 "bwd_library_ms") if k in r}
                 for r in lm_rows]),
        row("fault_inject", csrc + "fault_inject.cu",
            "src/repro/kernels/fault_inject.py:24", fi, "bytes",
            "mean per launch over one decode step's 7 GEMM outputs, "
            "(2, 1, 2048) x5 and (2, 1, 8192) x2 f32",
            fi["library_ms"]),
        composite("drift_gemm", "src/repro_torch/kernels/ops.py",
                  "src/repro/kernels/ops.py:44", drift_row,
                  "one call, 2048x1152x1152 f32 (quantization "
                  "included); the serving path runs its kernel from "
                  "ExecContext", ("drift_gemm_fused",)),
        dict(row("stat_abft_matmul", csrc + "stat_abft.cu",
                 "src/repro/kernels/stat_abft.py:103", stat_row,
                 stat_row["bound_by"],
                 "one call, 2048x1152x1152 int8, 128-wide row tiles, its "
                 "transpose of B included; on no serving path (every "
                 "path asserts 0 launches); shapes: the DiT's three body "
                 "GEMMs", None),
             composite_ms=stat_row["composite_ms"],
             shapes=[{k: r[k] for k in (
                 "shape", "bn", "max_abs_err", "ms", "kernel_ms",
                 "transpose_ms", "plain_ms", "composite_ms", "bound_ms",
                 "bound_by", "tops", "share") if k in r}
                 for r in stat_row["shapes"] if "ms" in r]),
    ]


# ------------------------------------------------------------------ main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed launches per kernel measurement")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device: "
                           "torch.cuda.is_available() is False")
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise RuntimeError(f"no src/repro_torch beside {Path(__file__).name}"
                           ": run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _lib
    _peaks()

    t_start = time.perf_counter()
    smi = nvidia_smi()
    kernels_out = None
    path_launches = {}
    backward_calls = {}
    energy_recs = []
    for phase in PHASES:
        if phase not in phases:
            continue
        t0 = time.perf_counter()
        rec = {"phase": phase}
        if phase == "device":
            rec.update(nvidia_smi=smi, torch=torch.__version__,
                       cuda=torch.version.cuda,
                       name=torch.cuda.get_device_name(0),
                       count=torch.cuda.device_count(),
                       python=sys.version.split()[0])
        elif phase == "build":
            logs = _lib.build_all(ptxas_verbose=True)
            rec["built"] = sorted(logs)
            rec["ptxas"] = {n: ptxas_summary(log) for n, log in logs.items()}
            for name in WGMMA_KERNELS:
                spilled = [f for f in rec["ptxas"].get(name, [])
                           if f.get("spill_stores") or f.get("spill_loads")]
                serialized = "C7518" in logs.get(name, "")
                if spilled or serialized:
                    raise AssertionError(f"{name} spills {spilled}, wgmma "
                                         f"serialized by ptxas: "
                                         f"{serialized}")
        elif phase == "kernels":
            kernels_out = (phase_kernels(torch, args.reps)
                           + phase_kernels_ar(torch, args.reps)
                           + (phase_kernels_fused(torch, args.reps),
                              phase_kernels_lm(torch, args.reps)))
            rec["single_flip"] = {
                line["kernel"]: dict(launches=line["launches"],
                                     lowest_flagged_bit=[
                                         r["lowest_flagged_bit"]
                                         for r in line["shapes"]])
                for line in phase_kernels_flips(torch)}
        elif phase == "reference":
            rec.update(phase_reference(torch))
        elif phase in ("serve", "offload", "sched", "ar", "lm", "moe",
                       "ssm", "baselines", "families", "resilience",
                       "sharded", "sharded_lm", "train", "train_sharded"):
            out = (phase_serve(torch) if phase == "serve"
                   else phase_offload(torch, smi) if phase == "offload"
                   else phase_sched(torch, smi) if phase == "sched"
                   else phase_ar(torch) if phase == "ar"
                   else phase_lm(torch) if phase == "lm"
                   else phase_moe(torch) if phase == "moe"
                   else phase_ssm(torch) if phase == "ssm"
                   else phase_baselines(torch) if phase == "baselines"
                   else phase_resilience(torch, smi)
                   if phase == "resilience"
                   else phase_sharded(torch, smi) if phase == "sharded"
                   else phase_sharded_lm(torch, smi)
                   if phase == "sharded_lm"
                   else phase_train(torch, smi) if phase == "train"
                   else phase_train_sharded(torch, smi)
                   if phase == "train_sharded"
                   else phase_families(torch, args.reps))
            path_launches[phase] = out["launches"]
            path_launches.update(out.pop("extra_launches", {}))
            if phase == "serve":
                path_launches["serve+taylorseer"] = \
                    out["taylorseer_launches"]
            if phase == "offload":
                path_launches["offload+steady"] = out["steady_launches"]
            if phase == "sched":
                path_launches["sched+auto"] = out["auto_launches"]
            if phase in ("train", "train_sharded"):
                backward_calls[phase] = out["backward_calls"]
            energy_recs += out.pop("energy")
            rec.update(out)
        elif phase == "roofline":
            rec.update(phase_roofline(torch, smi))
        elif phase == "examples":
            rec.update(phase_examples(torch))
        rec["wall_s"] = time.perf_counter() - t0
        emit(rec)

    emit({"phases": phases, "wall_s": time.perf_counter() - t_start})
    if energy_recs:
        emit({"energy": energy_recs})
    print(smi, flush=True)
    if kernels_out is not None:
        emit({"kernels": kernel_summary(kernels_out, path_launches,
                                        backward_calls)})
    if phases != list(PHASES):
        emit({"partial": phases})      # a subset proves nothing end to end
        return 0
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
