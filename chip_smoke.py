#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of DRIFT on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # every phase, as the check runs it
    python3 chip_smoke.py --phases device,build,kernels --reps 3
    python3 chip_smoke.py --phases device,build,kernels,ar
    python3 chip_smoke.py --phases device,build,offload
    python3 chip_smoke.py --phases device,build,sched

Phases, each printing one JSON line with its wall time:

1. device   -- the card (nvidia-smi name and power limit), torch and CUDA.
2. build    -- compile the four CUDA kernels from ``src/repro_torch/
               kernels/csrc`` (one nvcc each, in parallel); registers and
               spill bytes of every compiled kernel (``ptxas -v``).
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
               (B, S, H, D) inputs in place), and the composites
               ``stat_abft_matmul`` and ``drift_gemm`` at one DiT GEMM
               shape (bit-equal).
4. reference -- the SMOKE DiT and the SMOKE olmo-1b served on the card
               (kernels) and on the CPU (plain versions) with the same
               params, inputs and flip masks: latents, tokens and counts
               must agree. The DiT runs twice: plain drift, and with
               TaylorSeer and ``int8-body4`` for 7 steps, whose corrected
               counts, evaluations (3) and modeled joules must be equal.
5. serve    -- ``repro_torch.launch.serve.main`` drives a full-width
               DiT-XL/2-512 engine (28 layers, random seeded weights): 2
               requests in drift/undervolt, then the same seeds in faulty
               mode. The launch counters are zeroed just before and read
               just after; the counts must be exact. Then, counted on
               their own the same way, the same seeds in drift/undervolt
               with ``--taylorseer --precision int8-body4``: it and its
               TaylorSeer clean reference compute steps 0, 3, 6 and 9.
6. offload  -- the same CLI serves the full-width DiT's 2 requests at
               rollback interval 2 in turns on fresh engines with one base
               seed: plain, ``--offload --stream 2``, the same again,
               plain; each engine serves them 4 times, a cold batch (drift
               and its clean reference; the pinned host sets allocated)
               and 3 steady ones (drift alone, everything reused). Every
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
               time per decode step and a profiled request.

Every DiT and olmo-1b result carries the perfmodel's attribution; each
must bill a ledger whose ``ledger_total`` equals its ``energy_j`` bit for
bit, drift at undervolt must bill less than its baseline, the TaylorSeer
run less than plain drift, an offloaded result what its plain twin
bills (its modeled latency plus the planner's modeled stall), and
stat_abft's replays must bill as ``compute_replay``. These joules and seconds are the modeled paper
accelerator's, not this card's; the ``energy`` line says so.

Then it prints the ``energy`` line, the card's name and power limit, the
``kernels`` summary line and, last, ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside a checkout of the repository, it
raises and exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("device", "build", "kernels", "reference", "serve", "offload",
          "sched", "ar")

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate, int8 and bf16
# tensor-core rates, float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12
L2_BYTES = 50 * 2 ** 20

ARCH = "dit-xl-512"
BUCKET = 2
SERVE_STEPS = 10
THRESHOLD = 1 << 10
AR_ARCH = "olmo-1b"
AR_STEPS = 16
AR_WINDOW = 4
TS_ARGS = ["--taylorseer", "--precision", "int8-body4"]
TS_KNOBS = dict(taylorseer=True, precision="int8-body4")
TS_STEPS_SMOKE, TS_EVALS_SMOKE = 7, 3       # computes steps 0, 3, 6
OFFLOAD_INTERVAL = 2        # refresh interval and stream window
STEADY_BATCHES = 3          # batches after an offload engine's first
TIMERS = set()          # which timer produced the kernel times
ENERGY_SOURCE = "perfmodel: modeled paper accelerator, not this card"


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


# ---------------------------------------------------------------- phases
def phase_kernels(torch, reps: int):
    from repro_torch.configs import get_config
    from repro_torch.core import fault
    from repro_torch.core.abft import _exceeds
    from repro_torch.kernels import abft_matmul as ak
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import rollback_correct as rk

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(ARCH)
    g = torch.Generator(device=dev)
    g.manual_seed(20261016)
    src = fault.PhiloxFlipSource(base_seed=7, batch_index=0, device=dev)
    abft_rows, rb_rows = [], []
    for i, (name, m, k, n, per_eval, valid) in enumerate(
            path_gemms(cfg, BUCKET)):
        aq = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                           dtype=torch.int8)
        bq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                           dtype=torch.int8)
        flips = src(fault.FaultSite(0, i, name), (m, n), 3e-3)
        flips[m // 2, n // 3] = -2 ** 31            # one bit-31 flip
        got = ak.abft_matmul(aq, bq, flips)
        want = ak.abft_matmul_plain(aq, bq, flips)
        torch.cuda.synchronize()
        for label, a, b in zip(("c", "act_row", "exp_row", "act_col",
                                "exp_col"), got, want):
            if not torch.equal(a, b):
                bad = int((a != b).sum())
                raise AssertionError(f"abft_matmul {name} ({m}x{k}x{n}): "
                                     f"{label} differs in {bad} elements")
        mt, nt = m // 32, n // 32
        bytes_ = m * k + k * n + 4 * m * n + 4 * m * n + 8 * m * nt \
            + 8 * mt * n
        ops = 2 * m * n * k + 2 * m * k * nt + 2 * mt * k * n
        t_b, t_o = bytes_ / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
        ring = ring_of((aq, bq, flips), bytes_)
        try:
            int_mm = device_ms(torch._int_mm, [r[:2] for r in ring], reps)
        except RuntimeError:                       # shape it does not take
            int_mm = None
        row = dict(name=name, m=m, k=k, n=n, per_eval=per_eval,
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
        row.update(tops=2 * m * n * k / (row["ms"] * 1e-3) / 1e12,
                   int_mm_ratio=row["ms"] / int_mm if int_mm else None)
        abft_rows.append(row)
        del ring

        rd = got[1] - got[2]
        cd = got[3] - got[4]
        c = got[0].float() * 1e-4
        ckpt = torch.randn((m, n), generator=g, device=dev)
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
        # Per element one f32 read (ckpt where masked, else c) and one f32
        # write; the row and column differences; the per-tile count.
        rbytes = 8 * m * n + 4 * m * nt + 4 * mt * n + 4 * mt * nt
        ring = ring_of((c, ckpt, rd, cd), rbytes)

        def rb(c_, ck_, rd_, cd_, valid=valid):
            return rk.rollback_correct(c_, ck_, rd_, cd_, THRESHOLD,
                                       valid=valid)

        def rb_plain(c_, ck_, rd_, cd_, valid=valid):
            return rk.rollback_correct_plain(c_, ck_, rd_, cd_, THRESHOLD,
                                             valid=valid)
        rb_rows.append(dict(
            name=name, m=m, n=n, per_eval=per_eval, max_abs_err=err,
            ring=len(ring),
            ms=device_ms(rb, ring, reps, "rollback_correct"),
            wall_ms=time_ms(rb, ring, reps),
            plain_ms=device_ms(rb_plain, ring, reps),
            bound_ms=1e3 * rbytes / HBM_BYTES_PER_S, bound_by="bytes",
            masked_elems=int(a[1].sum())))
        del ring
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
        flops = 4 * b * h * s * s * d
        bytes_ = 4 * q.numel() * q.element_size()
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
    from repro_torch.core import fault
    from repro_torch.kernels import fault_inject as fik
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops
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
        fi_rows.append(dict(
            name=name, shape=list(shape), dtype=str(dtype).split(".")[-1],
            per_step=per_step, max_abs_err=err, ring=len(ring),
            ms=device_ms(fik.fault_inject, ring, fr, "fault_inject"),
            wall_ms=time_ms(fik.fault_inject, ring, fr),
            plain_ms=device_ms(fik.fault_inject_plain, ring, fr),
            library_ms=device_ms(xor, ring, fr),
            bound_ms=1e3 * 12 * n / HBM_BYTES_PER_S, bound_by="bytes"))
        fi_rows[-1]["library_ratio"] = fi_rows[-1]["ms"] / \
            fi_rows[-1]["library_ms"]
        del ring
    emit({"phase": "kernels", "kernel": "fault_inject", "bit_equal": True,
          "shapes": fi_rows,
          "note": "library_ms is torch.bitwise_xor on the int32 views; the "
                  "plain version is the same xor; library_ratio is "
                  "ms / library_ms"})

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
        pairs = s * (s + 1) // 2                  # causal (query, key)
        flops = 4 * b * h * d * pairs
        t_o = flops / flops_per_s(dtype)
        t_b = 4 * b * s * h * d * q.element_size() / HBM_BYTES_PER_S
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

    # The composites, at the DiT's attention GEMM shape.
    m, kk, n = 2048, 1152, 1152
    aq = torch.randint(-127, 128, (m, kk), generator=g, device=dev,
                       dtype=torch.int8)
    bq = torch.randint(-127, 128, (kk, n), generator=g, device=dev,
                       dtype=torch.int8)
    flips = src(fault.FaultSite(2, 0, "stat"), (m, n), 3e-3)
    flips[7, 9] = -2 ** 31
    bn = 128
    err = 0.0
    for thr in (0, THRESHOLD):
        got = sk.stat_abft_matmul(aq, bq, flips, thr, bm=bn, bn=bn)
        want = sk.stat_abft_matmul_plain(aq, bq, flips, thr, bm=bn, bn=bn)
        torch.cuda.synchronize()
        err = max(err, _check_equal(f"stat_abft_matmul threshold {thr}",
                                    got, want))
    sbytes = m * kk + kk * n + 8 * m * n + m * (n // bn)
    sops = 2 * m * n * kk + 2 * m * kk * (n // bn)
    ring = ring_of((aq, bq, flips), sbytes)

    def stat(a, b_, f):
        return sk.stat_abft_matmul(a, b_, f, THRESHOLD, bm=bn, bn=bn)

    def stat_plain(a, b_, f):
        return sk.stat_abft_matmul_plain(a, b_, f, THRESHOLD, bm=bn, bn=bn)
    t_b, t_o = sbytes / HBM_BYTES_PER_S, sops / INT8_OPS_PER_S
    stat_row = dict(shape=[m, kk, n], bn=bn, threshold_mag=THRESHOLD,
                    flagged=int(got[1].sum()), max_abs_err=err,
                    ring=len(ring), ms=device_ms(stat, ring, reps),
                    kernel_ms=device_ms(stat, ring, reps, "abft_matmul"),
                    wall_ms=time_ms(stat, ring, reps),
                    plain_ms=device_ms(stat_plain, ring, max(1, reps // 4)),
                    bound_ms=1e3 * max(t_b, t_o),
                    bound_by="bytes" if t_b >= t_o else "operations",
                    library_ms=None)
    del ring
    emit({"phase": "kernels", "kernel": "stat_abft_matmul",
          "bit_equal": True, **stat_row})

    x = torch.randn((m, kk), generator=g, device=dev)
    w = torch.randn((kk, n), generator=g, device=dev) / kk ** 0.5
    ckpt = torch.randn((m, n), generator=g, device=dev)
    dflips = src(fault.FaultSite(2, 1, "drift"), ops.padded_shape(m, n),
                 3e-3)
    got = ops.drift_gemm(x, w, ckpt, dflips)
    want = ops.drift_gemm_plain(x, w, ckpt, dflips)
    torch.cuda.synchronize()
    err = _check_equal("drift_gemm", got, want)
    nt, mt = n // 32, m // 32
    dbytes = 4 * m * kk + 4 * kk * n + 12 * m * n + 4 * m * nt + 4 * mt * n
    dops = 2 * m * n * kk + 2 * m * kk * nt + 2 * mt * kk * n
    t_b, t_o = dbytes / HBM_BYTES_PER_S, dops / INT8_OPS_PER_S
    ring = ring_of((x, w, ckpt, dflips), dbytes)
    drift_row = dict(shape=[m, kk, n], flagged_tiles=int(got.n_flagged_tiles),
                     max_abs_err=err, ring=len(ring),
                     ms=device_ms(ops.drift_gemm, ring, reps),
                     kernel_ms=device_ms(ops.drift_gemm, ring, reps,
                                         ("abft_matmul", "rollback_correct")),
                     wall_ms=time_ms(ops.drift_gemm, ring, reps),
                     plain_ms=device_ms(ops.drift_gemm_plain, ring,
                                        max(1, reps // 4)),
                     bound_ms=1e3 * max(t_b, t_o),
                     bound_by="bytes" if t_b >= t_o else "operations",
                     library_ms=None)
    del ring
    emit({"phase": "kernels", "kernel": "drift_gemm", "bit_equal": True,
          **drift_row,
          "note": "ms is every kernel of the composite (quantize, pads, "
                  "dequantize included); kernel_ms its two CUDA kernels"})
    return fi_rows, mha_rows, stat_row, drift_row


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


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


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
                lm_tokens=[list(r.tokens) for r in lm_out["cpu"]])


def phase_serve(torch):
    from repro_torch.configs import get_config
    from repro_torch.kernels import abft_matmul as ak
    from repro_torch.kernels import fault_inject as fik
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import rollback_correct as rk
    from repro_torch.launch import serve
    from repro_torch.models import dit
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
    ak.launches = rk.launches = fk.launches = fik.launches = 0
    t0 = time.perf_counter()
    drift = serve.main(argv + ["--mode", "drift"], engine=eng)
    torch.cuda.synchronize()
    t_drift = time.perf_counter() - t0
    t0 = time.perf_counter()
    faulty = serve.main(argv + ["--mode", "faulty"], engine=eng)
    torch.cuda.synchronize()
    t_faulty = time.perf_counter() - t0
    launches = {"abft_matmul": ak.launches, "rollback_correct": rk.launches,
                "flash_attention": fk.launches, "fault_inject": fik.launches}
    peak = torch.cuda.max_memory_allocated()

    gemms = sum(p[4] for p in path_gemms(cfg, BUCKET))        # 172
    evals = SERVE_STEPS
    want = {"abft_matmul": gemms * evals * 3,
            "rollback_correct": gemms * evals * 2,
            "flash_attention": cfg.n_layers * evals * 3, "fault_inject": 0}
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
    ak.launches = rk.launches = fk.launches = fik.launches = 0
    t0 = time.perf_counter()
    ts_res = serve.main(argv + ["--mode", "drift"] + TS_ARGS, engine=eng)
    torch.cuda.synchronize()
    t_ts = time.perf_counter() - t0
    ts_launches = {"abft_matmul": ak.launches,
                   "rollback_correct": rk.launches,
                   "flash_attention": fk.launches,
                   "fault_inject": fik.launches}
    peak = max(peak, torch.cuda.max_memory_allocated())
    ts_evals = len(range(0, SERVE_STEPS, 3))                   # 4
    ts_want = {"abft_matmul": gemms * ts_evals * 2,
               "rollback_correct": gemms * ts_evals * 2,
               "flash_attention": cfg.n_layers * ts_evals * 2,
               "fault_inject": 0}
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
                setup_s=setup_s, drift_run_s=t_drift, faulty_run_s=t_faulty,
                taylorseer_run_s=t_ts, peak_mem_bytes=peak,
                launches=launches, taylorseer_launches=ts_launches,
                requests=reqs, builds=eng.cache.builds,
                clean_samples=eng.stats.clean_samples_computed,
                energy=energy,
                breakdown=_profile_request(torch, eng, argv))


def _profile_request(torch, eng, argv):
    """Device time by kernel over one more drift request of 3 steps (after
    the counted run): where a served request's time goes on the card."""
    from torch.profiler import ProfilerActivity, profile
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
    return dict(what="1 drift request, 3 steps, plus its clean reference "
                     "(6 evaluations)", wall_s=wall, device_busy_s=busy,
                device_busy_share=busy / wall, flash_attention_s=fa,
                flash_attention_share_of_busy=fa / busy if busy else None,
                abft_matmul_s=ab,
                abft_matmul_share_of_busy=ab / busy if busy else None,
                n_kernels=sum(r[2] for r in rows),
                top=[dict(kernel=k[:80], device_s=us / 1e6, calls=c)
                     for us, k, c in rows[:12]])


def _launch_counts(ak, rk, fk, fik):
    return {"abft_matmul": ak.launches, "rollback_correct": rk.launches,
            "flash_attention": fk.launches, "fault_inject": fik.launches}


def phase_offload(torch, smi):
    """The full-width DiT with checkpoint offload and streamed previews
    through the CLI, against the same requests without offload, and the
    SMOKE DiT with offload on the card against the CPU."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import abft_matmul as ak
    from repro_torch.kernels import fault_inject as fik
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import rollback_correct as rk
    from repro_torch.launch import serve
    from repro_torch.models import dit
    from repro_torch.serving import DriftServeEngine, OffloadConfig
    from repro_torch.serving.offload.layout import tree_leaves

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
        return {"abft_matmul": gemms * evals,
                "rollback_correct": gemms * evals,
                "flash_attention": cfg.n_layers * evals, "fault_inject": 0}
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
            ak.launches = rk.launches = fk.launches = fik.launches = 0
            t0 = time.perf_counter()
            results = serve.main(argv + extra, engine=eng)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            b = dict(batch=batch, wall_s=wall, start_bytes=start,
                     peak_over_start_bytes=(torch.cuda.max_memory_allocated()
                                            - start),
                     launches=_launch_counts(ak, rk, fk, fik),
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


SCHED_TURNS = ("on", "off", "on", "off")   # telemetry and recorder
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
    from repro_torch.kernels import abft_matmul as ak
    from repro_torch.kernels import fault_inject as fik
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import rollback_correct as rk
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
        return {"abft_matmul": gemms * evals,
                "rollback_correct": gemms * evals,
                "flash_attention": cfg.n_layers * evals, "fault_inject": 0}

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
                ak.launches = rk.launches = fk.launches = fik.launches = 0
                t0 = time.perf_counter()
                results = sched.run()
                torch.cuda.synchronize()
                rec["run_wall_s"] = time.perf_counter() - t0
            launches = _launch_counts(ak, rk, fk, fik)
            evals = sum({r.batch_index: 2 * r.n_model_evals
                         for r in results}.values())
            if launches != want(evals):
                raise AssertionError(f"{label} run launches {launches} != "
                                     f"{want(evals)} ({evals} evaluations)")
            # the background pair again, drained through /events on the
            # server's thread (its clean samples cached: drift alone)
            for f in reqs[:2]:
                sched.submit(**f)
            ak.launches = rk.launches = fk.launches = fik.launches = 0
            rec["events_wall_s"], body = _get(server.url
                                              + "/events?interval=2")
            torch.cuda.synchronize()
            frames = _parse_sse(body)
            sse = [d for k, d in frames if k == "result"]
            ev_launches = _launch_counts(ak, rk, fk, fik)
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
    ak.launches = rk.launches = fk.launches = fik.launches = 0
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
    auto_launches = _launch_counts(ak, rk, fk, fik)
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
    from repro_torch.configs import get_config
    from repro_torch.kernels import abft_matmul as ak
    from repro_torch.kernels import fault_inject as fik
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import rollback_correct as rk
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.serving import DriftServeEngine

    dev = torch.device("cuda")
    cfg = get_config(AR_ARCH)
    t0 = time.perf_counter()
    eng = DriftServeEngine(arch=AR_ARCH, smoke=False, bucket=BUCKET,
                           device="cuda")
    params = transformer.init_params(cfg, 21, dev)
    eng.set_params(AR_ARCH, False, params)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    argv = ["--arch", AR_ARCH, "--no-smoke", "--batch", str(BUCKET),
            "--steps", str(AR_STEPS), "--requests", "2",
            "--rollback-interval", str(AR_WINDOW), "--op", "undervolt",
            "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    ak.launches = rk.launches = fk.launches = fik.launches = 0
    t0 = time.perf_counter()
    stat = serve.main(argv + ["--mode", "stat_abft"], engine=eng)
    torch.cuda.synchronize()
    t_stat = time.perf_counter() - t0
    t0 = time.perf_counter()
    faulty = serve.main(argv + ["--mode", "faulty"], engine=eng)
    torch.cuda.synchronize()
    t_faulty = time.perf_counter() - t0
    launches = {"fault_inject": fik.launches, "flash_attention": fk.launches,
                "abft_matmul": ak.launches, "rollback_correct": rk.launches}
    peak = torch.cuda.max_memory_allocated()

    # Layer 0 (the first-block class) and steps below nominal_steps run at
    # BER 0 and launch nothing; stat_abft's primary pass and the faulty
    # pass are faulted, replays and the clean reference are not.
    faulted_steps = sum(1 for i in range(1, AR_STEPS)
                        if i >= eng.nominal_steps)
    per_step = (cfg.n_layers - 1) * 7
    prefills = 3                 # stat_abft, its clean reference, faulty
    want = {"fault_inject": 2 * faulted_steps * per_step,
            "flash_attention": prefills * cfg.n_layers,
            "abft_matmul": 0, "rollback_correct": 0}
    if launches != want:
        raise AssertionError(f"AR launch counts {launches} != {want}")
    reqs = []
    for mode, results in (("stat_abft", stat), ("faulty", faulty)):
        for r in results:
            if len(r.tokens) != AR_STEPS or r.latents is not None:
                raise AssertionError(f"{mode} request {r.request_id}: "
                                     f"{len(r.tokens)} tokens")
            if mode == "stat_abft" and not (
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
    energy = (check_energy("ar", "stat_abft", stat)
              + check_energy("ar", "faulty", faulty))
    for r in stat:
        if not r.energy_breakdown["compute_replay"] > 0:
            raise AssertionError(f"stat_abft request {r.request_id}: "
                                 "replays billed no compute_replay")
    return dict(arch=AR_ARCH, layers=cfg.n_layers, d_model=cfg.d_model,
                d_ff=cfg.d_ff, vocab=cfg.vocab, bucket=BUCKET,
                steps=AR_STEPS, window=AR_WINDOW, setup_s=setup_s,
                stat_abft_run_s=t_stat, faulty_run_s=t_faulty,
                peak_mem_bytes=peak, launches=launches, requests=reqs,
                energy=energy,
                clean_tokens=clean.tolist(), builds=eng.cache.builds,
                step_ms=_ar_step_ms(torch, eng, cfg, params),
                breakdown=_profile_ar(torch, eng, argv))


def _ar_step_ms(torch, eng, cfg, params):
    """Per mode: host wall ms per decode step, each ended by a
    synchronize, over the faulted steps of one pass (a decoder built the
    way the engine builds it), and the device kernels one more faulted
    step runs, counted by the profiler."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import dvfs, fault
    from repro_torch.models import transformer
    from repro_torch.serving import ar
    weights = transformer.prepare(cfg, params)
    tokens = ar.prompt_tokens(cfg, [0, 1], eng.device)
    schedule = dvfs.fine_grained_schedule(AR_STEPS + 1, dvfs.UNDERVOLT,
                                          nominal_steps=eng.nominal_steps)
    out = {}
    for mode in ("clean", "faulty", "stat_abft"):
        fns = ar.make_decoder(cfg, ar.DecodeConfig(AR_STEPS + 1, AR_WINDOW,
                                                   mode,
                                                   eng.monitor_target_ber),
                              schedule=schedule)
        src = fault.PhiloxFlipSource(3, 0, eng.device)
        monitor = dvfs.ber_monitor_init(eng.device)
        tok, cache = fns.prefill(weights, tokens)
        torch.cuda.synchronize()
        times = []
        for i in range(1, AR_STEPS):
            t0 = time.perf_counter()
            tok, cache, monitor, _, _ = fns.step(weights, cache, tok, i,
                                                 monitor, src, 1.0)
            torch.cuda.synchronize()
            if i >= eng.nominal_steps:
                times.append(1e3 * (time.perf_counter() - t0))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fns.step(weights, cache, tok, AR_STEPS, monitor, src, 1.0)
            torch.cuda.synchronize()
        kernels = sum(ev.count for ev in prof.key_averages()
                      if getattr(ev, "self_device_time_total",
                                 getattr(ev, "self_cuda_time_total", 0)) > 0)
        out[mode] = dict(ms=sum(times) / len(times), kernels=kernels)
    return out


def _profile_ar(torch, eng, argv):
    """Device time by kernel over one more stat_abft request (its
    primary pass, replays and clean reference)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    argv = argv + ["--mode", "stat_abft", "--requests", "1", "--seed", "100"]
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
    fi = sum(r[0] for r in rows if "fault_inject" in r[1]) / 1e6
    return dict(what="1 stat_abft request at bucket 2, 16 tokens: prefill, "
                     "15 faulted steps, 15 replayed, plus its clean "
                     "reference", wall_s=wall, device_busy_s=busy,
                device_busy_share=busy / wall, fault_inject_s=fi,
                fault_inject_share_of_busy=fi / busy if busy else None,
                n_kernels=sum(r[2] for r in rows),
                top=[dict(kernel=k[:80], device_s=us / 1e6, calls=c)
                     for us, k, c in rows[:12]])


def kernel_summary(kernels_out, path_launches):
    """One row per TPU kernel of the repo. ``launches`` sums the counts
    of the paths that ran (``launches_by_path``). ``mha_flash`` launches
    nothing of its own: its row carries the ``flash_attention`` launches
    of the ar path, all made through it. The composites keep no count
    (``launches`` null): each call's launches are counted under the
    kernels it calls."""
    (abft_rows, rb_rows, fl_rows, fi_rows, mha_rows, stat_row,
     drift_row) = kernels_out

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
        return out

    def composite(name, source, replaces, stats, per, kernels):
        return row(name, source, replaces, stats, stats["bound_by"], per,
                   None, paths=(), note="composite; launches counted under "
                   + "/".join(kernels))

    def mix(rows, per_key):
        live = [r for r in rows if r[per_key]]
        out = {k: sum(r[k] * r[per_key] for r in live)
               / sum(r[per_key] for r in live)
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")
               if k in live[0]}
        out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
        return out

    csrc = "src/repro_torch/kernels/csrc/"
    fl, mha = fl_rows["bfloat16"], mha_rows["bfloat16"]
    fi = mix(fi_rows, "per_step")
    return [
        row("abft_matmul", csrc + "abft_matmul.cu",
            "src/repro/kernels/abft_matmul.py:79",
            mix(abft_rows, "per_eval"), "bytes",
            "mean per launch over one DiT-XL evaluation's 172 GEMMs at "
            "bucket 2", None),
        row("rollback_correct", csrc + "rollback_correct.cu",
            "src/repro/kernels/rollback_correct.py:34",
            mix(rb_rows, "per_eval"), "bytes",
            "mean per launch over one DiT-XL evaluation's 172 GEMMs at "
            "bucket 2", None),
        row("flash_attention", csrc + "flash_attention.cu",
            "src/repro/kernels/flash_attention.py:71", fl, fl["bound_by"],
            "one launch through mha_flash on the DiT's (2, 1024, 16, 72) "
            "bf16 projections in place (token stride 1152)",
            fl["library_ms"]),
        row("mha_flash", "src/repro_torch/kernels/flash_attention.py",
            "src/repro/kernels/flash_attention.py:105", mha,
            mha["bound_by"], "one call, (2, 8, 16, 128) bf16 causal (the "
            "olmo-1b prefill's), one kernel on the tensors in place",
            mha["library_ms"],
            counted="flash_attention", paths=("ar",),
            note="the flash_attention launches of the ar path, each made "
                 "through mha_flash; not a kernel of its own"),
        row("fault_inject", csrc + "fault_inject.cu",
            "src/repro/kernels/fault_inject.py:24", fi, "bytes",
            "mean per launch over one decode step's 7 GEMM outputs, "
            "(2, 1, 2048) x5 and (2, 1, 8192) x2 f32",
            fi["library_ms"]),
        composite("drift_gemm", "src/repro_torch/kernels/ops.py",
                  "src/repro/kernels/ops.py:44", drift_row,
                  "one call, 2048x1152x1152 f32; on no serving path",
                  ("abft_matmul", "rollback_correct")),
        composite("stat_abft_matmul", "src/repro_torch/kernels/stat_abft.py",
                  "src/repro/kernels/stat_abft.py:103", stat_row,
                  "one call, 2048x1152x1152 int8, 128-wide row tiles; on "
                  "no serving path", ("abft_matmul",)),
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

    smi = nvidia_smi()
    kernels_out = None
    path_launches = {}
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
        elif phase == "kernels":
            kernels_out = (phase_kernels(torch, args.reps)
                           + phase_kernels_ar(torch, args.reps))
        elif phase == "reference":
            rec.update(phase_reference(torch))
        elif phase in ("serve", "offload", "sched", "ar"):
            out = (phase_serve(torch) if phase == "serve"
                   else phase_offload(torch, smi) if phase == "offload"
                   else phase_sched(torch, smi) if phase == "sched"
                   else phase_ar(torch))
            path_launches[phase] = out["launches"]
            if phase == "serve":
                path_launches["serve+taylorseer"] = \
                    out["taylorseer_launches"]
            if phase == "offload":
                path_launches["offload+steady"] = out["steady_launches"]
            if phase == "sched":
                path_launches["sched+auto"] = out["auto_launches"]
            energy_recs += out.pop("energy")
            rec.update(out)
        rec["wall_s"] = time.perf_counter() - t0
        emit(rec)

    if energy_recs:
        emit({"energy": energy_recs})
    print(smi, flush=True)
    if kernels_out is not None:
        emit({"kernels": kernel_summary(kernels_out, path_launches)})
    if phases != list(PHASES):
        emit({"partial": phases})      # a subset proves nothing end to end
        return 0
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
