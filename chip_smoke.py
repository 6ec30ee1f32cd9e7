#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of DRIFT on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # every phase, as the check runs it
    python3 chip_smoke.py --phases device,build,kernels --reps 3

Phases, each printing one JSON line with its wall time:

1. device   -- the card (nvidia-smi name and power limit), torch and CUDA.
2. build    -- compile the three CUDA kernels from ``src/repro_torch/
               kernels/csrc`` (one nvcc each, in parallel).
3. kernels  -- each kernel against its plain PyTorch version on the card,
               at the shapes the serving path gives it: ``abft_matmul`` at
               the seven padded GEMM shapes of DiT-XL/2-512 at bucket 2
               (flips at BER 3e-3 plus one bit-31 flip; all five outputs
               bit-equal), ``rollback_correct`` (union and cross, bit-equal)
               and ``flash_attention`` ((32, 1024, 72), bf16 and f32, within
               the stated tolerance). Device times from ``torch.profiler``
               (the kernel, its plain version and a PyTorch library call
               where one exists), the wall time per call with CUDA events
               (``wall_ms``, host launch overhead included), and the least
               time the card could take (``bound_ms``). Timed calls cycle
               through copies of their inputs that together exceed twice
               the L2, so each call reads its inputs cold from HBM.
4. reference -- the SMOKE DiT served on the card (kernels) and on the CPU
               (plain versions) with the same params, latents and flip
               masks: latents and counts must agree.
5. serve    -- ``repro_torch.launch.serve.main`` drives a full-width
               DiT-XL/2-512 engine (28 layers, random seeded weights): 2
               requests in drift/undervolt, then the same seeds in faulty
               mode. The launch counters are zeroed just before and read
               just after; the counts must be exact.

Then it prints the card's name and power limit, the ``kernels`` summary
line and, last, ``{"ok": true, "device": {...}}``. Without a CUDA device,
or outside a checkout of the repository, it raises and exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("device", "build", "kernels", "reference", "serve")

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate, int8 tensor-core
# rate, float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12
L2_BYTES = 50 * 2 ** 20

ARCH = "dit-xl-512"
BUCKET = 2
SERVE_STEPS = 10
THRESHOLD = 1 << 10
TIMERS = set()          # which timer produced the kernel times


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


def device_ms(fn, ring, reps: int, name: str = ""):
    """Device time per call of ``fn`` from ``torch.profiler``: the summed
    time of the GPU kernels whose name contains ``name`` (all kernels when
    empty) over ``reps`` calls cycling through ``ring``, after one warm-up
    pass over it. Unlike ``time_ms`` it excludes the host's launch
    overhead. Where the profiler sees no device time it falls back to
    ``time_ms`` and notes that in ``TIMERS``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    _cycle(fn, ring, len(ring))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _cycle(fn, ring, reps)
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        if name in ev.key:
            total_us += getattr(ev, "self_device_time_total",
                                getattr(ev, "self_cuda_time_total", 0.0))
    if total_us > 0:
        TIMERS.add("torch.profiler")
        return total_us / 1e3 / reps
    TIMERS.add("cuda events (profiler saw no device time)")
    return time_ms(fn, ring, reps)


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


def mix_mean(rows, key):
    """Per-launch mean of ``key`` over one evaluation's launch mix."""
    n = sum(r["per_eval"] for r in rows)
    return sum(r[key] * r["per_eval"] for r in rows) / n


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
                  "yardstick, not the same function"})
    emit({"phase": "kernels", "kernel": "rollback_correct",
          "bit_equal": True, "policies": ["union", "cross"],
          "shapes": rb_rows})

    import torch.nn.functional as F
    bh, s, d = BUCKET * cfg.n_heads, cfg.tokens, cfg.hd
    fl_rows = {}
    for dtype, tol in ((torch.bfloat16, 3e-2), (torch.float32, 2e-5)):
        q, k, v = (torch.randn((bh, s, d), generator=g, device=dev
                               ).to(dtype) for _ in range(3))
        got = fk.flash_attention(q, k, v)
        want = fk.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = max_abs_err([got], [want])
        if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
            raise AssertionError(f"flash_attention {dtype}: max abs err "
                                 f"{err} beyond {tol}")
        flops = 4 * bh * s * s * d
        bytes_ = 4 * bh * s * d * q.element_size()
        t_o, t_b = flops / F32_FLOPS_PER_S, bytes_ / HBM_BYTES_PER_S
        ring = ring_of((q, k, v), bytes_)
        lib_ring = [tuple(x.float().reshape(BUCKET, cfg.n_heads, s, d)
                          for x in r) for r in ring]
        fl_rows[str(dtype).split(".")[-1]] = dict(
            shape=[bh, s, d], tol=tol, max_abs_err=err, ring=len(ring),
            ms=device_ms(fk.flash_attention, ring, reps, "flash_attention"),
            wall_ms=time_ms(fk.flash_attention, ring, reps),
            plain_ms=device_ms(fk.flash_attention_plain, ring, reps),
            library_ms=device_ms(F.scaled_dot_product_attention, lib_ring,
                                 reps),
            bound_ms=1e3 * max(t_o, t_b),
            bound_by="operations" if t_o >= t_b else "bytes")
        del ring, lib_ring
    emit({"phase": "kernels", "timers": sorted(TIMERS)})
    emit({"phase": "kernels", "kernel": "flash_attention",
          "per_eval": cfg.n_layers, "dtypes": fl_rows,
          "note": "library_ms is F.scaled_dot_product_attention on the same "
                  "inputs in f32; tolerance vs the plain f32 full_attention: "
                  "2e-5 f32 (summation order), 3e-2 bf16 (bf16 output)"})
    return abft_rows, rb_rows, fl_rows


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


def phase_reference(torch):
    """SMOKE DiT on the card vs on the CPU: same params, latents and masks
    (drawn on the CPU for both), 3 drift steps at undervolt."""
    from repro_torch.configs import get_config
    from repro_torch.core import fault
    from repro_torch.models import dit
    from repro_torch.serving import DriftServeEngine

    cfg = get_config(ARCH, smoke=True)
    cpu_params = _perturb(torch, dit.init_params(cfg, 3), cfg, 4, "cpu")
    out = {}
    for device in ("cuda", "cpu"):
        eng = DriftServeEngine(arch=ARCH, smoke=True, bucket=2, base_seed=5,
                               device=device,
                               flip_source_factory=fault.philox_source_factory
                               (5, "cpu"))
        eng.set_params(ARCH, True, _to(cpu_params, device))
        lat = torch.randn((2, 8, 8, 4),
                          generator=torch.Generator().manual_seed(6))
        eng.servable.batch_inputs = lambda c, seeds, d=device: (
            lat.to(d), torch.tensor([1, 2], device=d))
        for s in (0, 1):
            eng.submit(steps=3, mode="drift", op="undervolt", seed=s)
        out[device] = eng.run()
    err = max(float((a.latents.cpu() - b.latents).abs().max())
              for a, b in zip(out["cuda"], out["cpu"]))
    ca = out["cuda"][0].batch_corrected_elems
    cb = out["cpu"][0].batch_corrected_elems
    # 1e-3 on latents in [-1, 1]: f32 on both sides, sums in other orders,
    # and an int8 rounding may tip at a boundary; the masks are the same.
    if not (err < 1e-3 and abs(ca - cb) <= 0.01 * max(cb, 1) and cb > 0):
        raise AssertionError(f"SMOKE card vs CPU: latents max err {err}, "
                             f"corrected {ca} vs {cb}")
    return dict(latents_max_abs_err=err, corrected_card=ca,
                corrected_cpu=cb)


def phase_serve(torch):
    from repro_torch.configs import get_config
    from repro_torch.kernels import abft_matmul as ak
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
    ak.launches = rk.launches = fk.launches = 0
    t0 = time.perf_counter()
    drift = serve.main(argv + ["--mode", "drift"], engine=eng)
    torch.cuda.synchronize()
    t_drift = time.perf_counter() - t0
    t0 = time.perf_counter()
    faulty = serve.main(argv + ["--mode", "faulty"], engine=eng)
    torch.cuda.synchronize()
    t_faulty = time.perf_counter() - t0
    launches = {"abft_matmul": ak.launches, "rollback_correct": rk.launches,
                "flash_attention": fk.launches}
    peak = torch.cuda.max_memory_allocated()

    gemms = sum(p[4] for p in path_gemms(cfg, BUCKET))        # 172
    evals = SERVE_STEPS
    want = {"abft_matmul": gemms * evals * 3,
            "rollback_correct": gemms * evals * 2,
            "flash_attention": cfg.n_layers * evals * 3}
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
    (clean,) = eng._clean_samples.values()
    if not bool(torch.isfinite(clean).all()):
        raise AssertionError("non-finite clean reference latents")
    return dict(arch=ARCH, layers=cfg.n_layers, d_model=cfg.d_model,
                tokens=cfg.tokens, bucket=BUCKET, steps=SERVE_STEPS,
                setup_s=setup_s, drift_run_s=t_drift, faulty_run_s=t_faulty,
                peak_mem_bytes=peak, launches=launches, requests=reqs,
                builds=eng.cache.builds,
                clean_samples=eng.stats.clean_samples_computed,
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
    return dict(what="1 drift request, 3 steps, plus its clean reference "
                     "(6 evaluations)", wall_s=wall, device_busy_s=busy,
                device_busy_share=busy / wall,
                top=[dict(kernel=k[:80], device_s=us / 1e6, calls=c)
                     for us, k, c in rows[:12]])


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
    for phase in ("device", "build", "kernels", "reference", "serve"):
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
            rec["ptxas"] = {n: [ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "spill" in ln][:8]
                            for n, log in logs.items()}
        elif phase == "kernels":
            kernels_out = phase_kernels(torch, args.reps)
        elif phase == "reference":
            rec.update(phase_reference(torch))
        elif phase == "serve":
            serve_out = phase_serve(torch)
            rec.update(serve_out)
        rec["wall_s"] = time.perf_counter() - t0
        emit(rec)

    if kernels_out is not None and "serve" in phases:
        abft_rows, rb_rows, fl_rows = kernels_out
        launches = serve_out["launches"]
        fl = fl_rows["bfloat16"]
        summary = [
            dict(name="abft_matmul", route="cuda",
                 source="src/repro_torch/kernels/csrc/abft_matmul.cu",
                 replaces="src/repro/kernels/abft_matmul.py:79",
                 launches=launches["abft_matmul"],
                 max_abs_err=max(r["max_abs_err"] for r in abft_rows),
                 ms=mix_mean(abft_rows, "ms"),
                 plain_ms=mix_mean(abft_rows, "plain_ms"),
                 bound_ms=mix_mean(abft_rows, "bound_ms"),
                 bound_by="bytes", library_ms=None,
                 per="mean per launch over one DiT-XL evaluation's 172 "
                     "GEMMs at bucket 2"),
            dict(name="rollback_correct", route="cuda",
                 source="src/repro_torch/kernels/csrc/rollback_correct.cu",
                 replaces="src/repro/kernels/rollback_correct.py:34",
                 launches=launches["rollback_correct"],
                 max_abs_err=max(r["max_abs_err"] for r in rb_rows),
                 ms=mix_mean(rb_rows, "ms"),
                 plain_ms=mix_mean(rb_rows, "plain_ms"),
                 bound_ms=mix_mean(rb_rows, "bound_ms"),
                 bound_by="bytes", library_ms=None,
                 per="mean per launch over one DiT-XL evaluation's 172 "
                     "GEMMs at bucket 2"),
            dict(name="flash_attention", route="cuda",
                 source="src/repro_torch/kernels/csrc/flash_attention.cu",
                 replaces="src/repro/kernels/flash_attention.py:71",
                 launches=launches["flash_attention"],
                 max_abs_err=fl["max_abs_err"], ms=fl["ms"],
                 plain_ms=fl["plain_ms"], bound_ms=fl["bound_ms"],
                 bound_by=fl["bound_by"], library_ms=fl["library_ms"],
                 per="one launch, (32, 1024, 72) bf16"),
        ]
        print(smi, flush=True)
        emit({"kernels": summary})
    else:
        print(smi, flush=True)
    if phases != list(PHASES):
        emit({"partial": phases})      # a subset proves nothing end to end
        return 0
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
