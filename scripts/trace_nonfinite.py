#!/usr/bin/env python3
"""Find where a full-width DiT drift batch first goes non-finite, on the card.

    python3 scripts/trace_nonfinite.py                 # batch index 3
    python3 scripts/trace_nonfinite.py --batch-index 0 --interval 10

Serves one batch of DiT-XL/2-512 at full width as ``chip_smoke.py``'s
offload phase does (its seeded weights, requests with seeds 0 and 1, drift
at undervolt, 10 steps, bucket 2, base seed 0), with the flip masks of the
chosen batch index, one denoising step per window. Every protected GEMM's
input, its dequantized product before rollback, its checkpoint and its
corrected output, every attention output, every layer norm and the
latents after each step are checked for non-finite values. Prints one
JSON line: the first step and site where each goes non-finite, with the
detected rows and masked elements of that GEMM and where the non-finite
elements of its output came from (the product, or the checkpoint the
rollback copied in), and per step the largest finite GEMM input.

A diagnostic: it wraps the model's functions in this process only and
synchronizes on every check.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch-index", type=int, default=3)
    ap.add_argument("--interval", type=int, default=2,
                    help="rollback refresh interval (offload phase: 2)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--dump", default=None, metavar="FILE",
                    help="save the first non-finite attention call's (batch,"
                         " head) slice of q, k and v (torch.save)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.core import abft, dvfs, exec_ctx, quant
    from repro_torch.kernels import abft_matmul, ops
    from repro_torch.models import dit
    from repro_torch.models.attention import full_attention
    from repro_torch.serving import (DriftServeEngine, EngineTelemetry,
                                     FlightRecorder, SamplerKey)

    arch, bucket = chip_smoke.ARCH, chip_smoke.BUCKET
    dev = torch.device("cuda")
    cfg = get_config(arch)
    eng = DriftServeEngine(arch=arch, smoke=False, bucket=bucket,
                           device="cuda",
                           telemetry=EngineTelemetry(enabled=False),
                           tracer=FlightRecorder(enabled=False))
    params = chip_smoke._perturb(torch, dit.init_params(cfg, 11, dev), cfg,
                                 12, dev)
    key = SamplerKey(arch=arch, smoke=False, steps=args.steps, mode="drift",
                     op="undervolt", bucket=bucket,
                     rollback_interval=args.interval)
    fn = eng.servable.build_fn(key)
    latents, cond = eng.servable.batch_inputs(cfg, [0, 1])
    flips = eng.flip_source_factory(args.batch_index)

    first = {}          # category -> first event
    max_in = {}         # step -> largest finite |GEMM input|
    cur = {}            # the GEMM being run

    def bad(t):
        return int((~torch.isfinite(t)).sum())

    def note(cat, **ev):
        if cat not in first:
            first[cat] = dict(cur, **ev)

    orig_matmul = exec_ctx.ExecContext.matmul
    orig_fused = exec_ctx.drift_gemm_fused
    orig_ln, orig_attn = dit.layernorm, dit.mha_flash

    def matmul(self, x, w, *, name, rclass=dvfs.CLASS_BODY):
        cur.clear()
        cur.update(step=self.step, scope=self.scope, name=name,
                   ber=float(self.ber_by_class[int(rclass)]))
        fin = x[torch.isfinite(x)]
        if fin.numel():
            m = float(fin.abs().max())
            max_in[self.step] = max(max_in.get(self.step, 0.0), m)
        if bad(x):
            note("gemm_input", nonfinite=bad(x))
        det0 = self.stats["detected_row_errors"]
        cor0 = self.stats["corrected_elems"]
        y = orig_matmul(self, x, w, name=name, rclass=rclass)
        if bad(y):
            note("gemm_output", nonfinite=bad(y),
                 detected_rows=int(self.stats["detected_row_errors"] - det0),
                 corrected=int(self.stats["corrected_elems"] - cor0),
                 **cur.get("rollback", {}))
        return y

    def drift_gemm_fused(aq, bq, flips, sx, sw, ckpt, thr, union=True,
                         valid=None):
        out = orig_fused(aq, bq, flips, sx, sw, ckpt, thr, union=union,
                         valid=valid)
        # the product before the splice, which the fused kernel keeps in
        # registers: the ABFT kernel's c on the padded operands, dequantized
        m, n = valid
        mp, np_ = ops.padded_shape(m, n)
        fl = (torch.zeros((mp, np_), dtype=torch.int32, device=aq.device)
              if flips is None else ops._pad2(flips, mp, np_))
        c = abft_matmul.abft_matmul(ops._pad2(aq, mp, aq.shape[1]),
                                    ops._pad2(bq, bq.shape[0], np_), fl)[0]
        yv = quant.dequantize_matmul(c[:m, :n], sx, sw.reshape(1, -1))
        cv = torch.zeros_like(yv) if ckpt is None else ckpt
        ov, row_diff = out[0], out[1]
        if bad(yv):
            note("gemm_product", nonfinite=bad(yv),
                 flagged_rows=int(abft._exceeds(
                     abft.wrap_i32(row_diff.long().sum(1)), thr)[:m].sum()))
        if bad(cv):
            note("checkpoint", nonfinite=bad(cv))
        if bad(ov):
            y_bad = ~torch.isfinite(yv)
            o_bad = ~torch.isfinite(ov)
            cur["rollback"] = dict(
                from_product=int((o_bad & y_bad).sum()),
                from_checkpoint=int((o_bad & ~y_bad).sum()),
                product_nonfinite_masked=int((y_bad & ~o_bad).sum()))
        return out

    def layernorm(x, *a, **k):
        out = orig_ln(x, *a, **k)
        if bad(out):
            note("layernorm", nonfinite=bad(out), input_nonfinite=bad(x))
        return out

    def mha_flash(q, k, v, **kw):
        out = orig_attn(q, k, v, **kw)
        if bad(out) and "attention" not in first:
            # the bad (batch, token, head) rows, their inputs' range, and
            # the plain f32 version (the reference's math) on the same
            # inputs
            rows = sorted({tuple(int(i) for i in r[:3])
                           for r in (~torch.isfinite(out)).nonzero()})
            b0, s0, h0 = rows[0]
            qf, kf = q[b0, :, h0].float(), k[b0, :, h0].float()
            scores = (qf[s0] @ kf.T) * q.shape[-1] ** -0.5
            plain = full_attention(q, k, v, causal=kw.get("causal", False))
            if args.dump:
                torch.save({n: x[b0, :, h0].clone().cpu()
                            for n, x in (("q", q), ("k", k), ("v", v))},
                           args.dump)
            note("attention", nonfinite=bad(out), rows=rows[:8],
                 n_rows=len(rows),
                 inputs_nonfinite=[bad(q), bad(k), bad(v)],
                 max_abs=[float(x.float().abs().max()) for x in (q, k, v)],
                 row_q_max_abs=float(qf[s0].abs().max()),
                 row_scores=[float(scores.min()), float(scores.max())],
                 row_scores_finite=bool(torch.isfinite(scores).all()),
                 plain_nonfinite=bad(plain),
                 plain_row_finite=bool(torch.isfinite(
                     plain[b0, s0, h0]).all()))
        return out

    exec_ctx.ExecContext.matmul = matmul
    exec_ctx.drift_gemm_fused = drift_gemm_fused
    dit.layernorm, dit.mha_flash = layernorm, mha_flash
    steps = []
    with torch.no_grad():
        for ev in fn(params, flips, latents, cond,
                     dvfs.ber_monitor_init(dev), window=1):
            lat = ev.latents
            n_bad = bad(lat)
            fin = lat[torch.isfinite(lat)]
            steps.append(dict(done=len(steps) + 1, latents_nonfinite=n_bad,
                              latents_max_abs=(float(fin.abs().max())
                                               if fin.numel() else None)))
            if n_bad and "latents" not in first:
                first["latents"] = dict(after_step=len(steps) - 1,
                                        nonfinite=n_bad)
    out = dict(arch=arch, batch_index=args.batch_index,
               interval=args.interval, steps=args.steps, first=first,
               per_step=steps,
               gemm_input_max_abs={str(k): v for k, v in sorted(
                   max_in.items())},
               corrected=int(ev.total_corrected),
               card=chip_smoke.nvidia_smi())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
