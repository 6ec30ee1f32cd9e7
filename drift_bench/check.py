"""The comparison that decides ``correct``.

One batch of the window, drawn from the run seed (``drift_bench.tap``),
is computed again by the plain reference from the weights, flip pool and
request seeds the run made. The reference follows the program step by
step: each evaluation starts from the latents the program fed its own
model at that step, because a DDIM chain from random weights magnifies
the first steps' rounding gaps ~158-fold by its last, far past any fault.
What that skips is checked on its own:

* ``inputs_max_abs``: the program's first latents against the
  reference's draw from the request seeds (exact: the same generator law
  on the same device).
* ``evals_missing``: steps of either run whose evaluation the tap did not
  see, and planned GEMM samples it did not see (0).
* ``drift_eps_rel``: the widest over the drift run's steps before
  ``nominal_steps`` (at BER 0) of the root mean square gap of the
  predicted noise, over the reference's root mean square; the reference's
  checkpoint store is filled by its own step 0. The faulted steps are
  followed GEMM by GEMM instead: at BER 3e-3 a few flips per GEMM escape
  the tile checksums, whether one does turns on the accumulator's bits and
  so on rounding, and one escaped high bit sets the next per-tensor
  activation scale, so sound runs of a whole faulted evaluation part from
  the reference as far as a lower precision does.
* ``clean_eps_rel``: the same over steps of the engine's clean reference
  run drawn from the seed.
* ``ddim_max_abs``: the widest gap between the program's next latents
  (the final ones clipped to [-1, 1], for the results and for the
  engine's clean sample) and the reference's DDIM step from the program's
  latents and noise, over every step of both runs.
* The GEMM samples (``gemm_plan``): at each faulted step, ``GEMMS_PER_STEP``
  protected GEMMs of the faulted blocks, each a band of ``BAND_ROWS``
  rows. The reference quantizes the weight itself, draws the site's flip
  mask from the pool, and runs the DRIFT GEMM on the program's int8
  activation band and scale: with the same int32 accumulators every flip,
  flag and escape coincides, so these are exact.
  ``gemm_ckpt_max_abs``: the checkpoint band the kernel was handed
  against the reference's GEMM of the program's step-0 operands (the
  store is written at step 0; a missing checkpoint reads as zeros).
  ``gemm_out_max_abs``: the kernel's corrected output band against the
  reference's, from that checkpoint. ``gemm_tiles_miscounted``: tiles
  whose replaced-element count differs from the reference's.

Each number that ``checks/<cell>.json`` gives a limit is judged; a run
with no limits, a number without one, or a number that is not finite, is
not correct.
"""
from __future__ import annotations

import math
import random
from types import SimpleNamespace
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from drift_bench import counts
from drift_bench.flips import Site
from drift_bench.tap import Capture

KINDS = ("drift", "clean")
GEMMS_PER_STEP = 2
BAND_ROWS = 128
#: integer bits of the reference's GEMMs, by the traffic's precision plan
BITS = {"int8": 8}


class Sample(NamedTuple):
    """A protected GEMM followed at a faulted step: rows ``r0`` to ``r0 +
    rows`` of the (m, k) @ (k, n) GEMM ``name`` of block ``scope``."""
    step: int
    scope: int
    name: str
    r0: int
    rows: int
    m: int
    k: int
    n: int


def bits_of(tr: dict) -> int:
    if tr["precision"] not in BITS:
        raise ValueError(f"the reference runs the precision plans "
                         f"{sorted(BITS)}, not {tr['precision']!r}")
    return BITS[tr["precision"]]


def gemm_plan(seed: int, cfg: dict, tr: dict) -> List[Sample]:
    """``GEMMS_PER_STEP`` distinct faulted GEMMs at each faulted step, each
    with a band of whole tile rows (the last one ragged where the GEMM's
    rows end in it), drawn from ``seed``."""
    rng = random.Random(seed)
    calls = counts.gemm_calls(cfg, int(tr["bucket"]))
    plan = []
    for step in range(int(tr["steps"])):
        faulted = [g for g in calls if counts.ber_at(tr, step, g.scope) > 0]
        for g in rng.sample(faulted, min(GEMMS_PER_STEP, len(faulted))):
            tiles = -(-g.m // counts.TILE)
            band = min(BAND_ROWS // counts.TILE, tiles)
            r0 = counts.TILE * rng.randrange(tiles - band + 1)
            rows = min(band * counts.TILE, g.m - r0)
            plan.append(Sample(step, g.scope, g.name, r0, rows, g.m, g.k,
                               g.n))
    return plan


def rel_rms(prog: torch.Tensor, ref: torch.Tensor) -> float:
    d = (prog.double() - ref.double())
    r = ref.double()
    return float(torch.sqrt((d * d).mean() / (r * r).mean().clamp_min(
        1e-30)))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def clean_steps(seed: int, steps: int, n: int) -> List[int]:
    """The clean run's steps that the reference evaluates."""
    return sorted(random.Random(seed).sample(range(steps), min(n, steps)))


def numbers(ref, cfg: dict, params: dict, tr: dict, rec, lat, cond, text,
            flip_source, clean_at: Sequence[int], log=None
            ) -> Dict[str, float]:
    """The numbers of one recorded batch (``tap._Record``), the reference
    module ``ref`` fed the inputs ``lat, cond, text`` it drew itself."""
    dev = lat.device
    steps = int(tr["steps"])
    bits = bits_of(tr)
    cap = rec.gemm
    ac = ref.alphas_cumprod()
    ts = ref.ddim_timesteps(len(ac), steps)

    def x_at(kind, s):
        return rec.x[kind][s].to(dev)

    def eps_at(kind, s):
        return rec.eps[kind][s].to(dev)

    def forward(kind, s, dr):
        tvec = torch.full((lat.shape[0],), float(ts[s]),
                          dtype=torch.float32, device=dev)
        with torch.no_grad():
            return ref.forward(cfg, params, x_at(kind, s), tvec, cond, text,
                               dr)

    out: Dict[str, float] = {}
    out["inputs_max_abs"] = max(max_abs(x_at(k, 0), lat) for k in KINDS)
    out["evals_missing"] = float(sum(
        len(set(range(steps)) - set(rec.seen[k])) for k in KINDS)
        + sum(not (a and b) for a, b in zip(cap.seen0, cap.seen)))
    if out["evals_missing"]:
        return dict(out, **{k: math.inf for k in (
            "drift_eps_rel", "clean_eps_rel", "ddim_max_abs",
            "gemm_ckpt_max_abs", "gemm_out_max_abs",
            "gemm_tiles_miscounted")})

    dr = ref.Drift(bits, tr["ber"], tr["nominal_steps"],
                   tr["rollback_interval"], flip_source)
    judged = range(min(int(tr["nominal_steps"]), steps))
    gaps = []
    for s in judged:
        dr.step = s
        gaps.append(rel_rms(eps_at("drift", s), forward("drift", s, dr)))
    if log is not None:
        print(f"drift eps rel at steps {list(judged)}: {gaps}", file=log)
    out["drift_eps_rel"] = max(gaps)
    gaps = []
    for s in clean_at:
        clean = ref.Drift(bits, 0.0, tr["nominal_steps"],
                          tr["rollback_interval"], None)
        clean.step = s
        gaps.append(rel_rms(eps_at("clean", s), forward("clean", s, clean)))
    if log is not None:
        print(f"clean eps rel at steps {list(clean_at)}: {gaps}", file=log)
    out["clean_eps_rel"] = max(gaps)

    widest = 0.0
    for k in KINDS:
        for s in range(steps):
            a_p = ac[ts[s + 1]] if s + 1 < steps else ac.dtype.type(1.0)
            nxt = ref.ddim_step(x_at(k, s), eps_at(k, s), ac[int(ts[s])],
                                a_p)
            if s + 1 < steps:
                widest = max(widest, max_abs(nxt, x_at(k, s + 1)))
            else:
                widest = max(widest, max_abs(torch.clamp(nxt, -1.0, 1.0),
                                             rec.final[k].to(dev)))
    out["ddim_max_abs"] = widest
    out.update(gemm_numbers(ref, cfg, params, tr, cap, flip_source, dev,
                            log))
    return out


def gemm_numbers(ref, cfg: dict, params: dict, tr: dict, cap: Capture,
                 flip_source, dev, log=None) -> Dict[str, float]:
    """The GEMM samples' numbers (module docstring)."""
    bits, dt = bits_of(tr), ref.DTYPES[cfg["dtype"]]
    ckpt_gap = out_gap = 0.0
    miscounted = replaced = 0
    for i, smp in enumerate(cap.plan):
        w = ref.block_weight(params, smp.scope, smp.name).to(dt)
        wq, sw = ref.quantize(w, bits, axis=1)
        lo, hi = smp.r0, smp.r0 + smp.rows
        y0, _ = ref.drift_gemm(cap.aq0[i].to(dev).double(),
                               cap.sx0[i].to(dev), wq, sw, None, None)
        ckpt = (cap.ckpt[i].to(dev) if cap.has_ckpt[i]
                else torch.zeros_like(y0))
        ckpt_gap = max(ckpt_gap, max_abs(ckpt, y0))
        flips = flip_source(Site(smp.step, smp.scope, smp.name),
                            (smp.m, smp.n), tr["ber"])[lo:hi]
        y, mask = ref.drift_gemm(cap.aq[i].to(dev).double(),
                                 cap.sx[i].to(dev), wq, sw, flips, ckpt)
        out_gap = max(out_gap, max_abs(cap.out[i].to(dev), y))
        tiles = ref.tile_counts(mask)
        miscounted += int((tiles != cap.tiles[i].to(dev)).sum())
        replaced += int(tiles.sum())
    if log is not None:
        print(f"gemm samples: {len(cap.plan)} bands, {replaced} elements "
              f"replaced by the reference", file=log)
    return {"gemm_ckpt_max_abs": ckpt_gap, "gemm_out_max_abs": out_gap,
            "gemm_tiles_miscounted": float(miscounted)}


def reference_record(ref, cfg: dict, params: dict, tr: dict, lat, cond,
                     text, flip_source, plan: Sequence[Sample],
                     bits: int) -> SimpleNamespace:
    """The reference in the program's place, at ``bits``: a record of the
    drift run and the clean run as the tap makes one (``x``, ``eps``,
    ``final``, ``seen``, and the drift run's GEMM samples of ``plan``)."""
    rec = SimpleNamespace(x={}, eps={}, final={}, seen={},
                          gemm=Capture(plan, pin=False))

    def on_gemm(step, scope, name, aq, sx, ckpt, out, mask):
        for i, stage in rec.gemm.at.get((step, scope, name), ()):
            rec.gemm.take(i, stage, aq, sx, ckpt, out, ref.tile_counts(mask))
    for kind, ber, src in (("drift", tr["ber"], flip_source),
                           ("clean", 0.0, None)):
        xs, es = [], []

        def on_eval(step, x, eps):
            xs.append(x.clone())
            es.append(eps.clone())
        final, _ = ref.sample(
            cfg, params, lat, cond, text, steps=int(tr["steps"]), ber=ber,
            nominal_steps=tr["nominal_steps"],
            interval=tr["rollback_interval"], flip_source=src, bits=bits,
            on_eval=on_eval, on_gemm=on_gemm if kind == "drift" else None)
        rec.x[kind], rec.eps[kind], rec.final[kind] = xs, es, final
        rec.seen[kind] = list(range(len(xs)))
    return rec


def judge(nums: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, List[Tuple[str, float, Optional[float]]]]:
    """(correct, [(name, value, limit or None)])."""
    rows = [(k, v, limits.get(k)) for k, v in nums.items()]
    ok = bool(limits) and all(
        lim is not None and math.isfinite(v) and v <= lim
        for _, v, lim in rows)
    return ok, rows
