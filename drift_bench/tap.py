"""A tap on the port's model evaluation, for the comparison that decides
``correct``.

The engine hands back final latents only, and a DDIM chain from random
weights magnifies the smallest rounding gap of an early step by the
ratio of its noise scales (~158x over 10 steps from t = 999), so final
latents cannot tell sound rounding from a fault. The check therefore
follows the program step by step: for one batch of the window, drawn from
the run seed by reservoir sampling as the batches come, the tap copies
each evaluation's input latents and predicted noise (the drift run's and
the engine's clean reference's, told apart by the clean run's missing
flip source) and the batch's two final outputs into pinned host buffers,
with non-blocking copies: no synchronize and no device memory held.

At the faulted steps a whole evaluation cannot be followed (see
``drift_bench.check``), so the tap also follows single protected GEMMs of
the recorded batch's drift run, at the sites and row bands of a plan
drawn from the run seed (``check.gemm_plan``): at step 0 the band of the
int8 activation operand and its scale (what the checkpoint of that GEMM
was made from), and at the sample's faulted step the band of the int8
activation operand, its scale, the checkpoint the kernel was handed, and
the kernel's corrected output and per-tile replaced counts.

The tap wraps ``repro_torch.models.dit.forward``, the function the
sampler calls for every evaluation, ``ExecContext._drift``, which runs
each protected GEMM of the drift path, and the ``drift_gemm_fused`` it
calls, and changes nothing they compute.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

import torch

KINDS = ("drift", "clean")
TILE = 32


class Capture:
    """Buffers of the planned GEMM samples of one drift run (``plan``, a
    list of ``check.Sample``): per sample, the step-0 operand band
    ``aq0`` and scale ``sx0``; at its step the operand band ``aq``, scale
    ``sx``, checkpoint band ``ckpt`` (``has_ckpt`` false where the kernel
    was handed none), output band ``out`` and per-tile replaced counts
    ``tiles``; ``seen0`` and ``seen`` mark what was taken. Copies are
    non-blocking into (with ``pin``) pinned host memory."""

    def __init__(self, plan: Sequence, pin: bool):
        def buf(shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=pin)
        self.plan = list(plan)
        self.at: Dict[Tuple[int, int, str], List[Tuple[int, int]]] = {}
        self.aq0, self.sx0, self.aq, self.sx = [], [], [], []
        self.ckpt, self.out, self.tiles = [], [], []
        for i, smp in enumerate(self.plan):
            self.at.setdefault((0, smp.scope, smp.name), []).append((i, 0))
            self.at.setdefault((smp.step, smp.scope, smp.name),
                               []).append((i, 1))
            self.aq0.append(buf((smp.rows, smp.k), torch.int8))
            self.aq.append(buf((smp.rows, smp.k), torch.int8))
            self.sx0.append(buf((), torch.float32))
            self.sx.append(buf((), torch.float32))
            self.ckpt.append(buf((smp.rows, smp.n), torch.float32))
            self.out.append(buf((smp.rows, smp.n), torch.float32))
            self.tiles.append(buf((-(-smp.rows // TILE), -(-smp.n // TILE)),
                                  torch.int32))
        self.reset()

    def reset(self) -> None:
        n = len(self.plan)
        self.seen0, self.seen = [False] * n, [False] * n
        self.has_ckpt = [False] * n

    def take(self, i: int, stage: int, aq, sx, ckpt=None, out=None,
             tiles=None) -> None:
        """Sample ``i``'s band of a GEMM at its step-0 (``stage`` 0) or
        faulted (1) call: ``aq (M, K)``, ``sx``, and at stage 1 ``ckpt
        (M, N)`` or None, ``out (M, N)`` and ``tiles (Mt, Nt)``."""
        smp = self.plan[i]
        lo, hi = smp.r0, smp.r0 + smp.rows
        if stage == 0:
            self.aq0[i].copy_(aq[lo:hi], non_blocking=True)
            self.sx0[i].copy_(sx, non_blocking=True)
            self.seen0[i] = True
            return
        self.aq[i].copy_(aq[lo:hi], non_blocking=True)
        self.sx[i].copy_(sx, non_blocking=True)
        self.has_ckpt[i] = ckpt is not None
        if ckpt is not None:
            self.ckpt[i].copy_(ckpt[lo:hi], non_blocking=True)
        self.out[i].copy_(out[lo:hi], non_blocking=True)
        t0 = lo // TILE
        self.tiles[i].copy_(tiles[t0:t0 + self.tiles[i].shape[0]],
                            non_blocking=True)
        self.seen[i] = True


class _Record:
    """Host buffers of one batch: per kind, (steps, *shape) inputs and
    noise predictions, the steps seen, and the final latents."""

    def __init__(self, steps: int, shape: Tuple[int, ...], plan: Sequence,
                 pin: bool):
        def buf(*lead):
            return torch.empty(lead + shape, dtype=torch.float32,
                               pin_memory=pin)
        self.x = {k: buf(steps) for k in KINDS}
        self.eps = {k: buf(steps) for k in KINDS}
        self.final = {k: buf() for k in KINDS}
        self.seen: Dict[str, List[int]] = {k: [] for k in KINDS}
        self.gemm = Capture(plan, pin)
        self.batch_index = -1
        self.seeds: Tuple[int, ...] = ()


class Tap:
    """Records one batch of the window, chosen uniformly from the seed, and
    the GEMM samples of ``plan`` in its drift run."""

    def __init__(self, seed: int, steps: int, shape: Tuple[int, ...],
                 plan: Sequence, device):
        pin = torch.device(device).type == "cuda"
        self._records = [_Record(steps, shape, plan, pin) for _ in range(2)]
        self._site: Optional[Tuple[int, int, str]] = None
        self._kept: Optional[int] = None
        self._live: Optional[int] = None
        self._rng = random.Random(seed)
        self._batches = 0
        self._orig: Optional[tuple] = None

    @property
    def kept(self) -> Optional[_Record]:
        """The chosen batch's record, once its batch has ended."""
        return None if self._kept is None else self._records[self._kept]

    # ------------------------------------------------------------ wiring
    def install(self) -> None:
        from repro_torch.core import exec_ctx
        from repro_torch.models import dit
        forward0 = dit.forward
        drift0 = exec_ctx.ExecContext._drift
        fused0 = exec_ctx.drift_gemm_fused
        self._orig = (forward0, drift0, fused0)
        tap = self

        def forward(cfg, params, latents, t, cond, drift=None, text=None):
            eps, stats = forward0(cfg, params, latents, t, cond, drift=drift,
                                  text=text)
            if tap._live is not None and drift is not None:
                rec = tap._records[tap._live]
                kind = "clean" if drift.flip_source is None else "drift"
                rec.x[kind][drift.step].copy_(latents, non_blocking=True)
                rec.eps[kind][drift.step].copy_(eps, non_blocking=True)
                rec.seen[kind].append(int(drift.step))
            return eps, stats

        def _drift(ctx, name, xq, wq, flips, count):
            if tap._live is not None and ctx.flip_source is not None:
                tap._site = (ctx.step, ctx.scope, name)
            try:
                return drift0(ctx, name, xq, wq, flips, count)
            finally:
                tap._site = None

        def fused(aq, bq, flips, sx, sw, ckpt, threshold, union=True,
                  valid=None):
            res = fused0(aq, bq, flips, sx, sw, ckpt, threshold, union=union,
                         valid=valid)
            if tap._site is not None:
                cap = tap._records[tap._live].gemm
                for i, stage in cap.at.get(tap._site, ()):
                    cap.take(i, stage, aq, sx, ckpt, res[0], res[3])
            return res

        dit.forward = forward
        exec_ctx.ExecContext._drift = _drift
        exec_ctx.drift_gemm_fused = fused

    def uninstall(self) -> None:
        if self._orig is not None:
            from repro_torch.core import exec_ctx
            from repro_torch.models import dit
            (dit.forward, exec_ctx.ExecContext._drift,
             exec_ctx.drift_gemm_fused) = self._orig
            self._orig = None

    # ----------------------------------------------------------- batches
    def begin(self) -> None:
        """Start of a window batch: the n-th replaces the kept record with
        probability 1/n, so each batch is the one kept alike."""
        self._batches += 1
        if self._rng.random() * self._batches < 1.0:
            self._live = 1 if self._kept == 0 else 0
            self._records[self._live].seen = {k: [] for k in KINDS}
            self._records[self._live].gemm.reset()

    def end(self, results, clean: torch.Tensor, seeds) -> None:
        """End of a window batch; if it was recorded: its drift finals (the
        results' latents, in request order) and the engine's clean
        sample."""
        if self._live is None:
            return
        rec = self._records[self._live]
        rec.final["drift"].copy_(torch.stack(
            [r.latents for r in sorted(results,
                                       key=lambda r: r.request_id)]),
            non_blocking=True)
        rec.final["clean"].copy_(clean, non_blocking=True)
        rec.batch_index = results[0].batch_index
        rec.seeds = tuple(seeds)
        self._kept, self._live = self._live, None
