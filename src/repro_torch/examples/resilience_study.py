"""Resilience characterization probes (paper Sec 4) on a DiT.

Counterpart of ``examples/resilience_study.py`` and of the protocol it
runs from the reference's ``benchmarks/common.py`` and
``benchmarks/fig4``-``fig7``:

    PYTHONPATH=src python -m repro_torch.examples.resilience_study \\
        --probe {similarity,bits,steps,blocks,selfheal} [--device cpu]

* ``similarity`` (Fig 2(b)): the cosine similarity of the predicted noise
  across adjacent denoising steps, the property rollback-ABFT exploits.
* ``bits`` (Fig 4): flips pinned at one accumulator bit, at a per-word
  rate of ``BIT_RATE`` on every GEMM and step, for each bit of ``BITS``.
* ``steps`` (Fig 5): BER ``STEP_BER`` at one denoising step, for every
  other step.
* ``blocks`` (Fig 6): BER ``BLOCK_BER`` on the embedding GEMMs alone,
  then on each block alone (the sampler's ``layer_gate``/``embed_gate``).
* ``selfheal`` (Fig 7): latent ``HEAL_PIXEL`` after every step, clean
  and with ``HEAL_BERS`` at step ``HEAL_STEP``, read from the sampler's
  carry (``sample_stream(window=1, on_carry=...)``).

The protocol (Sec 4): fix the noise seed, sample clean and under
injection, compare the faulty latents with the clean ones
(``quality_vs_clean``: the LPIPS proxy, PSNR, SSIM and the CLIP proxy on
latents clipped to [-1, 1]). The model is ``tiny_model``'s: random init
with the zero-init adaLN and final weights perturbed, at SMOKE by
default or at full width (``smoke=False``); the weights are random, so
whether a run shows the paper's phenomena is recorded, not assumed.
Each probe has a function that returns its numbers for given ``(cfg,
params, inputs)`` and flip source (``bit_sweep``, ``step_sweep``,
``block_sweep``, ``selfheal``; ``similarities``), so the reference's
params and masks can be carried over, and a CLI wrapper that prints the
reference's CSV lines (``name,microseconds,derived``).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import dvfs, fault, metrics
from repro_torch.core.abft import AbftConfig
from repro_torch.core.exec_ctx import DriftSystemConfig
from repro_torch.core.rollback import RollbackConfig
from repro_torch.diffusion import sampler as sampler_lib
from repro_torch.diffusion import schedule as sched_lib
from repro_torch.models import dit as dit_lib
from repro_torch.tree import tree_map

SEED = 1234
BATCH = 2
STEPS = 10
PROBES = ("similarity", "bits", "steps", "blocks", "selfheal")
BITS = (0, 4, 8, 10, 12, 14, 18, 22, 26, 30)    # Fig 4
BIT_RATE = 3e-4          # per-word flip rate at the pinned bit
STEP_BER = 1e-3          # Fig 5
BLOCK_BER = 1e-3         # Fig 6
HEAL_PIXEL = (0, 4, 4, 0)                        # Fig 7
HEAL_STEP = 3
HEAL_BERS = (("small_err", 3e-5), ("large_err", 1e-3))


def tiny_model(arch: str = "dit-xl-512", device="cpu", smoke: bool = True):
    """(cfg, params): ``arch`` at SMOKE (or at full width) from the port's
    init, the zero-init adaLN and final weights perturbed so the outputs
    are non-trivial, as the reference's ``tiny_model`` does. SMOKE
    params are drawn on the CPU, so every device gets the same ones; a
    full-width model is drawn on the device it runs on."""
    cfg = configs.get_config(arch, smoke=smoke)
    where = "cpu" if smoke else device
    params = dit_lib.init_params(cfg, SEED, where)
    g = torch.Generator(device=where)
    g.manual_seed(SEED)

    def normal(t, std):
        return std * torch.randn(t.shape, generator=g, device=where)
    for blk in params["blocks"]:
        blk["adaln_w"] = normal(blk["adaln_w"], 0.1)
        blk["adaln_b"] = normal(blk["adaln_b"], 0.1)
    params["final_w"] = normal(params["final_w"], 0.2)
    return cfg, tree_map(lambda t: t.to(device), params)


def sample_inputs(cfg, batch: int = BATCH, device="cpu"):
    """(latents, class ids or None, text or None)."""
    g = torch.Generator()
    g.manual_seed(SEED + 1)
    lat0 = torch.randn((batch, cfg.latent_size, cfg.latent_size,
                        cfg.latent_channels), generator=g)
    cond = text = None
    if cfg.cond_tokens:
        text = 0.1 * torch.randn((batch, cfg.cond_tokens, cfg.cond_dim),
                                 generator=g).to(device)
    else:
        cond = (torch.arange(batch) % max(cfg.num_classes, 1)).to(device)
    return lat0.to(device), cond, text


@torch.no_grad()
def similarities(cfg, params, lat0, cond, text=None,
                 steps: int = STEPS) -> List[float]:
    """Cosine similarity of eps between denoising steps i-1 and i, for
    i = 1 .. steps-1, along a clean DDIM chain."""
    sched = sched_lib.DdpmSchedule.default(1000)
    ts = sched_lib.ddim_timesteps(1000, steps)
    lat, prev, out = lat0, None, []
    for i, t in enumerate(ts):
        tt = torch.full((lat.shape[0],), float(t), device=lat.device)
        eps, _ = dit_lib.forward(cfg, params, lat, tt, cond, text=text)
        if prev is not None:
            num = float(torch.sum(eps * prev))
            den = float(torch.linalg.norm(eps) * torch.linalg.norm(prev))
            out.append(num / den)
        prev = eps
        t_next = int(ts[i + 1]) if i + 1 < len(ts) else -1
        lat = sched.ddim_step(lat, eps, int(t), t_next)
    return out


def probe_similarity(device="cuda") -> List[float]:
    cfg, params = tiny_model("dit-xl-512", device)
    lat0, cond, text = sample_inputs(cfg, device=device)
    sims = similarities(cfg, params, lat0, cond, text)
    print("step_pair,cos_similarity(eps)")
    for i, s in enumerate(sims, 1):
        print(f"{i - 1}->{i},{s:.4f}")
    return sims


# ------------------------------------------------------------ protocol
def run_sampler(cfg, params, lat0, cond, text=None, mode: str = "clean",
                schedule: Optional[dvfs.DvfsSchedule] = None,
                n_steps: int = STEPS, interval: int = 5,
                threshold_bit: int = 10, force_bit: int = -1,
                mask_policy: str = "union", layer_gate=None,
                embed_gate=None, flip_source=None
                ) -> sampler_lib.SampleOutput:
    """One fixed-seed sample in ``mode`` under ``schedule``, configured as
    the reference's ``benchmarks/common.py::run_sampler``. The flip
    source defaults to ``PhiloxFlipSource(SEED + 2, 0, device)``, the
    reference's run key ``PRNGKey(SEED + 2)`` in the port's own law."""
    if flip_source is None:
        flip_source = fault.PhiloxFlipSource(SEED + 2, 0, lat0.device)
    scfg = sampler_lib.SamplerConfig(
        num_sample_steps=n_steps,
        drift=DriftSystemConfig(
            mode=mode,
            abft=AbftConfig(threshold_bit=threshold_bit,
                            mask_policy=mask_policy),
            rollback=RollbackConfig(interval=interval),
            force_bit=force_bit),
        schedule=schedule, layer_gate=layer_gate, embed_gate=embed_gate)
    return sampler_lib.sample(cfg, params, flip_source, lat0, cond, scfg,
                              text=text)


# (cfg, steps, device, id(params), id(lat0)) -> (params, lat0, output):
# the entry holds its params and latents, so their ids stay theirs
_CLEAN: Dict[tuple, tuple] = {}


def clean_reference(cfg, params, inputs, n_steps: int = STEPS
                    ) -> sampler_lib.SampleOutput:
    """The clean sample (drift at BER 0) of ``(params, inputs)``, cached
    per (config, steps, device) and per params and latents."""
    lat0, cond, text = inputs
    key = (cfg, n_steps, str(lat0.device), id(params), id(lat0))
    if key not in _CLEAN:
        _CLEAN[key] = (params, lat0, run_sampler(
            cfg, params, lat0, cond, text, "clean", None, n_steps))
    return _CLEAN[key][2]


def clear_clean_cache() -> None:
    _CLEAN.clear()


def quality_vs_clean(out: sampler_lib.SampleOutput, cfg, params, inputs,
                     n_steps: int = STEPS) -> Dict[str, float]:
    """lpips, psnr, ssim and clip of ``out`` against the clean reference,
    on latents clipped to [-1, 1]; the CLIP proxy's condition is a ones
    vector of width ``max(d_model, 8)``, as in the reference."""
    ref = clean_reference(cfg, params, inputs, n_steps)
    a = torch.clamp(out.latents, -1, 1)
    b = torch.clamp(ref.latents, -1, 1)
    cond = torch.ones((a.shape[0], max(cfg.d_model, 8)), device=a.device)
    return {"lpips": float(metrics.lpips_proxy(a, b)),
            "psnr": float(metrics.psnr(a, b)),
            "ssim": float(metrics.ssim(a, b)),
            "clip": float(metrics.clip_proxy(a, cond))}


def schedule_uniform(ber: float, n_steps: int = STEPS) -> dvfs.DvfsSchedule:
    """Flat BER on every class and step (no protection anywhere)."""
    table = np.full((n_steps, dvfs.N_CLASSES), ber, np.float32)
    return dvfs.DvfsSchedule(table, dvfs.UNDERVOLT, 0)


def schedule_single_step(ber: float, step: int, n_steps: int = STEPS
                         ) -> dvfs.DvfsSchedule:
    """BER ``ber`` on every class at denoising step ``step`` alone."""
    table = np.zeros((n_steps, dvfs.N_CLASSES), np.float32)
    table[step, :] = ber
    return dvfs.DvfsSchedule(table, dvfs.UNDERVOLT, 0)


def _scored(cfg, params, inputs, n_steps: int, **kw) -> Dict[str, float]:
    """One faulty sample's quality against clean, and the sample's
    microseconds (``us``, the device drained)."""
    lat0, cond, text = inputs
    t0 = time.perf_counter()
    out = run_sampler(cfg, params, lat0, cond, text, "faulty",
                      n_steps=n_steps, **kw)
    if out.latents.is_cuda:
        torch.cuda.synchronize(out.latents.device)
    us = (time.perf_counter() - t0) * 1e6
    return dict(quality_vs_clean(out, cfg, params, inputs, n_steps), us=us)


# ------------------------------------------------------------ the probes
def bit_sweep(cfg, params, inputs, bits: Sequence[int] = BITS,
              n_steps: int = STEPS, flip_source=None
              ) -> Dict[int, Dict[str, float]]:
    """Fig 4: quality per pinned flip bit, at ``BIT_RATE`` on every GEMM
    of every step."""
    sched = schedule_uniform(BIT_RATE, n_steps)
    return {bit: _scored(cfg, params, inputs, n_steps, schedule=sched,
                         force_bit=bit, flip_source=flip_source)
            for bit in bits}


def step_sweep(cfg, params, inputs, steps: Optional[Sequence[int]] = None,
               n_steps: int = STEPS, flip_source=None
               ) -> Dict[int, Dict[str, float]]:
    """Fig 5: quality per faulted denoising step (every other one by
    default), at ``STEP_BER``."""
    steps = range(0, n_steps, 2) if steps is None else steps
    return {s: _scored(cfg, params, inputs, n_steps,
                       schedule=schedule_single_step(STEP_BER, s, n_steps),
                       flip_source=flip_source) for s in steps}


def block_sweep(cfg, params, inputs, sites: Optional[Sequence] = None,
                n_steps: int = STEPS, flip_source=None) -> Dict:
    """Fig 6: quality per faulted site at ``BLOCK_BER``: ``"embed"`` (the
    embedding GEMMs alone) and each block index alone (all by default)."""
    sites = ["embed", *range(cfg.n_layers)] if sites is None else sites
    sched = schedule_uniform(BLOCK_BER, n_steps)
    out = {}
    for site in sites:
        gate = np.zeros((cfg.n_layers,), np.float32)
        if site != "embed":
            gate[site] = 1.0
        out[site] = _scored(cfg, params, inputs, n_steps, schedule=sched,
                            layer_gate=gate,
                            embed_gate=1.0 if site == "embed" else 0.0,
                            flip_source=flip_source)
    return out


def trajectory(cfg, params, inputs, mode: str,
               schedule: Optional[dvfs.DvfsSchedule], n_steps: int = STEPS,
               flip_source=None, pixel=HEAL_PIXEL) -> np.ndarray:
    """Latent ``pixel`` after each denoising step, read from the carry of
    ``sample_stream(window=1)``, with the drift defaults the reference's
    Fig 7 uses (``DriftSystemConfig(mode=mode)``)."""
    lat0, cond, text = inputs
    if flip_source is None:
        flip_source = fault.PhiloxFlipSource(SEED + 2, 0, lat0.device)
    scfg = sampler_lib.SamplerConfig(num_sample_steps=n_steps,
                                     drift=DriftSystemConfig(mode=mode),
                                     schedule=schedule)
    vals: List[float] = []
    for _ in sampler_lib.sample_stream(
            cfg, params, flip_source, lat0, cond, scfg, window=1,
            on_carry=lambda done, carry: vals.append(float(carry[0][pixel])),
            text=text):
        pass
    return np.array(vals)


def selfheal(cfg, params, inputs, n_steps: int = STEPS, flip_source=None
             ) -> Dict[str, np.ndarray]:
    """Fig 7: the clean trajectory and one per ``HEAL_BERS`` entry, that
    BER at step ``HEAL_STEP`` alone."""
    out = {"clean": trajectory(cfg, params, inputs, "clean", None, n_steps,
                               flip_source)}
    for name, ber in HEAL_BERS:
        out[name] = trajectory(cfg, params, inputs, "faulty",
                               schedule_single_step(ber, HEAL_STEP, n_steps),
                               n_steps, flip_source)
    return out


def heal_summary(trajs: Dict[str, np.ndarray]) -> Dict[str, Dict]:
    """Per faulty trajectory: the largest deviation from clean from the
    faulted step on, the final one, and whether it healed (final below
    half the peak)."""
    out = {}
    for name, _ in HEAL_BERS:
        dev = np.abs(trajs[name] - trajs["clean"])
        peak, final = float(dev[HEAL_STEP:].max()), float(dev[-1])
        out[name] = dict(peak_dev=peak, final_dev=final,
                         healed=bool(final < 0.5 * peak + 1e-9))
    return out


# ------------------------------------------------------------ the CLI
def _csv(name: str, us: float, derived: str = "") -> None:
    print(f"{name},{us:.1f},{derived}")


def _smoke_study(device):
    cfg, params = tiny_model("dit-xl-512", device)
    return cfg, params, sample_inputs(cfg, device=device)


def probe_bits(device="cuda"):
    rows = bit_sweep(*_smoke_study(device))
    print("# fig4: bit,lpips,psnr")
    for bit, q in rows.items():
        _csv(f"fig4_bit{bit:02d}", q["us"],
             f"lpips={q['lpips']:.4f} psnr={q['psnr']:.2f}")
    return rows


def probe_steps(device="cuda"):
    rows = step_sweep(*_smoke_study(device))
    print("# fig5: inject_step,lpips,psnr")
    for step, q in rows.items():
        _csv(f"fig5_step{step}", q["us"],
             f"lpips={q['lpips']:.4f} psnr={q['psnr']:.2f}")
    return rows


def probe_blocks(device="cuda"):
    rows = block_sweep(*_smoke_study(device))
    print("# fig6: site,lpips,psnr")
    for site, q in rows.items():
        name = "fig6_embed" if site == "embed" else f"fig6_block{site}"
        _csv(name, q["us"], f"lpips={q['lpips']:.4f}")
    return rows


def probe_selfheal(device="cuda"):
    trajs = selfheal(*_smoke_study(device))
    print("# fig7: step,clean,small_err,large_err (pixel [0,4,4,0])")
    for i in range(STEPS):
        print(f"fig7,{i},{trajs['clean'][i]:.4f},"
              f"{trajs['small_err'][i]:.4f},{trajs['large_err'][i]:.4f}")
    heal = heal_summary(trajs)
    s, lg = heal["small_err"], heal["large_err"]
    _csv("fig7_small_recovery", 0.0,
         f"peak_dev={s['peak_dev']:.4f} final_dev={s['final_dev']:.4f} "
         f"healed={s['healed']}")
    _csv("fig7_large_recovery", 0.0,
         f"peak_dev={lg['peak_dev']:.4f} final_dev={lg['final_dev']:.4f}")
    return trajs


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probe", default="similarity", choices=PROBES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    probes = {"similarity": probe_similarity, "bits": probe_bits,
              "steps": probe_steps, "blocks": probe_blocks,
              "selfheal": probe_selfheal}
    return probes[args.probe](args.device)


if __name__ == "__main__":
    main()
