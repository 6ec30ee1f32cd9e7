"""Quickstart: DRIFT in a few dozen lines, on PyTorch.

Counterpart of ``examples/quickstart.py``. Samples images from the SMOKE
DiT three ways -- clean, aggressive-DVFS unprotected, aggressive-DVFS
with DRIFT (fine-grained schedule + rollback-ABFT) -- and prints the
fixed-seed quality comparison:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

``compare`` takes the config, params, latents, labels and a flip source,
so the reference's params and flip masks can be carried over. The
port's own params and masks come from its own generators, so its
numbers differ from the reference's run.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch

from repro_torch import configs
from repro_torch.core import dvfs, fault, metrics
from repro_torch.core.exec_ctx import DriftSystemConfig
from repro_torch.diffusion import sampler
from repro_torch.models import dit
from repro_torch.tree import tree_map

ARCH, STEPS, BATCH = "dit-xl-512", 10, 2


def init_inputs(cfg, device, seed: int = 0):
    """(params, latents, labels): the port's init with the zero-init
    adaLN-Zero and final weights perturbed, as the reference perturbs
    them, so the outputs are non-trivial; drawn on the CPU, then moved."""
    g = torch.Generator()
    g.manual_seed(seed)
    params = dit.init_params(cfg, seed, "cpu")
    for blk in params["blocks"]:
        blk["adaln_w"] = 0.1 * torch.randn(blk["adaln_w"].shape, generator=g)
    params["final_w"] = 0.2 * torch.randn(params["final_w"].shape,
                                          generator=g)
    lat0 = torch.randn((BATCH, cfg.latent_size, cfg.latent_size,
                        cfg.latent_channels), generator=g)
    params = tree_map(lambda t: t.to(device), params)
    return params, lat0.to(device), torch.tensor([1, 2], device=device)


def run(cfg, params, lat0, cond, mode: str, schedule, flip_source
        ) -> sampler.SampleOutput:
    scfg = sampler.SamplerConfig(num_sample_steps=STEPS,
                                 drift=DriftSystemConfig(mode=mode),
                                 schedule=schedule)
    return sampler.sample(cfg, params, flip_source, lat0, cond, scfg)


def compare(cfg, params, lat0, cond, flip_source) -> Dict[str, float]:
    """Clean, faulty and drift at undervolt over ``STEPS`` steps: the
    lpips-proxy of the unprotected and the DRIFT images against the clean
    one, and DRIFT's corrected elements."""
    sched = dvfs.fine_grained_schedule(STEPS, dvfs.UNDERVOLT,
                                       nominal_steps=2)
    clean = run(cfg, params, lat0, cond, "clean", None, flip_source)
    faulty = run(cfg, params, lat0, cond, "faulty", sched, flip_source)
    drift = run(cfg, params, lat0, cond, "drift", sched, flip_source)

    def img(o):
        return torch.clamp(o.latents, -1, 1)
    return {"faulty_lpips": float(metrics.lpips_proxy(img(faulty),
                                                      img(clean))),
            "drift_lpips": float(metrics.lpips_proxy(img(drift), img(clean))),
            "corrected": int(drift.total_corrected)}


def main(argv: Optional[list] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = configs.get_config(ARCH, smoke=True)
    params, lat0, cond = init_inputs(cfg, args.device)
    out = compare(cfg, params, lat0, cond,
                  fault.PhiloxFlipSource(0, 0, args.device))
    print(f"operating point: {dvfs.UNDERVOLT.voltage}V @ "
          f"{dvfs.UNDERVOLT.freq_ghz}GHz -> BER "
          f"{dvfs.ber_of(dvfs.UNDERVOLT):.1e}")
    print(f"unprotected  lpips-proxy vs clean: {out['faulty_lpips']:.4f}")
    print(f"DRIFT        lpips-proxy vs clean: {out['drift_lpips']:.4f} "
          f"(corrected {out['corrected']} elements)")
    return out


if __name__ == "__main__":
    main()
