"""Resilience characterization probes (paper Sec 4) on a small DiT.

Counterpart of ``examples/resilience_study.py``:

    PYTHONPATH=src python -m repro_torch.examples.resilience_study \\
        --probe similarity [--device cpu]

``similarity`` (Fig 2(b)) prints the cosine similarity of the predicted
noise across adjacent denoising steps, the property rollback-ABFT
exploits. Its model and inputs come from ``tiny_model`` and
``sample_inputs`` here (the reference's are in its JAX benchmark
folder); ``similarities`` takes them as arguments, so the reference's
can be carried over. The ``bits``, ``steps``, ``blocks`` and
``selfheal`` probes run the reference's benchmark folder
(``benchmarks/fig4``-``fig7``), which the port's benchmark issue
(ROADMAP Queue A) will carry; here they raise.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from repro_torch import configs
from repro_torch.diffusion import schedule as sched_lib
from repro_torch.models import dit as dit_lib
from repro_torch.tree import tree_map

SEED = 1234
BATCH = 2
STEPS = 10
PROBES = ("similarity", "bits", "steps", "blocks", "selfheal")


def tiny_model(arch: str = "dit-xl-512", device="cpu"):
    """(cfg, params): the SMOKE config from the port's init, the
    zero-init adaLN and final weights perturbed so the outputs are
    non-trivial, as the reference's ``tiny_model`` does."""
    cfg = configs.get_config(arch, smoke=True)
    params = dit_lib.init_params(cfg, SEED, "cpu")
    g = torch.Generator()
    g.manual_seed(SEED)
    for blk in params["blocks"]:
        blk["adaln_w"] = 0.1 * torch.randn(blk["adaln_w"].shape, generator=g)
        blk["adaln_b"] = 0.1 * torch.randn(blk["adaln_b"].shape, generator=g)
    params["final_w"] = 0.2 * torch.randn(params["final_w"].shape,
                                          generator=g)
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


def _unported(name: str):
    def probe(device="cuda"):
        raise NotImplementedError(
            f"--probe {name} runs the reference's JAX benchmark folder; the "
            "port's benchmark issue (ROADMAP Queue A) carries it")
    return probe


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probe", default="similarity", choices=PROBES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    probes = {"similarity": probe_similarity,
              **{p: _unported(p) for p in PROBES[1:]}}
    return probes[args.probe](args.device)


if __name__ == "__main__":
    main()
