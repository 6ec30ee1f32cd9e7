"""Synthetic data pipelines (no downloads).

Counterpart of ``repro.data.synthetic``, with the same laws:

  * token streams for LM training (Zipf-ish ids with local Markov drift,
    so the loss actually falls),
  * structured latent images for diffusion training: class-keyed blobs
    plus a frequency texture in [-1, 1],
  * stub audio frames with token streams for the enc-dec model.

``batch_at`` draws a step's batch from a CPU ``torch.Generator`` keyed by
(seed, step, shard), so any host can regenerate any step's batch and the
pipeline's state is the step alone (see ``checkpoint.manager``); the
batch then moves to ``device``, so the card trains on the CPU's numbers.
The reference draws from JAX's threefry, which cannot be replayed here:
the two pipelines follow one law but give different numbers.

On a mesh every rank draws the GLOBAL batch of a step and the sharded
train step takes the rank's rows of it by ``sharding.batch_spec``
(``sharding.batch_rows``), as the reference's launcher hands the global
batch to its sharded step; ``shard``/``num_shards`` draw other data
(from the generator keyed by the shard) and are not a mesh's rows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    kind: str                    # "lm" | "latent" | "frames"
    vocab: int = 0
    seq_len: int = 0
    latent_size: int = 0
    latent_channels: int = 4
    num_classes: int = 10
    cond_dim: int = 0
    cond_tokens: int = 0
    encoder_seq: int = 0
    global_batch: int = 8
    seed: int = 0


def generator(*key: int) -> torch.Generator:
    """A CPU generator seeded from the integers ``key``."""
    s = np.random.SeedSequence([int(k) for k in key]).generate_state(
        2, np.uint32)
    g = torch.Generator()
    g.manual_seed((int(s[0]) << 32 | int(s[1])) & (2 ** 63 - 1))
    return g


def _zipf_tokens(g: torch.Generator, shape, vocab: int) -> torch.Tensor:
    """Zipf-ish marginal with Markov structure: next ~ prev + noise."""
    u = 1e-4 + (1.0 - 1e-4) * torch.rand(shape, generator=g)
    base = (vocab * u ** 2.5).to(torch.int64) % vocab
    drift = torch.randint(-3, 4, shape, generator=g)
    toks = torch.cumsum(drift, dim=-1) % 17 + base
    return torch.clamp(toks, 0, vocab - 1)


def _latents(g: torch.Generator, batch: int, size: int, ch: int,
             labels: torch.Tensor) -> torch.Tensor:
    """Class-structured blobs: center/scale/frequency keyed by label."""
    lin = torch.linspace(-1, 1, size)
    yy, xx = torch.meshgrid(lin, lin, indexing="ij")
    lab = labels.float()[:, None, None]
    ang = lab * 0.7
    cx = 0.5 * torch.cos(ang)
    cy = 0.5 * torch.sin(ang)
    blob = torch.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2)
                       / (0.1 + 0.02 * lab)))
    freq = 2.0 + lab
    tex = 0.3 * torch.sin(freq * math.pi * xx)[..., None] * torch.ones(
        (1, 1, ch))
    noise = 0.05 * torch.randn((batch, size, size, ch), generator=g)
    x = blob[..., None] * torch.ones((1, 1, ch)) + tex + noise
    return torch.clamp(2.0 * x - 1.0, -1.0, 1.0).float()


def batch_at(cfg: DataConfig, step: int, shard: int = 0,
             num_shards: int = 1, device="cpu") -> Dict[str, torch.Tensor]:
    """Deterministically materialize the batch for (step, shard) on
    ``device``. Tokens and labels are int64."""
    if cfg.global_batch % num_shards:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"into {num_shards} shards")
    b = cfg.global_batch // num_shards
    g = generator(cfg.seed, step, shard)
    if cfg.kind == "lm":
        out = {"tokens": _zipf_tokens(g, (b, cfg.seq_len + 1), cfg.vocab)}
    elif cfg.kind == "latent":
        labels = torch.randint(0, cfg.num_classes, (b,), generator=g)
        out = {"latents": _latents(g, b, cfg.latent_size,
                                   cfg.latent_channels, labels),
               "labels": labels}
        if cfg.cond_tokens:
            out["text"] = 0.1 * torch.randn(
                (b, cfg.cond_tokens, cfg.cond_dim), generator=g)
    elif cfg.kind == "frames":
        out = {"frames": 0.5 * torch.randn(
                   (b, cfg.encoder_seq, cfg.cond_dim or cfg.vocab),
                   generator=g),
               "tokens": _zipf_tokens(g, (b, cfg.seq_len + 1), cfg.vocab)}
    else:
        raise ValueError(cfg.kind)
    return {k: v.to(device) for k, v in out.items()}


def iterate(cfg: DataConfig, start_step: int = 0, shard: int = 0,
            num_shards: int = 1, device="cpu"
            ) -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield batch_at(cfg, step, shard, num_shards, device)
        step += 1


def for_model(model_cfg, global_batch: int, seq_len: int = 0,
              seed: int = 0) -> DataConfig:
    """DataConfig matching a ModelConfig's input contract. The VLM gets a
    plain ``lm`` batch with no ``vis_embeds``, as in the reference."""
    fam = model_cfg.family
    if fam in ("dense", "moe", "ssm", "hybrid", "vlm"):
        return DataConfig("lm", vocab=model_cfg.vocab, seq_len=seq_len,
                          global_batch=global_batch, seed=seed)
    if fam == "encdec":
        return DataConfig("frames", vocab=model_cfg.vocab, seq_len=seq_len,
                          encoder_seq=model_cfg.encoder_seq,
                          cond_dim=model_cfg.d_model,
                          global_batch=global_batch, seed=seed)
    if fam in ("dit", "unet"):
        return DataConfig("latent", latent_size=model_cfg.latent_size,
                          latent_channels=model_cfg.latent_channels,
                          num_classes=max(model_cfg.num_classes, 1),
                          cond_dim=model_cfg.cond_dim,
                          cond_tokens=model_cfg.cond_tokens,
                          global_batch=global_batch, seed=seed)
    raise ValueError(fam)
