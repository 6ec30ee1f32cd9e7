"""Random weights in the port's parameter layout, made on the device.

Every leaf is random, the adaLN and final projections too: the port's own
``init_params`` zeroes them (adaLN-Zero), which makes every block's gate
0 and the model's output 0. The whole tree is one ``torch.randn`` from a
seeded generator on ``device`` into one flat float32 buffer (the dtype the
port serves its parameters in), then each leaf is a view of it, scaled in
place: a projection ``(a, b)`` by ``1 / sqrt(a)``, a bias, the position
table and the class table by 0.02.

The layout is the port's ``models.dit`` tree: ``blocks`` is a list with
one dict per layer; PixArt (``cond_tokens > 0``) has ``text_proj`` and a
cross-attention ``xattn`` in every block instead of ``class_embed``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from drift_bench.seeds import WEIGHT_TAG, mix64

SMALL_STD = 0.02


def leaves(cfg: dict) -> List[Tuple[Tuple, Tuple[int, ...], float]]:
    """(path, shape, std) of every leaf, in the flat buffer's order."""
    d, f = cfg["d_model"], cfg["d_ff"]
    hd = cfg["n_heads"] * cfg["head_dim"]
    pdim = cfg["patch_size"] ** 2 * cfg["latent_channels"]
    tokens = (cfg["latent_size"] // cfg["patch_size"]) ** 2

    def dense(path, a, b):
        return (path, (a, b), 1.0 / math.sqrt(a))

    def bias(path, n):
        return (path, (n,), SMALL_STD)

    out = [dense(("patch_w",), pdim, d), bias(("patch_b",), d),
           (("pos_embed",), (tokens, d), SMALL_STD),
           dense(("t_w1",), 256, d), bias(("t_b1",), d),
           dense(("t_w2",), d, d), bias(("t_b2",), d)]
    for i in range(cfg["n_layers"]):
        blk = ("blocks", i)
        out += [dense(blk + ("adaln_w",), d, 6 * d),
                bias(blk + ("adaln_b",), 6 * d)]
        groups = ("attn", "xattn") if cfg["cond_tokens"] else ("attn",)
        for g in groups:
            out += [dense(blk + (g, "wq"), d, hd),
                    dense(blk + (g, "wk"), d, hd),
                    dense(blk + (g, "wv"), d, hd),
                    dense(blk + (g, "wo"), hd, d)]
        out += [dense(blk + ("mlp_w1",), d, f), dense(blk + ("mlp_w2",), f, d)]
    out += [dense(("final_adaln_w",), d, 2 * d),
            bias(("final_adaln_b",), 2 * d),
            dense(("final_w",), d, pdim), bias(("final_b",), pdim)]
    if cfg["cond_tokens"]:
        out.append(dense(("text_proj",), cfg["cond_dim"], d))
    else:
        out.append((("class_embed",), (cfg["num_classes"] + 1, d),
                    SMALL_STD))
    return out


def count(cfg: dict) -> int:
    """Parameters of the tree."""
    return sum(math.prod(shape) for _, shape, _ in leaves(cfg))


def make(cfg: dict, seed: int, device) -> Dict:
    """The parameter tree of ``cfg`` from ``seed`` on ``device``."""
    spec = leaves(cfg)
    total = sum(math.prod(shape) for _, shape, _ in spec)
    g = torch.Generator(device=device)
    g.manual_seed(mix64(seed, WEIGHT_TAG))
    flat = torch.randn(total, generator=g, device=device,
                       dtype=torch.float32)
    tree: Dict = {"blocks": [{} for _ in range(cfg["n_layers"])]}
    off = 0
    for path, shape, std in spec:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape).mul_(std)
        off += n
        node = tree
        for key in path[:-1]:
            node = node[key] if isinstance(key, int) else \
                node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree
