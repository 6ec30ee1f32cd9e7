"""The frozen counts against hand counts at DiT-XL/2-512's shapes, and the
model's operations beside the DiT paper's published 524.6 GFLOPs."""
import json
from pathlib import Path

import pytest

from drift_bench import counts, weights

BENCH = Path(__file__).resolve().parents[1]


def _cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_drift_gemm_work_mlp_w1_bucket16():
    # mlp.w1 of one evaluation at bucket 16: 16 x 1024 rows, K 1152, N 4608
    m, k, n = 16384, 1152, 4608
    mt, nt = 512, 144                     # 32 x 32 checksum tiles
    w = counts.drift_gemm_work(m, k, n)
    assert w["int8_ops"] == (2 * 16384 * 4608 * 1152      # the product
                             + 2 * 16384 * 1152 * 144     # A @ B's block sums
                             + 2 * 512 * 1152 * 4608)     # A's block sums @ B
    out = 4 * m * n + 4 * m * nt + 4 * mt * n + 4 * mt * nt
    assert w["bytes"] == m * k + k * n + 4 + 4 * n + out
    # flips and checkpoint reads add 4 bytes a word
    w2 = counts.drift_gemm_work(m, k, n, flip_words=m * n, ckpt_reads=1000)
    assert w2["bytes"] - w["bytes"] == 4 * m * n + 4000


def test_drift_gemm_work_ragged_tiles():
    # t.w1 at bucket 16: M = 16 rows pad to one 32-row tile
    w = counts.drift_gemm_work(16, 256, 1152)
    assert w["int8_ops"] == 2 * 16 * 1152 * 256 + 2 * 16 * 256 * 36 \
        + 2 * 1 * 256 * 1152
    assert w["bytes"] == (16 * 256 + 256 * 1152 + 4 + 4 * 1152
                          + 4 * 16 * 1152 + 4 * 32 * 36 + 4 * 1 * 1152
                          + 4 * 36)


def test_attention_work_bucket16():
    w = counts.attention_work(16, 1024, 16, 72)
    # QK^T and PV: 2 * 2 * S * S * D per head and image
    assert w["flops"] == 4 * 16 * 16 * 72 * 1024 * 1024
    assert w["bytes"] == 2 * 16 * 1024 * 16 * 72 * 4      # q, k, v, o bf16


def test_model_ops_per_image_dit_xl_512():
    ops = counts.model_ops_per_image(_cfg("dit-xl-512"))
    per_block = 4 * 2 * 1024 * 1152 * 1152 + 2 * 2 * 1024 * 1152 * 4608
    embed = 2 * 2 * 1024 * 16 * 1152 + 2 * 256 * 1152 + 2 * 1152 * 1152
    assert ops["int8_ops"] == 28 * per_block + embed == 913_296_162_816
    attn = 4 * 1024 * 1024 * 72 * 16
    adaln = 2 * 1152 * 6 * 1152
    assert ops["flops"] == 28 * (attn + adaln) + 2 * 1152 * 2 * 1152
    # The DiT paper (Table 4) gives 524.6 GFLOPs for XL/2 at 512, counting
    # a multiply-add once: half of ours, less DiT's learned-sigma output
    # channels, which the port does not predict (2 * 1024 * 1152 * 16
    # operations)
    total = ops["int8_ops"] + ops["flops"]
    assert total == 1_049_038_848_000
    assert (total + 2 * 1024 * 1152 * 16) / 2 / 1e9 == pytest.approx(
        524.6, abs=0.1)


def test_pixart_adds_cross_attention_gemms():
    dit = counts.gemm_calls(_cfg("dit-xl-512"), 16)
    pix = counts.gemm_calls(_cfg("pixart-alpha"), 16)
    assert len(dit) == 3 + 28 * 6 + 1 == 172
    assert len(pix) == 4 + 28 * 10 + 1 == 285
    assert {g.name for g in pix} - {g.name for g in dit} == {
        "text", "xattn.q", "xattn.k", "xattn.v", "xattn.o"}
    xk = next(g for g in pix if g.name == "xattn.k")
    assert (xk.m, xk.k, xk.n) == (16 * 120, 1152, 1152)


@pytest.mark.parametrize("name", ["dit-xl-512", "pixart-alpha"])
def test_parameter_counts(name):
    cfg = _cfg(name)
    assert weights.count(cfg) == cfg["params"]
