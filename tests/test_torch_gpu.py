"""The port's CUDA kernels against their plain PyTorch versions (the
attention kernel's gradients, which training takes, included), the
checkpoint-offload store's side-stream copies into pinned memory, a
drain through the telemetry front end's ``/events`` with offload on, the
bf16-only LM weights (``transformer.init_weights``), the MoE routing,
the SSD blocks, ``DriftDecode`` and the windowed decode, and the sharded
DiT and MoE LM on 2 ranks sharing the card over gloo, on the card.

Marked ``gpu``: each test skips without a CUDA device. This module imports
no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from repro_torch import configs

from repro_torch.kernels import abft_matmul as tak
from repro_torch.kernels import fault_inject as tfi
from repro_torch.kernels import flash_attention as tfk
from repro_torch.kernels import ops
from repro_torch.kernels import rollback_correct as trk
from repro_torch.kernels import stat_abft
from repro_torch.launch import train as train_cli
from repro_torch.models import mamba2, moe, transformer
from repro_torch.models.attention import full_attention
from repro_torch.serving.offload import OffloadConfig, OffloadStore
from repro_torch.tree import tree_leaves, tree_map


def _int8(rng, shape, extreme=False):
    if extreme:
        return rng.choice(np.array([-127, 127], np.int8), size=shape)
    return rng.integers(-127, 128, size=shape, dtype=np.int8)


def _flips(rng, shape, p=0.01):
    hit = rng.random(shape) < p
    pos = rng.integers(0, 32, size=shape).astype(np.uint32)
    return np.where(hit, np.left_shift(np.uint32(1), pos),
                    np.uint32(0)).astype(np.uint32)


def _qkv(rng, shape):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _abft_check(aq, bq, flips):
    """One kernel launch, all five outputs bit-equal to the plain version."""
    n0 = tak.launches
    got = tak.abft_matmul(aq, bq, flips)
    torch.cuda.synchronize()
    assert tak.launches == n0 + 1
    for label, g, w in zip(("c", "act_row", "exp_row", "act_col", "exp_col"),
                           got, tak.abft_matmul_plain(aq, bq, flips)):
        assert torch.equal(g, w), label
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(64, 16, 96), (32, 4608, 64),
                                   (96, 100, 32), (32, 16, 32),
                                   (32, 256, 1152), (160, 1152, 96),
                                   (2048, 4608, 1152), (2048, 1152, 4608)])
def test_abft_kernel_matches_plain_on_card(cuda, m, k, n):
    """The tensor-core kernel: K of one half-empty k32 step (16), ragged
    (100, byte-wise staging), deep (4608); M and N that are multiples of 32
    but not of the 128 tile (32, 96, 160); the DiT's mlp shapes."""
    rng = np.random.default_rng(m + k + n)
    aq = torch.from_numpy(_int8(rng, (m, k), extreme=k > 1000)).to(cuda)
    bq = torch.from_numpy(_int8(rng, (k, n))).to(cuda)
    fl = _flips(rng, (m, n), p=0.05)
    fl[0, 0] = np.uint32(1 << 31)
    flips = torch.from_numpy(fl.view(np.int32)).to(cuda)
    _abft_check(aq, bq, flips)


@pytest.mark.gpu
def test_abft_kernel_wraps_at_k4608_on_card(cuda):
    """Every operand 127 at K = 4608: the expected sums wrap mod 2^32
    (32 * 127^2 * 4608 ~ 2.4e9), and a bit-31 flip comes through the xor
    and the sums."""
    m, k, n = 64, 4608, 96
    aq = torch.full((m, k), 127, dtype=torch.int8, device=cuda)
    bq = torch.full((k, n), 127, dtype=torch.int8, device=cuda)
    flips = torch.zeros((m, n), dtype=torch.int32, device=cuda)
    flips[3, 5] = -2 ** 31
    got = _abft_check(aq, bq, flips)
    assert int(got[2][0, 0]) == 32 * 127 * 127 * 4608 - 2 ** 32
    assert int(got[1][3, 0] - got[2][3, 0]) % 2 ** 32 == 2 ** 31


@pytest.mark.gpu
@pytest.mark.parametrize("fill", [127, -128])
def test_abft_kernel_past_k_2_17_on_card(cuda, fill):
    """K = 2^17 + 64, every operand ``fill``: the header's bound for
    accumulators below 2^31 is K < 2^17. At 127 the products stay below
    2^31 (127^2 * K ~ 2.115e9); at -128 they reach 2^14 * K ~ 2.149e9 and
    wrap. Either way every output is bit-equal to the plain version, which
    wraps mod 2^32 as the reference does."""
    m, k, n = 64, 2 ** 17 + 64, 64
    aq = torch.full((m, k), fill, dtype=torch.int8, device=cuda)
    bq = torch.full((k, n), fill, dtype=torch.int8, device=cuda)
    flips = torch.zeros((m, n), dtype=torch.int32, device=cuda)
    flips[1, 2] = -2 ** 31
    got = _abft_check(aq, bq, flips)
    want = (fill * fill * k + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert int(got[0][0, 0]) == want


@pytest.mark.gpu
@pytest.mark.parametrize("offset_a,offset_b", [(1, 0), (0, 2), (16, 4)])
def test_abft_kernel_on_offset_operands_on_card(cuda, offset_a, offset_b):
    """Operands that start off 16 bytes (A) or 4 bytes (B) take the
    byte-wise staging at K = 256; (16, 4) keeps the vector path."""
    rng = np.random.default_rng(offset_a + offset_b)
    m, k, n = 96, 256, 160
    a = torch.from_numpy(_int8(rng, (m * k + offset_a,))).to(cuda)
    b = torch.from_numpy(_int8(rng, (k * n + offset_b,))).to(cuda)
    aq = a[offset_a:].view(m, k)
    bq = b[offset_b:].view(k, n)
    assert tak.launch_args(aq, bq)[3] == (offset_a % 16 == 0
                                          and offset_b % 4 == 0)
    fl = _flips(rng, (m, n), p=0.05)
    flips = torch.from_numpy(fl.view(np.int32)).to(cuda)
    _abft_check(aq, bq, flips)


@pytest.mark.gpu
@pytest.mark.parametrize("valid", [None, (50, 70)])
@pytest.mark.parametrize("union", [True, False])
def test_rollback_kernel_matches_plain_on_card(cuda, union, valid):
    rng = np.random.default_rng(5)
    m, n = 64, 96
    c = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    ck = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    rd = torch.from_numpy(rng.integers(-3000, 3000, (m, n // 32),
                                       dtype=np.int32))
    cd = torch.from_numpy(rng.integers(-3000, 3000, (m // 32, n),
                                       dtype=np.int32))
    cd[0, 0] = -2 ** 31
    args = [x.to(cuda) for x in (c, ck, rd, cd)]
    got = trk.rollback_correct(*args, 1024, union=union, valid=valid)
    want = trk.rollback_correct_plain(*args, 1024, union=union, valid=valid)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_matches_plain_on_card(cuda, dtype, tol, causal):
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(x).to(cuda, dtype)
               for x in _qkv(rng, (4, 100, 72)))
    got = tfk.flash_attention(q, k, v, causal=causal)
    want = tfk.flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("shape,offset", [((2, 2048), 0), ((2, 1, 8192), 0),
                                          ((7, 13), 0), ((1001,), 1),
                                          ((4097,), 0), ((4098,), 0),
                                          ((4099,), 0), ((4097,), 1),
                                          ((4098,), 2), ((4099,), 3),
                                          ((3,), 0)])
def test_fault_inject_kernel_matches_plain_on_card(cuda, dtype, shape,
                                                   offset):
    """Bit-equal on int32 views: the vector path, its tails of 1, 2 and 3
    words (lengths 4k + 1, 4k + 2, 4k + 3; a length of 3 is all tail), and
    (offsets 1 to 3 words) the unaligned one-word path."""
    rng = np.random.default_rng(11)
    n = int(np.prod(shape)) + offset
    x = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64
                                      ).astype(np.int32)).to(cuda)
    x = x[offset:].reshape(shape).view(dtype)
    m = _flips(rng, (n,), p=0.1)
    m[offset] = np.uint32(1 << 31)
    mask = torch.from_numpy(m.view(np.int32)).to(cuda)[offset:].reshape(
        shape)
    n0 = tfi.launches
    got = tfi.fault_inject(x, mask)
    torch.cuda.synchronize()
    assert tfi.launches == n0 + 1 and got.dtype == dtype
    assert torch.equal(got.view(torch.int32),
                       tfi.fault_inject_plain(x, mask).view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_flash_kernel_at_prefill_shape_on_card(cuda, dtype, tol):
    """The LM prefill's (32, 8, 128) causal call, head dim 128: the
    tensor-core kernel's widest instantiation (bf16) and the CUDA-core
    kernel's NC = 4 one (f32), both with over 48 KB of shared memory."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(x).to(cuda, dtype)
               for x in _qkv(rng, (32, 8, 128)))
    got = tfk.flash_attention(q, k, v, causal=True)
    want = tfk.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _bshd(rng, b, s, h, d, strided, device):
    """bf16 q, k, v of shape (B, S, H, D): separate contiguous tensors, or
    views sliced from one fused (B, S, 3, H, D) tensor."""
    if strided:
        x = torch.from_numpy(rng.standard_normal((b, s, 3, h, d)).astype(
            np.float32)).to(device, torch.bfloat16)
        return x[:, :, 0], x[:, :, 1], x[:, :, 2]
    return [torch.from_numpy(a).to(device, torch.bfloat16)
            for a in _qkv(rng, (b, s, h, d))]


@pytest.mark.gpu
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [8, 100, 1024])
@pytest.mark.parametrize("d", [32, 36, 72, 128])
def test_flash_tensor_core_kernel_matches_plain_on_card(cuda, d, s, causal,
                                                        strided):
    """bf16 tensor-core kernel vs the plain f32-softmax version, within
    3e-2 (the kernel rounds p to bf16 as the Pallas kernel does): head dims
    on each instantiation (32 and 72 on the one padded to 80, 36, not a
    multiple of 8, there on element loads; 128), one partly masked tile
    (S = 8), a ragged last tile (100) and 16 tiles (1024)."""
    rng = np.random.default_rng(d * 1000 + s)
    q, k, v = _bshd(rng, 2, s, 2, d, strided, cuda)
    n0 = tfk.launches
    got = tfk.mha_flash(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfk.launches == n0 + 1
    want = full_attention(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                               rtol=3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("d,causal", [(72, False), (128, True)])
def test_flash_kernel_finite_at_large_scores_on_card(cuda, d, causal):
    """Activations of ~3e5, as undervolted full-width DiT layers reach
    them, give raw scores of ~1e12: the softmax's exponent is the scaled
    difference to the row max, never above 0, so every row is finite and
    matches the plain version (ROADMAP Queue C 10: a folded FFMA let the
    rounding residual of the scaled max reach exp2 and NaN whole rows)."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 1024, 2, d))
                                .astype(np.float32) * 3e5)
               .to(cuda, torch.bfloat16) for _ in range(3))
    got = tfk.mha_flash(q, k, v, causal=causal)
    want = full_attention(q, k, v, causal=causal)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2 * 3e5,
                               rtol=3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mha_flash_is_one_launch_with_contiguous_output(cuda, dtype):
    """One mha_flash call on a fused projection's views launches exactly
    one kernel (no head folds) and returns a contiguous (B, S, H, D), so
    the caller's reshape to (B, S, H * D) is a view."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 40, 3, 4, 72)).astype(
        np.float32)).to(cuda, dtype)
    n0 = tfk.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        o = tfk.mha_flash(x[:, :, 0], x[:, :, 1], x[:, :, 2])
        torch.cuda.synchronize()
    assert tfk.launches == n0 + 1
    assert o.shape == (2, 40, 4, 72) and o.is_contiguous()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0)) > 0]
    assert [e.count for e in kernels] == [1]


def _gqa_qkv(rng, b, s, h, hkv, d, dtype, fused, q_scale, device):
    """q (B, S, H, D) and k, v (B, S, Hkv, D): views of one fused
    (B, S, H + 2 Hkv, D) projection, or separate tensors."""
    if fused:
        x = torch.from_numpy(rng.standard_normal(
            (b, s, h + 2 * hkv, d)).astype(np.float32)).to(device, dtype)
        q, k, v = x[:, :, :h], x[:, :, h:h + hkv], x[:, :, h + hkv:]
    else:
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (b, s, n, d)).astype(np.float32)).to(device, dtype)
            for n in (h, hkv, hkv))
    if q_scale != 1.0:
        q = (q.float() * q_scale).to(dtype)
    return q, k, v


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("ratio", [1, 2, 16])
@pytest.mark.parametrize("d", [16, 128, 168, 256])
@pytest.mark.parametrize("dtype,s,tol", [(torch.bfloat16, 8, 3e-2),
                                         (torch.bfloat16, 1024, 1e-2),
                                         (torch.float32, 100, 2e-5)])
def test_flash_gqa_window_softcap_matches_plain_on_card(
        cuda, dtype, s, tol, d, ratio, windowed, softcap, causal):
    """The kernel against ``full_attention`` at 16 query heads over
    16 / ratio KV heads, head dims on each tensor-core instantiation (16
    on the one padded to 80, 128, 168 padded to 176, 256) and the f32
    kernel's NC = 1, 4, 6, 8; windows that bind (3 of 8, 300 of 1024, 37
    of 100: tiles skipped and cut), the softcap of 50 with queries scaled
    by 8 so that scores of ~30 bend. bf16 on views of one fused
    projection, within 3e-2 at S = 8 and 1e-2 at S = 1024 (p and the
    output rounded to bf16); f32 on separate tensors within 2e-5. One
    launch each, a contiguous finite output."""
    h = 16
    window = {8: 3, 100: 37, 1024: 300}[s] if windowed else 0
    rng = np.random.default_rng(d * 7 + ratio * 3 + s + window)
    q, k, v = _gqa_qkv(rng, 1, s, h, h // ratio, d, dtype,
                       fused=dtype == torch.bfloat16,
                       q_scale=8.0 if softcap else 1.0, device=cuda)
    n0 = tfk.launches
    got = tfk.mha_flash(q, k, v, causal=causal, window=window,
                        softcap=softcap)
    torch.cuda.synchronize()
    assert tfk.launches == n0 + 1
    assert got.shape == q.shape and got.is_contiguous()
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    want = full_attention(q, k, v, causal=causal, window=window,
                          attn_softcap=softcap)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,window,dtype,tol", [
    (2, 8, 1024, torch.bfloat16, 3e-2), (2, 8, 0, torch.bfloat16, 3e-2),
    (1, 2048, 1024, torch.bfloat16, 1e-2), (1, 100, 37, torch.float32, 2e-5)])
def test_flash_group5_matches_plain_on_card(cuda, b, s, window, dtype, tol):
    """hymba-1.5b's attention: 25 query heads over 5 KV heads (group 5, the
    first odd group) at D = 64, causal. Its prefill at 8 tokens on a local
    layer (window 1024) and a global one, a window that binds at 2048
    tokens, and the f32 kernel at 100 tokens with a window of 37. bf16 on
    views of one fused projection within 3e-2 (S = 8) and 1e-2 (S = 2048),
    f32 within 2e-5; one launch, a contiguous finite output."""
    rng = np.random.default_rng(s + window)
    q, k, v = _gqa_qkv(rng, b, s, 25, 5, 64, dtype,
                       fused=dtype == torch.bfloat16, q_scale=1.0,
                       device=cuda)
    n0 = tfk.launches
    got = tfk.mha_flash(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert tfk.launches == n0 + 1
    assert got.shape == q.shape and got.is_contiguous()
    assert bool(torch.isfinite(got).all())
    want = full_attention(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("d,ratio", [(256, 2), (168, 2), (128, 16)])
def test_mha_flash_gqa_is_one_kernel_on_card(cuda, d, ratio):
    """gemma2-9b's, gemma3-27b's and glm4-9b's prefill calls at 8 tokens:
    one kernel launch and one allocation, the contiguous (B, S, H, D)
    output (K and V are never repeated or copied); where the profiler
    records the call, it sees that one kernel."""
    rng = np.random.default_rng(d)
    h = 16 if ratio == 2 else 32
    q, k, v = _gqa_qkv(rng, 2, 8, h, h // ratio, d, torch.bfloat16,
                       fused=False, q_scale=1.0, device=cuda)
    tfk.mha_flash(q, k, v, causal=True)          # loads the library
    torch.cuda.synchronize()
    n0 = tfk.launches
    allocs0 = torch.cuda.memory_stats()["allocation.all.allocated"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        o = tfk.mha_flash(q, k, v, causal=True, window=4096, softcap=50.0)
        torch.cuda.synchronize()
    assert tfk.launches == n0 + 1
    assert torch.cuda.memory_stats()["allocation.all.allocated"] \
        == allocs0 + 1
    assert o.shape == q.shape and o.is_contiguous()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0)) > 0]
    if kernels:
        assert [e.count for e in kernels] == [1]
        assert "flash_attention" in kernels[0].key


STAT_THRESHOLDS = (0, 1 << 10, -1, 2 ** 31 - 1)


def _stat_inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    aq = torch.from_numpy(_int8(rng, (m, k)))
    bq = torch.from_numpy(_int8(rng, (k, n)))
    fl = _flips(rng, (m, n), p=0.02)
    fl[3, 5] = np.uint32(1 << 31)
    fl[m - 1, n - 1] = np.uint32(1 << 20)
    return aq, bq, torch.from_numpy(fl.view(np.int32))


def _stat_check(aq, bq, flips, bn, thresholds=STAT_THRESHOLDS):
    """One launch a call, both outputs ``torch.equal`` to the plain
    version at every threshold."""
    bm = 32 if aq.shape[0] % bn else bn
    for thr in thresholds:
        n0, a0 = stat_abft.launches, tak.launches
        got = stat_abft.stat_abft_matmul(aq, bq, flips, thr, bm=bm, bn=bn)
        torch.cuda.synchronize()
        assert (stat_abft.launches, tak.launches) == (n0 + 1, a0)
        want = stat_abft.stat_abft_matmul_plain(aq, bq, flips, thr, bm=bm,
                                                bn=bn)
        assert torch.equal(got[0], want[0]), (thr, "c")
        assert torch.equal(got[1], want[1]), (thr, "detected")


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(128, 96, 256), (32, 96, 256),
                                   (96, 50, 384), (32, 50, 128),
                                   (2048, 1152, 1152), (2048, 1152, 4608),
                                   (2048, 4608, 1152)])
@pytest.mark.parametrize("blk", stat_abft.BN_TAKEN)
def test_stat_abft_matmul_matches_plain_on_card(cuda, m, k, n, blk):
    """The wgmma kernel at the DiT's body shapes, fewer rows than a CTA
    (32, 96), K % 16 != 0 (50, zero-padded), every row tile it takes and
    the thresholds 0, 1 << 10, -1 and 2^31 - 1, with a bit-31 flip."""
    aq, bq, flips = (t.to(cuda) for t in _stat_inputs(m, k, n, m + k + n))
    _stat_check(aq, bq, flips, blk)


@pytest.mark.gpu
@pytest.mark.parametrize("k,n,offset", [(50, 384, 0), (1152, 4608, 0),
                                        (96, 256, 3)])
def test_stat_abft_transpose_matches_plain_on_card(cuda, k, n, offset):
    """The library's transpose of B to K-major, zero-padded to Kp, equal
    to ``k_major_plain``; an operand off 16 bytes is copied first."""
    rng = np.random.default_rng(k + n)
    flat = torch.from_numpy(_int8(rng, (k * n + offset,))).to(cuda)
    bq = flat[offset:].view(k, n)
    kp = stat_abft.launch_args(bq.new_zeros((32, k)), bq, 32)[2]
    got = stat_abft._k_major(bq, kp)
    torch.cuda.synchronize()
    assert torch.equal(got, stat_abft.k_major_plain(bq, kp))


@pytest.mark.gpu
def test_stat_abft_matmul_wraps_at_k4608_on_card(cuda):
    """Extreme +-127 operands at K = 4608, mostly +127: the row sums pass
    2^31 and wrap mod 2^32."""
    rng = np.random.default_rng(7)
    pm = np.array([-127, 127], np.int8)
    a = rng.choice(pm, size=(64, 4608), p=[0.1, 0.9])
    b = rng.choice(pm, size=(4608, 256), p=[0.1, 0.9])
    sums = (a.astype(np.int64) @ b.astype(np.int64)).reshape(64, 2, 128)
    assert np.abs(sums.sum(2)).max() >= 2 ** 31
    _, _, flips = _stat_inputs(64, 4608, 256, 7)
    _stat_check(torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda),
                flips.to(cuda), 128)


@pytest.mark.gpu
def test_stat_abft_matmul_is_one_kernel_on_card(cuda):
    """The profiler sees the kernel and the copy of B to K-major, and no
    ``abft_matmul``."""
    aq, bq, flips = (t.to(cuda) for t in _stat_inputs(256, 1152, 384, 3))
    stat_abft.stat_abft_matmul(aq, bq, flips, 0)         # loads the library
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        stat_abft.stat_abft_matmul(aq, bq, flips, 1 << 10)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0)) > 0]
    if names:
        assert sum("stat_abft_kernel" in nm for nm in names) == 1, names
        assert not any("abft_matmul" in nm for nm in names), names
        assert len(names) <= 2, names


@pytest.mark.gpu
@pytest.mark.parametrize("bn", [96, 160, 256, 384])
def test_stat_abft_matmul_takes_every_row_tile_on_card(cuda, bn):
    """A row tile without an instance of its own: the 32-wide instance's
    residuals, summed in groups of bn / 32 and thresholded by a second
    launch, ``torch.equal`` to the plain version at every threshold."""
    aq, bq, flips = (t.to(cuda) for t in _stat_inputs(64, 1152, 3840, bn))
    _stat_check(aq, bq, flips, bn)


@pytest.mark.gpu
def test_drift_gemm_matches_plain_on_card(cuda):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((70, 50)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((50, 90)).astype(np.float32))
    ck = torch.from_numpy(rng.standard_normal((70, 90)).astype(np.float32))
    fl = _flips(rng, ops.padded_shape(70, 90), p=0.05)
    flips = torch.from_numpy(fl.view(np.int32))
    args = [t.to(cuda) for t in (x, w, ck, flips)]
    n0 = ops.launches
    got = ops.drift_gemm(*args)
    assert ops.launches == n0 + 1
    want = ops.drift_gemm_plain(*args)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    assert int(got.n_flagged_tiles) > 0


# (M, K, N) unpadded: the DiT's body GEMMs, its patch (K = 16), final
# (N = 16) and t.w1 (M = 2) GEMMs, PixArt's M = 240 and the UNet's M = 154
# text GEMMs, DriftDecode's one-tile shapes (olmo-1b's gate/up and down
# at bucket 2: split K, B read in place), both sides of the split-K
# boundary (M = 64 and 65), and three
# ragged ones (K % 16 != 0 and N % 4 != 0: the word-by-word path; a
# ragged M and N on the vector path; K % 16 != 0 and N % 16 != 0 on the
# vector path, B transposed byte by byte)
FUSED_SHAPES = [(2048, 1152, 1152), (2048, 1152, 4608), (2048, 4608, 1152),
                (2048, 16, 1152), (2048, 1152, 16), (2, 256, 1152),
                (240, 4096, 1152), (154, 768, 640), (2, 2048, 8192),
                (2, 8192, 2048), (64, 2048, 2048), (65, 2048, 2048),
                (70, 50, 90), (45, 96, 100), (100, 40, 84)]


@pytest.mark.gpu
@pytest.mark.parametrize("with_ckpt", [True, False])
@pytest.mark.parametrize("union", [True, False])
@pytest.mark.parametrize("ber", [0.0, 3e-3])
@pytest.mark.parametrize("m,k,n", FUSED_SHAPES)
def test_drift_gemm_fused_matches_plain_on_card(cuda, m, k, n, ber, union,
                                                with_ckpt):
    """One launch; out (on its int32 view), the checksum differences and
    the tile counts ``torch.equal`` to the plain version, with flips over
    the unpadded region (BER 3e-3 plus a bit-31 flip) or none (BER 0)."""
    rng = np.random.default_rng(m + k + n)
    aq = torch.from_numpy(_int8(rng, (m, k))).to(cuda)
    bq = torch.from_numpy(_int8(rng, (k, n))).to(cuda)
    flips = None
    if ber:
        fl = _flips(rng, (m, n), p=ber)
        fl[m // 2, n // 3] = np.uint32(1 << 31)
        flips = torch.from_numpy(fl.view(np.int32)).to(cuda)
    sx = torch.tensor(rng.uniform(1e-3, 1e-2), dtype=torch.float32,
                      device=cuda)
    sw = torch.from_numpy(rng.uniform(1e-3, 1e-2, n).astype(np.float32)
                          ).to(cuda)
    ck = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)
                          ).to(cuda) if with_ckpt else None
    args = (aq, bq, flips, sx, sw, ck, 1 << 10)
    n0 = ops.launches
    got = ops.drift_gemm_fused(*args, union=union, valid=(m, n))
    torch.cuda.synchronize()
    assert ops.launches == n0 + 1
    want = ops.drift_gemm_fused_plain(*args, union=union, valid=(m, n))
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    for label, g, w_ in zip(("row_diff", "col_diff", "tile_count"), got[1:],
                            want[1:]):
        assert torch.equal(g, w_), label
    assert (int(got[3].sum()) > 0) == bool(ber)


@pytest.mark.gpu
def test_drift_gemm_fused_flips_over_the_padded_grid_on_card(cuda):
    """Flips over the padded (Mp, Np) grid, some in the padding (which
    flag rows and columns inside), counted over the whole grid: all four
    outputs ``torch.equal`` to the plain version, on both paths and
    through split K."""
    for m, k, n in ((70, 50, 90), (45, 96, 100), (2, 2048, 200)):
        rng = np.random.default_rng(m)
        mp, np_ = ops.padded_shape(m, n)
        aq = torch.from_numpy(_int8(rng, (m, k))).to(cuda)
        bq = torch.from_numpy(_int8(rng, (k, n))).to(cuda)
        fl = _flips(rng, (mp, np_), p=0.03)
        fl[mp - 1, 3] = np.uint32(1 << 22)
        args = (aq, bq, torch.from_numpy(fl.view(np.int32)).to(cuda),
                torch.tensor(0.004, device=cuda), torch.ones(n, device=cuda),
                torch.randn((m, n), device=cuda), 1 << 10)
        got = ops.drift_gemm_fused(*args)
        want = ops.drift_gemm_fused_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32))
        for g, w_ in zip(got[1:], want[1:]):
            assert torch.equal(g, w_)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(256, 1152, 384), (2, 2048, 2048),
                                   (2, 2048, 200)])
def test_drift_gemm_fused_is_transpose_and_kernel_on_card(cuda, m, k, n):
    """One call runs the GEMM kernel once, after one transpose of B where
    it does not read B in place (M > 64, or N % 16 != 0), with split K
    (M = 2) as without; it counts one launch, and calls in a row stay
    equal to the plain version (the split's tile counters are left
    zero)."""
    rng = np.random.default_rng(m)
    args = (torch.from_numpy(_int8(rng, (m, k))).to(cuda),
            torch.from_numpy(_int8(rng, (k, n))).to(cuda),
            torch.from_numpy(_flips(rng, (m, n), p=0.01).view(np.int32)
                             ).to(cuda),
            torch.tensor(0.004, device=cuda), torch.ones(n, device=cuda),
            torch.randn((m, n), device=cuda), 1 << 10)
    want = ops.drift_gemm_fused_plain(*args)
    ops.drift_gemm_fused(*args)                     # loads the library
    torch.cuda.synchronize()
    n0 = ops.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = [ops.drift_gemm_fused(*args) for _ in range(3)]
        torch.cuda.synchronize()
    assert ops.launches == n0 + 3
    for out in got:
        for g, w_ in zip(out, want):
            assert torch.equal(g.view(torch.int32), w_.view(torch.int32))
    counts = {e.key: e.count for e in prof.key_averages()
              if getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0)) > 0}
    in_place = ops.reads_b_in_place(m, args[1])
    assert in_place == (m <= 64 and n % 16 == 0)
    if counts:
        assert sorted(counts.values()) == [3] * (1 if in_place else 2), counts
        assert sum("drift_gemm_kernel" in nm for nm in counts) == 1, counts
        assert sum("transpose_kernel" in nm for nm in counts) == (
            0 if in_place else 1), counts


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["union", "cross"])
def test_drift_context_launches_the_fused_kernel_on_card(cuda, policy):
    """A drift ``ExecContext`` GEMM on the card launches ``drift_gemm_fused``
    once and neither ``abft_matmul`` nor ``rollback_correct``; its output,
    statistics and refreshed checkpoint equal, bit for bit, the sequence
    it replaced run on the card (padded operands and mask, the ABFT
    kernel, dequantize, the int64 differences, the rollback kernel)."""
    from repro_torch.core import abft, fault, quant
    from repro_torch.core.dvfs import CLASS_BODY, N_CLASSES
    from repro_torch.core.exec_ctx import DriftSystemConfig, ExecContext
    rng = np.random.default_rng(7)
    m, k, n = 300, 1152, 640
    x, w, ck = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                 ).to(cuda)
                for s in ((m, k), (k, n), (m, n)))
    bers = np.zeros((N_CLASSES,), np.float32)
    bers[CLASS_BODY] = 3e-3
    src = fault.PhiloxFlipSource(3, 0, cuda)
    cfg = DriftSystemConfig(mode="drift",
                            abft=abft.AbftConfig(mask_policy=policy))
    ctx = ExecContext(cfg, flip_source=src, step=0, ber_by_class=bers,
                      state_in={"g": ck.clone()}, have_ckpt=True)
    n0 = (tak.launches, trk.launches, ops.launches)
    y = ctx.matmul(x, w, name="g")
    torch.cuda.synchronize()
    assert (tak.launches - n0[0], trk.launches - n0[1],
            ops.launches - n0[2]) == (0, 0, 1)

    mp, np_ = ops.padded_shape(m, n)
    xq, wq = quant.quantize(x, axis=None), quant.quantize(w, axis=1)
    flips = ops._pad2(src(fault.FaultSite(0, 0, "g"), (m, n), 3e-3), mp,
                      np_)
    c, ar, er, ac, ec = tak.abft_matmul(ops._pad2(xq.q, mp, k),
                                        ops._pad2(wq.q, k, np_), flips)
    y0 = quant.dequantize_matmul(c[:m, :n], xq.scale,
                                 wq.scale.reshape(1, -1))
    rd = abft.wrap_i32(ar.long() - er.long())
    cd = abft.wrap_i32(ac.long() - ec.long())
    want, count = trk.rollback_correct(
        ops._pad2(y0, mp, np_), ops._pad2(ck, mp, np_), rd, cd, 1 << 10,
        union=policy == "union", valid=(m, n))
    want = want[:m, :n]
    full_row = abft.wrap_i32(rd.long().sum(1))[:m]
    assert torch.equal(y.view(torch.int32), want.view(torch.int32))
    assert torch.equal(ctx.state_in["g"], want)
    st = ctx.stats
    assert int(st["detected_row_errors"]) == int(
        abft._exceeds(full_row, 1 << 10).sum())
    assert int(st["corrected_elems"]) == int(count.sum()) > 0
    assert float(st["extra_dram_bytes"]) == float(
        (count > 0).float().sum() * 4096)
    assert st["gemm_words"] == m * n and st["extra_compute_flops"] == 0.0


# --------------------------------------------------------------- offload
def _stores(cuda, seed=0):
    """A DiT-shaped store, 56 MB: an (L, rows, N) block leaf, a tile-padded
    embedding leaf and a 1-D leaf."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    return ({"t.w1": torch.randn((2, 1152), generator=g, device=cuda),
             "bias": torch.randn((37,), generator=g, device=cuda)},
            {"mlp.w1": torch.randn((3, 1024, 4608), generator=g,
                                   device=cuda)})


def _carry(stores):
    mon = type("Monitor", (), {"ema_ber": 0.0})()
    return (None, stores, None, mon, None, None)


@pytest.mark.gpu
def test_offload_survives_an_overwrite_right_after_commit(cuda):
    """The next refresh step overwrites the live store in place on the
    main stream right after the commit returns; the snapshot still holds
    the values at the commit, because the repack ran on the main stream
    before the overwrite and the copy reads the staging buffer."""
    stores = _stores(cuda)
    want = tree_map(torch.clone, stores)
    s = OffloadStore(OffloadConfig())
    s.begin_batch(interval=1, batch_index=0)
    s.on_window(1, _carry(stores))
    for _ in range(4):
        tree_map(lambda t: t.mul_(-3.0).add_(1.0), stores)
    assert s.finish_batch().commits == 1
    for got, ref in zip(tree_leaves(s.restore()), tree_leaves(want)):
        assert got.is_cuda and torch.equal(got, ref)
    ms = s.commit_ms[-1]
    assert len(s.commit_ms) == 1 and ms[0] > 0 and ms[1] > 0


@pytest.mark.gpu
def test_offload_reuses_its_pinned_buffers_on_a_side_stream(cuda):
    s = OffloadStore(OffloadConfig())
    host_ids = []
    for batch in range(2):
        stores = _stores(cuda, seed=batch)
        s.begin_batch(interval=1, batch_index=batch)
        s.on_window(1, _carry(stores))
        s.on_window(2, _carry(stores))
        assert s.finish_batch().commits == 2
        host_ids.append([id(h) for hs in s._host_sets for h in hs])
        assert all(h.is_pinned() for hs in s._host_sets for h in hs)
        for got, ref in zip(tree_leaves(s.restore()), tree_leaves(stores)):
            assert torch.equal(got, ref)
    assert host_ids[0] == host_ids[1] and len(host_ids[0]) == 6
    assert s._side is not None
    assert s._side != torch.cuda.current_stream(cuda)
    assert s.pinned_alloc_s > 0 and len(s.commit_ms) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("async_commit", [True, False])
@pytest.mark.parametrize("repacked", [True, False])
def test_offload_restore_is_bit_equal_on_card(cuda, repacked, async_commit):
    stores = _stores(cuda, seed=3)
    s = OffloadStore(OffloadConfig(repacked=repacked,
                                   async_commit=async_commit))
    s.begin_batch(interval=2, batch_index=0)
    s.on_window(2, _carry(stores))
    if not async_commit:
        assert s._flight is None and s.stats.commits == 1
    assert s.finish_batch().commits == 1 and s.committed_step == 0
    restored = s.restore()
    for got, ref in zip(tree_leaves(restored), tree_leaves(stores)):
        assert got.shape == ref.shape and torch.equal(got, ref)


@pytest.mark.gpu
def test_events_drain_with_offload_on_card_matches_run(cuda):
    """The SMOKE DiT with offload on, drained through the HTTP front
    end's /events on the handler's thread: the offload store records its
    events on the stream current in that thread, and every final equals
    ``run()``'s on a twin engine bit for bit; each settled commit is an
    offload_commit span carrying the CUDA events' time."""
    import json
    import urllib.request

    from repro_torch.serving import DriftServeEngine, serve_telemetry
    from repro_torch.serving.telemetry.http import latents_sha256

    def engine():
        return DriftServeEngine(arch="dit-xl-512", smoke=True, bucket=2,
                                base_seed=4, device="cuda",
                                offload=OffloadConfig())
    want, got = engine(), engine()
    for eng in (want, got):
        for s in (0, 1, 2):
            eng.submit(steps=4, mode="drift", op="undervolt", seed=s,
                       rollback_interval=2)
    ref = {r.request_id: latents_sha256(r.latents) for r in want.run()}
    server = serve_telemetry(got, port=0)
    try:
        with urllib.request.urlopen(server.url + "/events?interval=2",
                                    timeout=300) as resp:
            body = resp.read().decode()
    finally:
        server.close()
    results = {}
    for line in body.splitlines():
        if line.startswith("data: ") and '"latents_sha256"' in line:
            d = json.loads(line[len("data: "):])
            if "mode" in d:
                results[d["request_id"]] = d["latents_sha256"]
    assert results == ref and len(ref) == 3
    commits = [s for s in got.tracer.spans() if s.kind == "offload_commit"]
    assert len(commits) == got.offload_store.stats.commits == 4
    assert all(s.t1_wall_s > s.t0_wall_s and s.attrs["nbytes"] > 0
               for s in commits)


# ------------------------------------------------- LM weights, MoE routing
def _weight_leaves(w):
    """{path: tensor} over a ``transformer.Weights``, ``Proj`` fields
    included."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}.{k}")
        elif isinstance(t, transformer.Proj):
            for f in t._fields:
                out[f"{path}.{f}"] = getattr(t, f)
        elif t is not None:
            out[path] = t
    for name in ("embed", "lm_head", "final_norm"):
        walk(getattr(w, name), name)
    for i, lp in enumerate(w.layers):
        walk(lp, f"layers.{i}")
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma2-9b", "deepseek-moe-16b",
                                  "kimi-k2-1t-a32b", "mamba2-370m",
                                  "hymba-1.5b"])
def test_init_weights_on_card_equals_prepared_init_params(cuda, arch):
    """Drawn on the card, ``init_weights`` is ``prepare(init_params(...))``
    bit for bit for a bf16 SMOKE config: the generator's draws do not
    depend on the f32 masters being kept."""
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              dtype=torch.bfloat16)
    want = _weight_leaves(transformer.prepare(
        cfg, transformer.init_params(cfg, 11, cuda)))
    got = _weight_leaves(transformer.init_weights(cfg, 11, cuda))
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        assert g.device.type == "cuda" and g.dtype == want[k].dtype, k
        assert torch.equal(g, want[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "kimi-k2-1t-a32b"])
def test_moe_ffn_on_card_matches_cpu(cuda, arch):
    """The SMOKE MoE FFN at 256 tokens with capacity factor 0.5 (tokens
    drop) and a zero row (its probabilities all tie): routing integers
    equal to the CPU's, ties to the lowest expert ids, ``y`` within 1e-5,
    and two card runs bit-equal (the combine adds in a fixed order)."""
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              capacity_factor=0.5)
    p = moe.init_moe_params(cfg, torch.Generator().manual_seed(3))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (256, cfg.d_model)).astype(np.float32))
    x[3] = 0.0
    pc = {k: (v.to(cuda) if not isinstance(v, dict)
              else {n: w.to(cuda) for n, w in v.items()})
          for k, v in p.items()}
    want = moe.route(cfg, p["router"], x)
    got = moe.route(cfg, pc["router"], x.to(cuda))
    for f in ("flat_e", "rank", "keep", "slot"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert int((~got.keep).sum()) > 0
    k = cfg.top_k
    assert got.flat_e[3 * k:4 * k].tolist() == list(range(k))
    y, aux = moe.moe_ffn(cfg, pc, x.to(cuda))
    y2, _ = moe.moe_ffn(cfg, pc, x.to(cuda))
    assert torch.equal(y, y2)
    y_cpu, aux_cpu = moe.moe_ffn(cfg, p, x)
    torch.testing.assert_close(y.cpu(), y_cpu, atol=1e-5, rtol=0)
    assert abs(float(aux) - float(aux_cpu)) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_ssd_on_card_matches_cpu(cuda, arch):
    """The SMOKE SSD block on the card against the CPU, f32: ``ssd_forward``
    over 21 tokens (three chunks of 8, the last padded) with its state,
    then one ``ssd_decode_step`` from that state, outputs and states within
    1e-5; the state handed to the decode step is left as it was."""
    cfg = configs.get_config(arch, smoke=True)
    p = mamba2.init_ssm_params(cfg, torch.Generator().manual_seed(4))
    rng = np.random.default_rng(6)
    p = {k: v + torch.from_numpy(
        0.1 * rng.standard_normal(tuple(v.shape)).astype(np.float32))
        for k, v in p.items()}
    x = torch.from_numpy(rng.standard_normal(
        (2, 22, cfg.d_model)).astype(np.float32))
    pc = {k: v.to(cuda) for k, v in p.items()}
    out = {}
    for dev, params in (("cuda", pc), ("cpu", p)):
        xd = x.to(dev)
        y, st = mamba2.ssd_forward(cfg, params, xd[:, :21],
                                   return_state=True)
        h0 = st.h.clone()
        y1, st1 = mamba2.ssd_decode_step(cfg, params, xd[:, 21:], st)
        assert torch.equal(st.h, h0)
        out[dev] = [t.cpu() for t in (y, st.h, st.conv, y1, st1.h,
                                      st1.conv)]
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,dtype,tol", [(2, 1500, torch.bfloat16, 3e-3),
                                           (1, 1000, torch.bfloat16, 3e-3),
                                           (1, 1000, torch.float32, 2e-5)])
def test_flash_partial_last_tile_matches_plain_on_card(cuda, b, s, dtype,
                                                       tol, causal):
    """whisper-base's encoder length, 1500 (and 1000): many whole tiles,
    then a partial last one, at 8 heads of 64; one launch, a finite
    output. bf16 on views of one fused projection within 3e-3 absolute
    (3x the 0.00098 the encoder's call reads on an H100) plus one bf16
    ulp relative (2^-7: both sides round their output to bf16, and a
    causal row's first outputs average a few values of size ~1); f32
    within 2e-5.
    The limit tells the plain version apart from the same call with the
    partial tile's keys (28 and 40 of the bf16 kernel's 64-key tiles)
    dropped, so a kernel that lost or mis-masked them fails."""
    rng = np.random.default_rng(s + int(causal))
    q, k, v = _gqa_qkv(rng, b, s, 8, 8, 64, dtype,
                       fused=dtype == torch.bfloat16, q_scale=1.0,
                       device=cuda)
    n0 = tfk.launches
    got = tfk.mha_flash(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfk.launches == n0 + 1 and bool(torch.isfinite(got).all())
    want = full_attention(q, k, v, causal=causal)
    rtol = 2 ** -7 if dtype == torch.bfloat16 else tol
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=rtol)
    keep = s - s % 64
    dropped = full_attention(q, k[:, :keep], v[:, :keep], causal=causal)
    assert not torch.allclose(dropped.float(), want.float(), atol=tol,
                              rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,window,softcap", [(4, 4, 0, 0.0),
                                                  (8, 2, 0, 0.0),
                                                  (8, 4, 5, 0.0),
                                                  (8, 4, 0, 20.0),
                                                  (16, 16, 7, 30.0)])
def test_mha_flash_gradients_on_card(cuda, dtype, h, hkv, window, softcap):
    """Gradients through the card's ``mha_flash`` (causal; GQA, a window,
    a softcap): the output carries a ``grad_fn``, one backward call is
    counted, and q, k and v (each a view of one fused projection, which
    requires grad) get the gradients of the plain ``full_attention`` on
    the same inputs within 1e-6 (f32) and 1e-2 (bf16): the backward is
    that plain version, recomputed."""
    rng = np.random.default_rng(h * 100 + hkv * 10 + window)
    s, d = 37, 64
    x0 = torch.from_numpy(rng.standard_normal(
        (2, s, h + 2 * hkv, d)).astype(np.float32)).to(cuda, dtype)
    go = torch.from_numpy(rng.standard_normal(
        (2, s, h, d)).astype(np.float32)).to(cuda, dtype)
    grads = []
    for fn in (tfk.mha_flash, None):
        x = x0.clone().requires_grad_(True)
        q, k, v = x[:, :, :h], x[:, :, h:h + hkv], x[:, :, h + hkv:]
        if fn is None:
            o = full_attention(q, k, v, causal=True, window=window,
                               attn_softcap=softcap)
        else:
            n0, b0 = tfk.launches, tfk.backward_calls
            o = fn(q, k, v, causal=True, window=window, softcap=softcap)
            assert o.grad_fn is not None and tfk.launches == n0 + 1
        o.backward(go)
        if fn is not None:
            assert tfk.backward_calls == b0 + 1
        grads.append(x.grad.float())
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(grads[0], grads[1], atol=tol, rtol=tol)
    assert float(grads[0].abs().max()) > 0


@pytest.mark.gpu
def test_flash_attention_no_grad_launch_keeps_no_graph(cuda):
    """Under ``torch.no_grad`` (serving) and on inputs that need no
    gradient, the launch records no graph: no ``grad_fn``; the
    ``(BH, S, D)`` entry point differentiates too."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (3, 40, 32)).astype(np.float32)).to(cuda) for _ in range(3))
    assert tfk.flash_attention(q, k, v, causal=True).grad_fn is None
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        assert tfk.flash_attention(qg, k, v).grad_fn is None
    o = tfk.flash_attention(qg, k, v, causal=True)
    assert o.grad_fn is not None
    o.sum().backward()
    ref = q.clone().requires_grad_(True)
    tfk.flash_attention_plain(ref, k, v, causal=True).sum().backward()
    torch.testing.assert_close(qg.grad, ref.grad, atol=1e-6, rtol=1e-6)


@pytest.mark.gpu
def test_train_launcher_resumes_on_card(cuda, tmp_path, capsys):
    """``python -m repro_torch.launch.train`` on the card (SMOKE olmo-1b):
    6 steps saving at 2, 4 and 6 into one ``--ckpt-dir``; with step 6's
    checkpoint removed, a second run resumes from 4 and ends bit-equal to
    the first, its params on the card."""
    ck = tmp_path / "ck"
    argv = ["--arch", "olmo-1b", "--device", "cuda", "--steps", "6",
            "--global-batch", "2", "--seq", "16", "--ckpt-every", "2",
            "--log-every", "1", "--ckpt-dir", str(ck)]
    straight = train_cli.main(argv)
    assert "[ckpt] saved step 6" in capsys.readouterr().out
    shutil.rmtree(ck / "step_00000006")
    resumed = train_cli.main(argv)
    assert "[train] resumed from step 4" in capsys.readouterr().out
    assert resumed.step == straight.step == 6
    assert all(t.device.type == "cuda"
               for t in tree_leaves(resumed.params))
    for a, b in zip(tree_leaves(resumed), tree_leaves(straight)):
        assert (a == b) if not isinstance(a, torch.Tensor) \
            else torch.equal(a, b)


# ----------------------------------------- decode paths and sharding
@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-moe-16b",
                                  "hymba-1.5b"])
def test_drift_decode_on_card_matches_cpu(cuda, arch):
    """SMOKE ``DriftDecode`` on the card and the CPU, the same params and
    masks (drawn on the CPU): 3 steps at BER 1e-2 (layer 0 at 0), refresh
    interval 2. Each layer's detected rows and corrected elements equal,
    greedy tokens equal, logits and the store within 1e-4; every
    protected projection launched the fused drift kernel once, and
    neither ``abft_matmul`` nor ``rollback_correct``."""
    from repro_torch.core import fault
    from repro_torch.core.exec_ctx import DriftSystemConfig
    from repro_torch.core.rollback import RollbackConfig
    cfg = configs.get_config(arch, smoke=True)
    params = transformer.init_params(cfg, 8)
    prompts = torch.randint(0, cfg.vocab, (2, 8),
                            generator=torch.Generator().manual_seed(2))
    row = np.array([0.0, 1e-2, 1e-2], np.float32)
    dcfg = DriftSystemConfig(mode="drift",
                             rollback=RollbackConfig(interval=2))
    base = transformer.ExecContext
    out = {}
    for dev in (cuda, torch.device("cpu")):
        ctxs = []

        class Recording(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                ctxs.append(self)
        w = transformer.prepare(cfg, tree_map(lambda t: t.to(dev), params))
        store = transformer.drift_store_spec(cfg, 2, dev)
        src = fault.PhiloxFlipSource(5, 0, "cpu")
        logits, cache = transformer.prefill(cfg, w, prompts.to(dev), 12)
        tok = logits[:, -1:].argmax(-1)
        steps = []
        n0 = (tak.launches, trk.launches, ops.launches)
        transformer.ExecContext = Recording
        try:
            for step in range(3):
                ctxs.clear()
                logits, cache, store = transformer.decode_step(
                    cfg, w, cache, tok,
                    transformer.DriftDecode(dcfg, src, row, store, step))
                tok = logits[:, -1:].argmax(-1)
                steps.append((logits.cpu(), tok.cpu(),
                              [(int(c.stats["detected_row_errors"]),
                                int(c.stats["corrected_elems"]))
                               for c in ctxs]))
        finally:
            transformer.ExecContext = base
        launched = (tak.launches - n0[0], trk.launches - n0[1],
                    ops.launches - n0[2])
        out[dev.type] = (steps, {k: v.cpu() for k, v in store.items()},
                         launched)
    gemms = cfg.n_layers * (4 if cfg.family == "moe" else 7)
    assert out["cuda"][2] == (0, 0, 3 * gemms)
    assert out["cpu"][2] == (0, 0, 0)
    flagged = 0
    for (lg, tg, cg), (lc, tc, cc) in zip(out["cuda"][0], out["cpu"][0]):
        torch.testing.assert_close(lg, lc, atol=1e-4, rtol=0)
        assert torch.equal(tg, tc) and cg == cc
        flagged += sum(c for _, c in cc)
    assert flagged > 0
    for k, v in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], v, atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma3-27b"])
def test_mixed_decode_on_card_matches_decode_step(cuda, arch):
    """SMOKE ``decode_step_mixed`` on the card past the ring's wrap
    (prompt window + 6, 6 steps): logits bit-equal to the card's
    ``decode_step`` on the full cache (the rings are read oldest first)
    and within 1e-4 of the CPU's mixed decode."""
    cfg = configs.get_config(arch, smoke=True)
    params = transformer.init_params(cfg, 5)
    g = torch.Generator().manual_seed(9)
    s = cfg.window + 6
    prompts = torch.randint(0, cfg.vocab, (2, s), generator=g)
    toks = torch.randint(0, cfg.vocab, (6, 2, 1), generator=g)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        w = transformer.prepare(cfg, tree_map(lambda t: t.to(dev), params))
        _, full = transformer.prefill(cfg, w, prompts.to(dev), s + 6)
        mixed = transformer.mixed_from_full(cfg, full)
        rows = []
        for t in toks:
            lf, full, _ = transformer.decode_step(cfg, w, full, t.to(dev))
            lm, mixed = transformer.decode_step_mixed(cfg, w, mixed,
                                                      t.to(dev))
            rows.append((lf.cpu(), lm.cpu()))
        runs[dev.type] = rows
    for (lf, lm), (_, lm_cpu) in zip(runs["cuda"], runs["cpu"]):
        assert torch.equal(lm, lf)
        torch.testing.assert_close(lm, lm_cpu, atol=1e-4, rtol=0)


SHARDED_BUCKET = 4


def _card_dit_params():
    """SMOKE DiT params with seeded values in every all-zero weight
    (adaLN-Zero, the output), on the CPU."""
    from repro_torch.models import dit
    cfg = configs.get_config("dit-xl-512", smoke=True)
    g = torch.Generator()
    g.manual_seed(17)

    def nudge(t):
        if t.ndim >= 2 and not bool(t.any()):
            return 0.05 * torch.randn(t.shape, generator=g)
        return t
    return tree_map(nudge, dit.init_params(cfg, 3))


def _serve_card_dit(eng):
    eng.set_params("dit-xl-512", True,
                   tree_map(lambda t: t.to("cuda"), _card_dit_params()))
    for i in range(SHARDED_BUCKET):
        eng.submit(steps=3, mode="drift", op="undervolt", seed=i)
    res = eng.run()
    return dict(latents=[r.latents.cpu() for r in res],
                counts=[(r.batch_corrected_elems, r.energy_j,
                         r.monitor_op_index) for r in res],
                monitor=(int(eng.monitor.n_updates),
                         float(eng.monitor.ema_ber)))


def _card_rank(rank: int, model_parallel: int, tmp: str) -> None:
    """One of 2 ranks sharing cuda:0 over gloo (a spawned process)."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serving.sharded import ShardedDriftServeEngine
    mesh = mesh_lib.make_serving_mesh(
        model_parallel, device="cuda", init_method=f"file://{tmp}/rdzv",
        rank=rank, world_size=2, timeout_s=300)
    out = _serve_card_dit(ShardedDriftServeEngine(
        mesh=mesh, bucket=SHARDED_BUCKET, device="cuda"))
    out["backend"] = mesh.backend
    torch.save(out, f"{tmp}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("model_parallel", [1, 2])
def test_sharded_dit_on_card_bit_equal(cuda, tmp_path, model_parallel):
    """The SMOKE DiT (bucket 4, 3 drift steps) on 2 ranks sharing cuda:0
    over gloo, as a (2, 1) and a (1, 2) mesh: every rank's latents,
    corrected counts, billed joules and monitor equal one process's."""
    from repro_torch.serving import DriftServeEngine
    import torch.multiprocessing as mp
    want = _serve_card_dit(DriftServeEngine(bucket=SHARDED_BUCKET,
                                            device="cuda"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_card_rank,
                         args=(r, model_parallel, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(300)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert [p.exitcode for p in procs] == [0, 0]
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        assert got["backend"] == "gloo"
        assert got["counts"] == want["counts"]
        assert got["monitor"] == want["monitor"]
        for a, b in zip(got["latents"], want["latents"]):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _serve_card_moe(eng):
    """SMOKE deepseek-moe-16b, 2 requests at bucket 2, 6 tokens, window
    3, stat_abft then faulty: every result whole, and the monitor."""
    out = []
    for mode in ("stat_abft", "faulty"):
        for i in range(2):
            eng.submit(steps=6, mode=mode, op="undervolt", seed=i,
                       rollback_interval=3)
        out += [dataclasses.asdict(r) for r in eng.run()]
    return dict(results=out, monitor=(int(eng.monitor.n_updates),
                                      int(eng.monitor.op_index),
                                      float(eng.monitor.ema_ber)))


def _card_moe_rank(rank: int, tmp: str) -> None:
    """One of 2 ranks sharing cuda:0 over gloo on a (data 1, model 2)
    mesh: the SMOKE MoE LM served (a spawned process)."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serving.sharded import ShardedDriftServeEngine
    mesh = mesh_lib.make_serving_mesh(
        2, device="cuda", init_method=f"file://{tmp}/rdzv", rank=rank,
        world_size=2, timeout_s=300)
    out = _serve_card_moe(ShardedDriftServeEngine(
        mesh=mesh, arch="deepseek-moe-16b", bucket=2, device="cuda"))
    out.update(backend=mesh.backend, mesh=dict(mesh.shape),
               collectives=mesh.collectives)
    torch.save(out, f"{tmp}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


@pytest.mark.gpu
def test_sharded_moe_lm_on_card_equal(cuda, tmp_path):
    """SMOKE deepseek-moe-16b (its expert stacks split on the model axis
    at rest, gathered at each layer) served on 2 ranks sharing cuda:0
    over gloo as a (1, 2) mesh: every rank's results, field for field
    (tokens, detections, rollbacks, evaluations, joules, ledgers), and
    its monitor equal one process's on the card."""
    from repro_torch.serving import DriftServeEngine
    import torch.multiprocessing as mp
    want = _serve_card_moe(DriftServeEngine(arch="deepseek-moe-16b",
                                            bucket=2, device="cuda"))
    assert all(r["ar_detections"] > 0 and r["ar_rollbacks"] >= 1
               and r["token_match_vs_clean"] == 1.0
               for r in want["results"] if r["mode"] == "stat_abft")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_card_moe_rank, args=(r, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(300)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert [p.exitcode for p in procs] == [0, 0]
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        assert (got.pop("backend"), got.pop("mesh")) == (
            "gloo", {"data": 1, "model": 2})
        assert got.pop("collectives") > 0
        assert got == want


def _card_train_rank(rank: int, tmp: str) -> None:
    """One of 2 ranks sharing cuda:0 over gloo on a (data 1, model 2)
    mesh: 2 AdamW steps of SMOKE olmo-1b, the state gathered whole."""
    from repro_torch.data import synthetic
    from repro_torch.distributed import constraints, sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    mesh = mesh_lib.make_mesh((1, 2), ("data", "model"), device="cuda",
                              init_method=f"file://{tmp}/rdzv", rank=rank,
                              world_size=2, timeout_s=300)
    cfg = configs.get_config("olmo-1b", smoke=True)
    ocfg = adamw.OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    state = sharding.shard_state(
        steps.init_train_state(cfg, ocfg, 0, "cuda"), mesh)
    step = steps.make_train_step(cfg, ocfg, mesh=mesh)
    dcfg = synthetic.for_model(cfg, 4, 16)
    for i in range(2):
        state, _ = step(state, synthetic.batch_at(dcfg, i, device="cuda"))
    whole = constraints.gather(state, mesh)
    torch.save([t.cpu() if isinstance(t, torch.Tensor) else t
                for t in tree_leaves(whole)], f"{tmp}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


@pytest.mark.gpu
def test_sharded_train_on_card_bit_equal(cuda, tmp_path):
    """SMOKE olmo-1b on 2 ranks sharing cuda:0 over gloo as a (1, 2) mesh:
    after 2 AdamW steps every rank's state, gathered whole, equals one
    process's on the card."""
    import torch.multiprocessing as mp
    from repro_torch.data import synthetic
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    cfg = configs.get_config("olmo-1b", smoke=True)
    ocfg = adamw.OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    state = steps.init_train_state(cfg, ocfg, 0, "cuda")
    step = steps.make_train_step(cfg, ocfg)
    dcfg = synthetic.for_model(cfg, 4, 16)
    for i in range(2):
        state, _ = step(state, synthetic.batch_at(dcfg, i, device="cuda"))
    want = [t.cpu() if isinstance(t, torch.Tensor) else t
            for t in tree_leaves(state)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_card_train_rank, args=(r, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(300)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert [p.exitcode for p in procs] == [0, 0]
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(a, b) if isinstance(b, torch.Tensor) \
                else a == b



@pytest.mark.gpu
def test_op_counts_on_meta_equal_card(cuda):
    """``op_analysis.analyze`` of one ``abft_matmul``, one
    ``drift_gemm_fused`` and one causal GQA ``mha_flash`` call: FLOPs,
    int8 ops and bytes on meta tensors equal those of the same call on the
    card with its kernel launched, and equal the kernel's ``work``."""
    from repro_torch.launch import op_analysis
    rng = np.random.default_rng(41)
    m, k, n = 256, 320, 192
    aq = torch.from_numpy(_int8(rng, (m, k)))
    bq = torch.from_numpy(_int8(rng, (k, n)))
    flips = torch.from_numpy(_flips(rng, (m, n)).view(np.int32))
    q = torch.randn((2, 64, 8, 64), dtype=torch.bfloat16)
    kv = torch.randn((2, 64, 2, 64), dtype=torch.bfloat16)
    fused = (aq, bq, flips, torch.tensor(0.01), torch.ones(n),
             torch.randn((m, n)), 1 << 10)
    calls = ((tak.abft_matmul, (aq, bq, flips), {}, tak.work(m, k, n)),
             (ops.drift_gemm_fused, fused, dict(valid=(m, n)),
              ops.work(m, k, n, flip_words=m * n)),
             (tfk.mha_flash, (q, kv, kv), dict(causal=True, window=24),
              tfk.work(2, 64, 8, 2, 64, 2, True, 24)))
    for fn, args, kw, work in calls:
        def on(dev):
            return [a.to(dev) if isinstance(a, torch.Tensor) else a
                    for a in args]
        n0 = tak.launches + tfk.launches + ops.launches
        card = op_analysis.analyze(fn, *on(cuda), **kw)
        assert tak.launches + tfk.launches + ops.launches == n0 + 1
        meta = op_analysis.analyze(fn, *on("meta"), **kw)
        for key in ("flops", "int8_ops", "bytes"):
            assert card[key] == meta[key] == work[key], (fn, key)
