"""The port's kernel modules against the JAX package's Pallas kernels.

Each kernel module of ``repro_torch.kernels`` holds a wrapper that, on CPU
tensors, runs the plain PyTorch version of the kernel's function. Here that
plain path is held against the Pallas kernel in interpret mode on the same
numpy-seeded inputs: bit-exact for the integer ABFT GEMM and the rollback
splice, within the Pallas flash test's tolerances for attention. The CUDA
kernels themselves are held against the plain versions on the card by
``test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import abft_matmul as ak
from repro.kernels import flash_attention as fk
from repro.kernels import rollback_correct as rk
from repro_torch.kernels import abft_matmul as tak
from repro_torch.kernels import flash_attention as tfk
from repro_torch.kernels import rollback_correct as trk

# tests/test_kernels.py::SHAPES: (m, k, n, bm, bn, bk)
SHAPES = [
    (32, 32, 32, 32, 32, 32),
    (64, 96, 128, 32, 32, 32),
    (128, 64, 64, 32, 64, 32),
    (96, 128, 96, 32, 32, 64),
    (256, 128, 128, 128, 128, 128),
    (64, 32, 64, 64, 64, 32),
]


def _int8(rng, shape):
    return rng.integers(-127, 128, size=shape, dtype=np.int8)


def _flips(rng, shape, p=0.01):
    hit = rng.random(shape) < p
    pos = rng.integers(0, 32, size=shape).astype(np.uint32)
    return np.where(hit, np.left_shift(np.uint32(1), pos),
                    np.uint32(0)).astype(np.uint32)


def _abft_both(aq, bq, flips, bm, bn, bk):
    want = ak.abft_matmul(jnp.asarray(aq), jnp.asarray(bq),
                          jnp.asarray(flips), bm=bm, bn=bn, bk=bk,
                          interpret=True)
    got = tak.abft_matmul(torch.from_numpy(aq), torch.from_numpy(bq),
                          torch.from_numpy(flips.view(np.int32)), bm=bm,
                          bn=bn)
    return got, want


@pytest.mark.parametrize("m,k,n,bm,bn,bk", SHAPES)
def test_abft_matmul_plain_matches_pallas(m, k, n, bm, bn, bk):
    """Integer arithmetic: all five outputs bit-equal."""
    rng = np.random.default_rng(m * 7 + n)
    got, want = _abft_both(_int8(rng, (m, k)), _int8(rng, (k, n)),
                           _flips(rng, (m, n)), bm, bn, bk)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_abft_matmul_wraps_at_k4608_with_bit31_flip():
    """The path's deepest GEMM (K = d_ff = 4608) with 127-valued operands:
    the expected sums overflow int32 (~2.4e9) and must wrap exactly as XLA's;
    a bit-31 flip (INT32_MIN) must come through the XOR and the sums."""
    rng = np.random.default_rng(4608)
    m, k, n = 32, 4608, 64
    aq = np.full((m, k), 127, np.int8)
    aq[1::2] = _int8(rng, (m // 2, k))
    bq = np.full((k, n), 127, np.int8)
    flips = np.zeros((m, n), np.uint32)
    flips[3, 5] = np.uint32(1 << 31)
    flips[17, 40] = np.uint32(1 << 12)
    got, want = _abft_both(aq, bq, flips, 32, 32, 128)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # row 0's true expected sum is 32 * 127^2 * 4608 ~ 2.4e9 > 2^31 - 1
    assert got[2][0, 0] == 32 * 127 * 127 * 4608 - 2 ** 32
    diff = (got[1].long() - got[2].long()).numpy()
    assert diff[3, 0] % 2 ** 32 == 2 ** 31          # the bit-31 delta


@pytest.mark.parametrize("flipped", [False, True])
@pytest.mark.parametrize("m,k,n,bm,bn,bk,extreme",
                         [(*s, False) for s in SHAPES]
                         + [(32, 4608, 64, 32, 32, 128, True)])
def test_expected_sums_are_clean_tile_sums(m, k, n, bm, bn, bk, extreme,
                                           flipped):
    """The premise of the card kernel's epilogue: the Pallas kernel's
    expected sums (aq @ blocksum(bq), blocksum(aq) @ bq) equal the row and
    column sums of the clean product over each (bm, bn) tile, mod 2^32,
    whatever the flips. Also at K = 4608 with every operand 127, where the
    sums wrap. With no flips the actual sums equal them too."""
    rng = np.random.default_rng(m + 3 * k + n)
    if extreme:
        aq = np.full((m, k), 127, np.int8)
        bq = np.full((k, n), 127, np.int8)
    else:
        aq, bq = _int8(rng, (m, k)), _int8(rng, (k, n))
    flips = np.zeros((m, n), np.uint32)
    if flipped:
        flips = _flips(rng, (m, n), p=0.05)
        flips[0, 0] = np.uint32(1 << 31)
    _, act_row, exp_row, act_col, exp_col = (np.asarray(x) for x in
                                             ak.abft_matmul(
        jnp.asarray(aq), jnp.asarray(bq), jnp.asarray(flips), bm=bm, bn=bn,
        bk=bk, interpret=True))
    clean = aq.astype(np.int64) @ bq.astype(np.int64)       # exact

    def wrap(x):
        return (x % 2 ** 32).astype(np.uint32).view(np.int32)
    rows = wrap(clean.reshape(m, n // bn, bn).sum(2))
    cols = wrap(clean.reshape(m // bm, bm, n).sum(1))
    np.testing.assert_array_equal(exp_row, rows)
    np.testing.assert_array_equal(exp_col, cols)
    if extreme:
        assert int(rows[0, 0]) == bn * 127 * 127 * k - 2 ** 32
    if not flipped:
        np.testing.assert_array_equal(act_row, rows)
        np.testing.assert_array_equal(act_col, cols)


def test_abft_launch_args_pick_vector_or_byte_loads():
    """The launcher's vector path needs K % 16 == 0, A 16-byte and B 4-byte
    aligned; K = 100 (or an offset operand) stages byte by byte."""
    base = torch.zeros(64 * 1152 + 64, dtype=torch.int8)
    a = base[:64 * 1152].view(64, 1152)
    b = base[:1152 * 32].view(1152, 32)
    assert tak.launch_args(a, b) == (64, 32, 1152, True)
    assert tak.launch_args(base[16:16 + 64 * 1152].view(64, 1152), b)[3]
    assert not tak.launch_args(base[1:1 + 64 * 1152].view(64, 1152), b)[3]
    assert not tak.launch_args(a, base[2:2 + 1152 * 32].view(1152, 32))[3]
    assert tak.launch_args(a, base[4:4 + 1152 * 32].view(1152, 32))[3]
    a100 = torch.zeros((96, 100), dtype=torch.int8)
    b100 = torch.zeros((100, 32), dtype=torch.int8)
    assert tak.launch_args(a100, b100) == (96, 32, 100, False)
    k16 = torch.zeros((32, 16), dtype=torch.int8)
    assert tak.launch_args(k16, torch.zeros((16, 32), dtype=torch.int8))[3]


def _mask_np(rd, cd, bm, bn, union, thr=1 << 10):
    """The union (or cross) element mask of the Pallas reference, in numpy."""
    r = np.repeat((rd >= thr) | (rd <= -thr), bn, axis=1)
    c = np.repeat((cd >= thr) | (cd <= -thr), bm, axis=0)
    return (r | c) if union else (r & c)


@pytest.mark.parametrize("m,k,n,bm,bn,bk", SHAPES[:4])
@pytest.mark.parametrize("union", [True, False])
def test_rollback_correct_plain_matches_pallas(m, k, n, bm, bn, bk, union):
    """Splice bit-equal, union and cross; the port's per-tile masked count
    is positive exactly where the Pallas tile flag is set, and counts the
    mask's elements of the tile (of its valid region, where one is given)."""
    rng = np.random.default_rng(n)
    aq, bq = _int8(rng, (m, k)), _int8(rng, (k, n))
    flips = _flips(rng, (m, n), p=0.02)
    c, ar, er, ac, ec = (np.asarray(x) for x in ak.abft_matmul(
        jnp.asarray(aq), jnp.asarray(bq), jnp.asarray(flips), bm=bm, bn=bn,
        bk=bk, interpret=True))
    cf = c.astype(np.float32)
    ckpt = rng.standard_normal((m, n)).astype(np.float32)
    rd, cd = ar - er, ac - ec
    want_c, want_f = rk.rollback_correct(
        jnp.asarray(cf), jnp.asarray(ckpt), jnp.asarray(rd), jnp.asarray(cd),
        1 << 10, bm=bm, bn=bn, union=union, interpret=True)
    args = [torch.from_numpy(x) for x in (cf, ckpt, rd, cd)]
    got_c, got_n = trk.rollback_correct(*args, 1 << 10, bm=bm, bn=bn,
                                        union=union)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert got_n.dtype == torch.int32
    np.testing.assert_array_equal((got_n > 0).int().numpy(),
                                  np.asarray(want_f))
    mask = _mask_np(rd, cd, bm, bn, union)
    mt, nt = m // bm, n // bn
    np.testing.assert_array_equal(
        got_n.numpy(), mask.reshape(mt, bm, nt, bn).sum((1, 3)))
    assert got_n.numpy().any()                      # something was flagged
    vm, vn = m - 5, n - 7
    _, got_v = trk.rollback_correct(*args, 1 << 10, bm=bm, bn=bn,
                                    union=union, valid=(vm, vn))
    assert int(got_v.sum()) == int(mask[:vm, :vn].sum())


def _qkv(rng, shape):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,d,bq,bk", [(64, 32, 32, 32), (128, 64, 32, 64),
                                       (96, 16, 32, 32)])
def test_flash_attention_plain_matches_pallas(causal, s, d, bq, bk):
    """f32: 2e-5, the tolerance tests/test_kernels_flash.py holds the Pallas
    kernel to against full_attention (only the summation order differs)."""
    rng = np.random.default_rng(s + d)
    q, k, v = _qkv(rng, (2, s, d))
    want = fk.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, bq=bq, bk=bk, interpret=True)
    got = tfk.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_flash_attention_bf16_matches_pallas():
    """bf16 in and out: 3e-2, as tests/test_kernels_flash.py. The Pallas
    kernel and the port's bf16 card kernel round p to bf16 before PV; the
    plain version run here keeps p in f32."""
    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(x, jnp.bfloat16) for x in _qkv(rng, (2, 64, 32)))
    want = fk.flash_attention(q, k, v, bq=32, bk=32, interpret=True)
    tq, tk_, tv = (torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
                   for x in (q, k, v))
    got = tfk.flash_attention(tq, tk_, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2,
                               rtol=3e-2)


def test_mha_flash_fold_matches_pallas():
    """The (B, S, H, D) wrapper (the Pallas one folds heads; the port's
    reads them in place): shape and values (f32, 2e-5)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 4, 32)).astype(np.float32)
    want = fk.mha_flash(jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
                        causal=False, bq=32, bk=32, interpret=True)
    t = torch.from_numpy(x)
    got = tfk.mha_flash(t, t, t, causal=False)
    assert got.shape == (2, 64, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-5),
                                       (jnp.bfloat16, 3e-2)])
@pytest.mark.parametrize("causal", [False, True])
def test_mha_flash_strided_views_match_pallas(causal, dtype, tol):
    """q, k, v sliced from one fused (B, S, 3, H, D) projection output, as
    the card kernel takes them (no copies), against the Pallas mha_flash on
    contiguous copies. f32 2e-5; bf16 3e-2 (the Pallas kernel rounds p)."""
    rng = np.random.default_rng(13 + causal)
    b, s, h, d = 2, 64, 3, 24
    fused = np.array(jnp.asarray(
        rng.standard_normal((b, s, 3, h, d)).astype(np.float32), dtype),
        np.float32)                       # values exact in the test dtype
    q, k, v = (fused[:, :, i] for i in range(3))
    want = fk.mha_flash(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                        causal=causal, bq=32, bk=32, interpret=True)
    t = torch.from_numpy(fused)
    t = t.bfloat16() if dtype == jnp.bfloat16 else t
    tq, tk_, tv = t[:, :, 0], t[:, :, 1], t[:, :, 2]
    assert not tq.is_contiguous()
    got = tfk.mha_flash(tq, tk_, tv, causal=causal)
    assert got.shape == (b, s, h, d) and got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_launch_args_strides_and_alignment():
    """The launcher's layout: (batch, token, head) element strides of q, k,
    v, o, and the 16-byte flag (bf16: D % 8 == 0 and aligned row starts)."""
    b, s, h, d = 2, 10, 4, 72
    fused = torch.zeros((b, s, 3, h, d), dtype=torch.bfloat16)
    q, k, v = fused[:, :, 0], fused[:, :, 1], fused[:, :, 2]
    o = torch.empty((b, s, h, d), dtype=torch.bfloat16)
    got = tfk.launch_args(q, k, v, o)
    fs = (s * 3 * h * d, 3 * h * d, d)
    assert got == (b, s, h, d, fs * 3 + (s * h * d, h * d, d), True)
    # (BH, S, D) as H = 1: the head stride is ignored for alignment.
    x = torch.zeros((6, s, 16), dtype=torch.bfloat16).unsqueeze(2)
    assert tfk.launch_args(x, x, x, x)[5]
    # D = 36: no whole 16-byte chunks.
    y = torch.zeros((b, s, h, 36), dtype=torch.bfloat16)
    assert not tfk.launch_args(y, y, y, y)[5]
    # A row start one element off 16 bytes.
    base = torch.zeros(b * s * h * d + 1, dtype=torch.bfloat16)
    z = base[1:].view(b, s, h, d)
    assert not tfk.launch_args(z, q, v, o)[5]
    # f32: 16 bytes are 4 elements.
    f = torch.zeros((b, s, h, 36))
    assert tfk.launch_args(f, f, f, f)[5]
    with pytest.raises(ValueError):
        t = torch.zeros((b, s, d, h), dtype=torch.bfloat16).transpose(2, 3)
        tfk.launch_args(t, t, t, o)


@pytest.mark.parametrize("bad", ["dtype", "flips", "shape", "tile"])
def test_abft_wrapper_rejects_bad_inputs(bad):
    a = torch.zeros((32, 16), dtype=torch.int8)
    b = torch.zeros((16, 32), dtype=torch.int8)
    f = torch.zeros((32, 32), dtype=torch.int32)
    if bad == "dtype":
        a = a.int()
    elif bad == "flips":
        f = f.long()
    elif bad == "shape":
        b = torch.zeros((8, 32), dtype=torch.int8)
    else:
        a = torch.zeros((48, 16), dtype=torch.int8)
        f = torch.zeros((48, 32), dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        tak.abft_matmul(a, b, f)


def test_rollback_and_flash_wrappers_reject_bad_inputs():
    c = torch.zeros((32, 32))
    rd = torch.zeros((32, 1), dtype=torch.int32)
    cd = torch.zeros((1, 32), dtype=torch.int32)
    with pytest.raises(TypeError):
        trk.rollback_correct(c.double(), c, rd, cd, 1024)
    with pytest.raises(ValueError):
        trk.rollback_correct(c, c, rd.T.contiguous(), cd, 1024)
    with pytest.raises(ValueError):
        trk.rollback_correct(c, c, rd, cd, 1024, valid=(33, 32))
    q = torch.zeros((2, 8, 16))
    with pytest.raises(TypeError):
        tfk.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError):
        tfk.flash_attention(torch.zeros((2, 8, 264)), torch.zeros((2, 8, 264)),
                            torch.zeros((2, 8, 264)))


def test_cpu_wrappers_do_not_count_launches():
    """The counters count kernel launches only: plain CPU calls leave them."""
    before = (tak.launches, trk.launches, tfk.launches)
    rng = np.random.default_rng(2)
    a = torch.from_numpy(_int8(rng, (32, 32)))
    tak.abft_matmul(a, a, torch.zeros((32, 32), dtype=torch.int32))
    q = torch.zeros((1, 32, 8))
    tfk.flash_attention(q, q, q)
    tfk.mha_flash(q[:, :, None], q[:, :, None], q[:, :, None], causal=True)
    assert (tak.launches, trk.launches, tfk.launches) == before
