"""The fused DRIFT GEMM (``kernels.ops.drift_gemm_fused``) against the JAX
package's kernels, and ``ExecContext``'s ``drift`` mode built on it.

On CPU tensors the wrapper runs its plain version. Here that plain path is
held against the Pallas ``abft_matmul`` and ``rollback_correct`` in
interpret mode (32x32 tiles, the operands zero-padded as the reference's
``ops.drift_gemm`` pads them) on numpy-seeded inputs, with the
dequantisation done in numpy float32 between them: integers bit-equal and
the f32 output ``==``, on ragged shapes, union and cross, with and without
a checkpoint, with flips over the unpadded region, over the padded grid
(padding included) or none. Then against ``repro.kernels.ops.drift_gemm
(bm=bn=bk=32)`` itself, and the drift context against a copy of the
sequence it ran before it called the fused kernel. The CUDA kernel is held
against the plain version on the card by ``test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fault as jfault
from repro.kernels import abft_matmul as ak
from repro.kernels import ops as jops
from repro.kernels import rollback_correct as rk
from repro_torch.core import abft as abft_lib
from repro_torch.core import fault, quant, rollback
from repro_torch.core.dvfs import CLASS_BODY, N_CLASSES
from repro_torch.core.exec_ctx import DriftSystemConfig, ExecContext
from repro_torch.kernels import _lib
from repro_torch.kernels import abft_matmul as tak
from repro_torch.kernels import ops
from repro_torch.kernels import rollback_correct as trk
from repro_torch.kernels import stat_abft

THR = 1 << 10
# (M, K, N): test_torch_ar's ragged 70x50x90 (K % 16 != 0), a ragged M
# and N over K % 16 == 0 (N % 4 == 0: the card's vector path), and
# whole tiles over a ragged K
SHAPES = [(70, 50, 90), (45, 96, 100), (64, 37, 64)]


def _pad(x, rows, cols):
    return np.pad(x, ((0, rows - x.shape[0]), (0, cols - x.shape[1])))


def _inputs(m, k, n):
    """int8 operands, flips over the padded grid (a bit-31 flip inside,
    one in the padding where there is one), scales and a checkpoint."""
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    mp, np_ = ops.padded_shape(m, n)
    aq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    bq = rng.integers(-127, 128, (k, n), dtype=np.int8)
    hit = rng.random((mp, np_)) < 0.03
    pos = rng.integers(0, 32, (mp, np_)).astype(np.uint32)
    flips = np.where(hit, np.left_shift(np.uint32(1), pos),
                     np.uint32(0)).astype(np.uint32).view(np.int32)
    flips[m // 2, n // 3] = np.int32(-2 ** 31)
    if mp > m:
        flips[mp - 1, 1] = np.int32(1 << 20)       # flags a row + column
    sx = np.float32(rng.uniform(1e-3, 1e-2))
    sw = rng.uniform(1e-3, 1e-2, n).astype(np.float32)
    ckpt = rng.standard_normal((m, n)).astype(np.float32)
    return aq, bq, flips, sx, sw, ckpt


def _flips_for(flips, cover, m, n):
    """The kernel's flips for ``cover`` and the padded mask they mean."""
    if cover == "padded":
        return flips, flips
    if cover == "valid":
        own = np.ascontiguousarray(flips[:m, :n])
        return own, _pad(own, *flips.shape)
    return None, np.zeros_like(flips)


_PALLAS = {}


def _pallas_product(aq, bq, flips_p):
    """The Pallas ABFT kernel on the zero-padded operands (K padded to the
    32-deep slab it takes): c, row and column differences."""
    mp, np_ = flips_p.shape
    kp = -(-aq.shape[1] // 32) * 32
    key = (aq.tobytes(), bq.tobytes(), flips_p.tobytes())
    if key not in _PALLAS:
        c, ar, er, ac, ec = ak.abft_matmul(
            jnp.asarray(_pad(aq, mp, kp)), jnp.asarray(_pad(bq, kp, np_)),
            jnp.asarray(flips_p.view(np.uint32)), bm=32, bn=32, bk=32,
            interpret=True)
        _PALLAS[key] = (np.asarray(c), np.asarray(ar - er),
                        np.asarray(ac - ec))
    return _PALLAS[key]


def _mask_np(rd, cd, union):
    r = np.repeat((rd >= THR) | (rd <= -THR), 32, axis=1)
    c = np.repeat((cd >= THR) | (cd <= -THR), 32, axis=0)
    return (r | c) if union else (r & c)


def _torch(*xs):
    return [None if x is None else torch.from_numpy(np.asarray(x))
            for x in xs]


@pytest.mark.parametrize("with_ckpt", [False, True])
@pytest.mark.parametrize("union", [True, False])
@pytest.mark.parametrize("cover", ["valid", "padded", "none"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_fused_plain_matches_pallas(m, k, n, cover, union, with_ckpt):
    """Row and column differences and the tile counts bit-equal, the
    output ``==``: the Pallas product, y = (c * sx) * sw in numpy
    float32, the Pallas splice."""
    aq, bq, flips_all, sx, sw, ckpt = _inputs(m, k, n)
    flips, flips_p = _flips_for(flips_all, cover, m, n)
    mp, np_ = flips_p.shape
    c, rd, cd = _pallas_product(aq, bq, flips_p)
    y = (c[:m, :n].astype(np.float32) * sx) * sw
    ck_p = _pad(ckpt, mp, np_) if with_ckpt else np.zeros((mp, np_),
                                                         np.float32)
    want, want_flag = rk.rollback_correct(
        jnp.asarray(_pad(y, mp, np_)), jnp.asarray(ck_p), jnp.asarray(rd),
        jnp.asarray(cd), THR, bm=32, bn=32, union=union, interpret=True)
    want = np.asarray(want)[:m, :n]

    args = _torch(aq, bq, flips, sx, sw, ckpt if with_ckpt else None)
    n0 = ops.launches
    out, got_rd, got_cd, count = ops.drift_gemm_fused(
        *args, THR, union=union, valid=(m, n))
    assert ops.launches == n0                       # no launch on the CPU
    assert out.dtype == torch.float32 and out.is_contiguous()
    assert np.array_equal(out.numpy().view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got_rd.numpy(), rd)
    np.testing.assert_array_equal(got_cd.numpy(), cd)
    mask = _mask_np(rd, cd, union)
    np.testing.assert_array_equal(
        count.numpy(),
        _pad(mask[:m, :n], mp, np_).reshape(mp // 32, 32, np_ // 32,
                                            32).sum((1, 3)))
    # over the padded grid, a positive count is the Pallas tile flag
    _, _, _, count_p = ops.drift_gemm_fused(*args, THR, union=union)
    np.testing.assert_array_equal((count_p > 0).int().numpy(),
                                  np.asarray(want_flag))
    if cover != "none":
        assert mask.any()                           # something was flagged


@pytest.mark.parametrize("m,k,n,union,with_ckpt",
                         [(70, 50, 90, True, True),
                          (45, 96, 100, False, False)])
def test_drift_gemm_matches_jax_drift_gemm(m, k, n, union, with_ckpt):
    """``ops.drift_gemm`` (quantize, then the fused wrapper) against the
    reference's ``ops.drift_gemm(bm=bn=bk=32)`` with its own mask over the
    padded grid: differences and flagged tiles (padding included) equal,
    the output within 1e-6 relative, as ``test_torch_ar`` holds the
    composite: XLA may multiply the two scales first, one rounding apart
    from the source's ``(c * sx) * sw``, which the port keeps (and the
    Pallas test above holds ``==``)."""
    rng = np.random.default_rng(m + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    ck = rng.standard_normal((m, n)).astype(np.float32) if with_ckpt \
        else None
    key = jax.random.PRNGKey(m)
    ber = jnp.float32(1e-2)
    want = jops.drift_gemm(jnp.asarray(x), jnp.asarray(w),
                           None if ck is None else jnp.asarray(ck), key, ber,
                           bm=32, bn=32, bk=32, union=union, interpret=True)
    mp, np_ = ops.padded_shape(m, n)
    kf, kb = jax.random.split(key)
    flip = jax.random.uniform(kf, (mp, np_)) < jfault.word_flip_prob(ber)
    pos = jax.random.randint(kb, (mp, np_), 0, 32, dtype=jnp.uint32)
    flips = np.array(jnp.where(flip, jnp.left_shift(jnp.uint32(1), pos),
                               jnp.uint32(0))).view(np.int32)
    got = ops.drift_gemm(*_torch(x, w, ck, flips), union=union)
    np.testing.assert_array_equal(got.row_diff.numpy(),
                                  np.asarray(want.row_diff))
    np.testing.assert_array_equal(got.col_diff.numpy(),
                                  np.asarray(want.col_diff))
    assert int(got.n_flagged_tiles) == int(want.n_flagged_tiles) > 0
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y),
                               rtol=1e-6, atol=0)


def _bad_calls():
    aq = torch.zeros((40, 48), dtype=torch.int8)
    bq = torch.zeros((48, 36), dtype=torch.int8)
    sx = torch.tensor(0.5)
    sw = torch.ones(36)
    fl = torch.zeros((40, 36), dtype=torch.int32)
    ck = torch.zeros((40, 36))
    ok = dict(aq=aq, bq=bq, flips=fl, sx=sx, sw=sw, ckpt=ck)
    return {
        "aq f32": (TypeError, dict(ok, aq=aq.float())),
        "bq int32": (TypeError, dict(ok, bq=bq.int())),
        "K mismatch": (ValueError, dict(ok, bq=bq[:40])),
        "flips int64": (TypeError, dict(ok, flips=fl.long())),
        "flips shape": (ValueError, dict(ok, flips=fl[:, :32])),
        "sx 1-d": (ValueError, dict(ok, sx=sx.reshape(1))),
        "sx f64": (TypeError, dict(ok, sx=sx.double())),
        "sw shape": (ValueError, dict(ok, sw=torch.ones(64))),
        "ckpt shape": (ValueError, dict(ok, ckpt=torch.zeros((64, 64)))),
        "ckpt bf16": (TypeError, dict(ok, ckpt=ck.bfloat16())),
        "bq transposed": (ValueError,
                          dict(ok, bq=torch.zeros((36, 48),
                                                  dtype=torch.int8).T)),
        "flips strided": (ValueError,
                          dict(ok, flips=torch.zeros(
                              (40, 72), dtype=torch.int32)[:, ::2])),
        "ckpt strided": (ValueError,
                         dict(ok, ckpt=torch.zeros((40, 72))[:, :36])),
        "sw on meta": (ValueError, dict(ok, sw=sw.to("meta"))),
        "valid past the grid": (ValueError, dict(ok, valid=(40, 65))),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_fused_raises_on_bad_inputs(case):
    """Wrong dtype, shape, contiguity or device raise before any work."""
    err, kw = _bad_calls()[case]
    valid = kw.pop("valid", None)
    with pytest.raises(err):
        ops.drift_gemm_fused(kw["aq"], kw["bq"], kw["flips"], kw["sx"],
                             kw["sw"], kw["ckpt"], THR, valid=valid)


def test_launch_args_take_vectors_on_serving_shapes():
    """The epilogue's 16-byte path needs N % 4 == 0 and aligned out, sw,
    checkpoint and flips; anything else moves word by word. K and A do
    not enter: the kernel reads A through a tensor map over its (M, Kp)
    copy, zero-padded where K % 16 != 0."""
    def vec(m, k, n, off=0, flips=True, ckpt=True):
        aq = torch.zeros(m * k + off, dtype=torch.int8)[off:].view(m, k)
        bq = torch.zeros((k, n), dtype=torch.int8)
        fl = torch.zeros((m, n), dtype=torch.int32) if flips else None
        ck = (torch.zeros(m * n + off)[off:].view(m, n) if ckpt else None)
        return ops.launch_args(aq, bq, fl, torch.ones(n), ck,
                               torch.empty((m, n)))
    assert vec(2048, 1152, 4608) and vec(2, 256, 1152, flips=False)
    assert vec(154, 320, 320, ckpt=False)
    assert vec(70, 50, 92)                         # K % 16: A is padded
    assert not vec(64, 64, 90)                     # N % 4
    assert not vec(64, 64, 64, off=1)              # ckpt off 16 bytes


@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 8192), (8192, 2048),
                                 (256, 1152), (16, 1152), (50, 90)])
@pytest.mark.parametrize("m", [1, 2, 31, 32, 33, 63, 64, 65, 154, 2048])
def test_launch_plan_splits_k_at_one_cta_row(m, k, n):
    """Kp is K rounded up to 16 (at least 16); above one row of CTAs
    (M > 64) every CTA takes every K slab; at M <= 64 the slabs split
    evenly, no split empty, into about as many CTAs as the card has SMs
    (132) and no more splits than slabs."""
    kp, splits, slabs = ops.launch_plan(m, k, n)
    assert kp % 16 == 0 and kp >= max(k, 16) and kp - k < 16
    total = -(-kp // ops.BK)
    assert splits * slabs >= total > (splits - 1) * slabs
    tiles = -(-ops.padded_shape(m, n)[1] // ops.BN)
    if m > ops.BM:
        assert (splits, slabs) == (1, total)
    else:
        want = min(total, -(-132 // tiles))        # the fewest to fill
        assert tiles * (want - 1) < 132
        assert slabs == -(-total // want) and want / 2 < splits <= want
    if m <= ops.BM and (m, k, n) in ((2, 2048, 2048), (2, 2048, 8192),
                                     (2, 8192, 2048)):
        assert tiles * splits >= 128               # DriftDecode's GEMMs


def test_b_is_read_in_place_at_one_cta_row():
    """At M <= 64 with N % 16 == 0 and B 16-byte aligned the kernel reads
    B as it lies; anywhere else the call transposes it first."""
    def in_place(m, n, off=0):
        flat = torch.zeros(64 * n + off, dtype=torch.int8)
        return ops.reads_b_in_place(m, flat[off:].view(64, n))
    assert in_place(2, 2048) and in_place(64, 8192) and in_place(1, 16)
    assert not in_place(65, 2048)                  # two rows of CTAs
    assert not in_place(2, 200)                    # N % 16
    assert not in_place(2, 2048, off=8)            # B off 16 bytes


@pytest.mark.parametrize("m,k,n", SHAPES + [(2, 16, 48), (3, 1, 5)])
def test_k_major_operands_match_numpy(m, k, n):
    """The plain version of what the kernel multiplies: A (M, Kp) and B
    K-major (N, Kp), zero past K, both contiguous."""
    rng = np.random.default_rng(m * k + n)
    a = rng.integers(-127, 128, (m, k), dtype=np.int8)
    b = rng.integers(-127, 128, (k, n), dtype=np.int8)
    kp = ops.launch_plan(m, k, n)[0]
    got_a = stat_abft.a_operand(torch.from_numpy(a), kp)
    got_b = stat_abft.k_major_plain(torch.from_numpy(b), kp)
    assert got_a.is_contiguous() and got_b.is_contiguous()
    np.testing.assert_array_equal(got_a.numpy(),
                                  np.pad(a, ((0, 0), (0, kp - k))))
    np.testing.assert_array_equal(got_b.numpy(),
                                  np.pad(b.T, ((0, 0), (0, kp - k))))


def test_kernel_library_is_built_from_its_sources():
    """``csrc/drift_gemm.cu`` runs the shared ``wgmma`` + TMA mainloop of
    ``sm90.cuh`` (in its build hash), its transpose of B and split K."""
    assert "drift_gemm" in _lib.KERNELS
    assert _lib.CSRC / "sm90.cuh" in _lib.sources("drift_gemm")
    src = (_lib.CSRC / "drift_gemm.cu").read_text()
    for needle in ('#include "sm90.cuh"', "mainloop(&map_a, &map_b",
                   "transpose(b, K, N, Kp, bt, st)", "atomicAdd(tickets",
                   "bar.sync %0, 64", 'extern "C" int drift_gemm_launch'):
        assert needle in src, needle


# ------------------------------------------------- ExecContext, drift mode
def _old_drift(x2, w, ctx, name, rclass):
    """The drift branch of ``ExecContext._matmul2d`` as it ran before the
    fused kernel: padded operands and mask, ``abft_matmul``, dequantize,
    differences through int64, ``rollback_correct`` on padded copies.
    Returns (y, stats, y to checkpoint)."""
    m, k = x2.shape
    n = w.shape[1]
    mp, np_ = ops.padded_shape(m, n)
    xq = quant.quantize(x2, axis=None)
    wq = quant.quantize(w, axis=1)
    ber = float(ctx.ber_by_class[rclass])
    flips = ctx.flip_source(fault.FaultSite(ctx.step, ctx.scope, name),
                            (m, n), ber)
    flips = ops._pad2(flips, mp, np_)
    c, act_row, exp_row, act_col, exp_col = tak.abft_matmul(
        ops._pad2(xq.q, mp, k), ops._pad2(wq.q, k, np_), flips)
    y = quant.dequantize_matmul(c[:m, :n], xq.scale,
                                wq.scale.reshape(1, -1))
    cfg = ctx.cfg.abft
    row_diff = abft_lib.wrap_i32(act_row.long() - exp_row.long())
    col_diff = abft_lib.wrap_i32(act_col.long() - exp_col.long())
    full_row = abft_lib.wrap_i32(row_diff.long().sum(1))[:m]
    ckpt = rollback.effective_checkpoint(y, ctx.state_in.get(name),
                                         ctx.have_ckpt)
    y_corr, tile_count = trk.rollback_correct(
        ops._pad2(y, mp, np_), ops._pad2(ckpt, mp, np_), row_diff, col_diff,
        cfg.threshold, union=cfg.mask_policy != "cross", valid=(m, n))
    stats = {"detected_row_errors":
             0 + abft_lib._exceeds(full_row, cfg.threshold).sum(),
             "corrected_elems": 0 + tile_count.sum(),
             "extra_compute_flops": 0.0 + 0.0,
             "extra_dram_bytes": 0.0 + (tile_count > 0).float().sum()
             * cfg.tile_m * cfg.tile_n * 4,
             "gemm_words": m * n}
    return y_corr[:m, :n], stats


@pytest.mark.parametrize("ber", [0.0, 2e-2])
@pytest.mark.parametrize("policy", ["union", "cross"])
@pytest.mark.parametrize("have_ckpt,step", [(False, 0), (True, 1),
                                            (True, 2)])
@pytest.mark.parametrize("m,k,n", [(70, 50, 90), (64, 96, 128)])
def test_exec_ctx_drift_matches_inline_sequence(m, k, n, have_ckpt, step,
                                                policy, ber):
    """The drift context on the CPU: the same output, the same statistics
    (values and types) and the same refreshed checkpoint as the inline
    sequence it replaced, with and without a checkpoint, on refresh
    (step 2 at interval 2) and other steps, at BER 0 (no mask drawn)
    and above."""
    rng = np.random.default_rng(m + step)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    cfg = DriftSystemConfig(
        mode="drift", abft=abft_lib.AbftConfig(mask_policy=policy),
        rollback=rollback.RollbackConfig(interval=2))
    bers = np.zeros((N_CLASSES,), np.float32)
    bers[CLASS_BODY] = ber
    store = {"g": torch.from_numpy(
        rng.standard_normal((m, n)).astype(np.float32))}
    src = fault.PhiloxFlipSource(11, 0, "cpu")

    def ctx_of(state):
        return ExecContext(cfg, flip_source=src, step=step, scope=3,
                           ber_by_class=bers, state_in=state,
                           have_ckpt=have_ckpt)
    old_ctx = ctx_of({k_: v.clone() for k_, v in store.items()})
    want, want_stats = _old_drift(x, w, old_ctx, "g", CLASS_BODY)
    new_ctx = ctx_of({k_: v.clone() for k_, v in store.items()})
    got = new_ctx.matmul(x, w, name="g")
    assert torch.equal(got, want)
    for stat, v in want_stats.items():
        g_ = new_ctx.stats[stat]
        assert type(g_) is type(v), stat
        if isinstance(v, torch.Tensor):
            assert g_.dtype == v.dtype and torch.equal(g_, v), stat
        else:
            assert g_ == v, stat
    if ber > 0 and policy == "union":
        assert int(new_ctx.stats["corrected_elems"]) > 0
    refreshed = rollback.should_checkpoint(step, 2)
    assert torch.equal(new_ctx.state_in["g"],
                       want if refreshed else store["g"])
