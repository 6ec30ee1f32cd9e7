"""``stat_abft_matmul`` with its own CUDA kernel, checked on the CPU.

The plain version (the function the kernel is held to on the card) is
held bit-equal to the JAX package's Pallas composite in interpret mode,
at the cases ``test_torch_ar.py`` leaves out: a 64-wide row tile,
thresholds -1 and 2^31 - 1, K = 50 (the reference at ``bk = K``) and
extreme +-127 operands at K = 4608 whose row sums wrap mod 2^32. The
wrapper's launch arguments (the kernel instance per row tile, the K pad),
its operands' layout, its raises, the op counter's count of one call and
the kernel library's name are checked without a launch: the kernel runs
only on the card (``tests/test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import stat_abft as jstat
from repro_torch.kernels import _lib
from repro_torch.kernels import abft_matmul as tak
from repro_torch.kernels import stat_abft
from repro_torch.launch import op_analysis


def _operands(seed, m, k, n, extreme=False):
    rng = np.random.default_rng(seed)
    if extreme:             # +-127, mostly +: the row sums pass 2^31
        pm = np.array([-127, 127], np.int8)
        aq = rng.choice(pm, size=(m, k), p=[0.1, 0.9])
        bq = rng.choice(pm, size=(k, n), p=[0.1, 0.9])
    else:
        aq = rng.integers(-127, 128, (m, k), dtype=np.int8)
        bq = rng.integers(-127, 128, (k, n), dtype=np.int8)
    hit = rng.random((m, n)) < 0.02
    pos = rng.integers(0, 32, size=(m, n)).astype(np.uint32)
    flips = np.where(hit, np.left_shift(np.uint32(1), pos),
                     np.uint32(0)).astype(np.uint32)
    flips[1, 2] = np.uint32(1 << 31)
    flips[m - 1, n - 1] = np.uint32(1 << 20)
    return aq, bq, flips


def _residuals(aq, bq, c, bn):
    """Per (row, bn-tile) sums of c minus the clean product, in int32."""
    clean = aq.astype(np.int64) @ bq.astype(np.int64)
    diff = c.astype(np.int64) - clean
    resid = diff.reshape(c.shape[0], -1, bn).sum(2)
    return ((resid + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)


@pytest.fixture(scope="module")
def cases():
    """(name, aq, bq, flips, bm, bn, bk) shared by the parity tests."""
    return {
        "bn64": (*_operands(1, 128, 96, 256), 64, 64, 32),
        "k50": (*_operands(2, 64, 50, 128), 32, 32, 50),
        "wrap_k4608": (*_operands(3, 32, 4608, 128, extreme=True), 32,
                       128, 4608),
    }


@pytest.mark.parametrize("name", ["bn64", "k50", "wrap_k4608"])
@pytest.mark.parametrize("thr", [-1, 0, 1 << 10, 2 ** 31 - 1])
def test_plain_matches_pallas(cases, name, thr):
    """c and the row-tile flags bit-equal to the Pallas composite."""
    aq, bq, flips, bm, bn, bk = cases[name]
    want_c, want_d = jstat.stat_abft_matmul(
        jnp.asarray(aq), jnp.asarray(bq), jnp.asarray(flips), thr, bm=bm,
        bn=bn, bk=bk, interpret=True)
    got_c, got_d = stat_abft.stat_abft_matmul(
        torch.from_numpy(aq), torch.from_numpy(bq),
        torch.from_numpy(flips.view(np.int32)), thr, bm=bm, bn=bn)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    if thr == -1:           # every |resid| >= 0 > -1, but INT32_MIN's
        resid = _residuals(aq, bq, got_c.numpy(), bn)
        np.testing.assert_array_equal(got_d.numpy(), resid != -2 ** 31)
    if thr == 2 ** 31 - 1:  # no int32 magnitude exceeds INT32_MAX
        assert not bool(got_d.any())


def test_row_sums_wrap_at_k4608(cases):
    """The extreme operands' clean row sums pass 2^31: the residual is
    only right mod 2^32."""
    aq, bq, _, _, bn, _ = cases["wrap_k4608"]
    clean = aq.astype(np.int64) @ bq.astype(np.int64)
    sums = clean.reshape(clean.shape[0], -1, bn).sum(2)
    assert np.abs(sums).max() >= 2 ** 31


@pytest.mark.parametrize("bn", stat_abft.BN_TAKEN)
@pytest.mark.parametrize("k,kp", [(1, 16), (16, 16), (50, 64), (96, 96),
                                  (1152, 1152), (4608, 4608)])
def test_launch_args_pick_instance_and_pad(bn, k, kp):
    """One kernel instance per row tile; K zero-padded to a multiple of 16
    (a tensor map's row stride)."""
    a = torch.zeros((96, k), dtype=torch.int8)
    b = torch.zeros((k, 384), dtype=torch.int8)
    assert stat_abft.launch_args(a, b, bn) == (96, 384, kp, bn)
    assert stat_abft.row_tile_plan(bn) == (bn, 1)


@pytest.mark.parametrize("bn", [96, 160, 256])
def test_launch_args_raise_for_other_row_tiles(bn):
    """A row tile without an instance of its own runs the 32-wide one and
    sums its residuals in groups of bn / 32; only a width that is no
    multiple of 32, or does not divide N, raises."""
    a = torch.zeros((32, 64), dtype=torch.int8)
    b = torch.zeros((64, 3840), dtype=torch.int8)
    assert stat_abft.launch_args(a, b, bn) == (32, 3840, 64, bn)
    assert stat_abft.row_tile_plan(bn) == (32, bn // 32)
    with pytest.raises(ValueError, match="row tile"):
        stat_abft.launch_args(a, b, bn + 16)
    with pytest.raises(ValueError, match="row tile"):
        stat_abft.launch_args(a, b[:, :3 * bn + 32], bn)


def test_operands_are_k_major_and_zero_padded():
    rng = np.random.default_rng(4)
    aq = torch.from_numpy(rng.integers(-127, 128, (32, 50), dtype=np.int8))
    bq = torch.from_numpy(rng.integers(-127, 128, (50, 96), dtype=np.int8))
    a = stat_abft.a_operand(aq, 64)
    bt = stat_abft.k_major_plain(bq, 64)
    assert a.shape == (32, 64) and bt.shape == (96, 64)
    assert a.is_contiguous() and bt.is_contiguous()
    assert torch.equal(a[:, :50], aq) and not bool(a[:, 50:].any())
    assert torch.equal(bt[:, :50], bq.t()) and not bool(bt[:, 50:].any())
    # an aligned, contiguous A is read in place; an offset view is copied
    a16 = torch.zeros((32, 64), dtype=torch.int8)
    assert stat_abft.a_operand(a16, 64).data_ptr() == a16.data_ptr()
    base = torch.zeros(32 * 64 + 1, dtype=torch.int8)
    off = base[1:].view(32, 64)
    moved = stat_abft.a_operand(off, 64)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, off)


def test_wrapper_raises():
    """Unaligned tiles, a threshold outside int32 (the reference's
    ``jnp.int32(threshold_mag)`` rejects it) and meta tensors outside a
    count raise, on the plain route too."""
    a = torch.zeros((64, 32), dtype=torch.int8)
    b = torch.zeros((32, 128), dtype=torch.int8)
    f = torch.zeros((64, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        stat_abft.stat_abft_matmul(a, b, f, 0, bm=48, bn=32)
    for thr in (2 ** 31, -2 ** 31 - 1):
        for fn in (stat_abft.stat_abft_matmul,
                   stat_abft.stat_abft_matmul_plain):
            with pytest.raises(ValueError, match="int32"):
                fn(a, b, f, thr, bm=32, bn=32)
    with pytest.raises(ValueError, match="only inside"):
        stat_abft.stat_abft_matmul(a.to("meta"), b.to("meta"),
                                   f.to("meta"), 0, bm=32, bn=32)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_op_counter_counts_one_stat_abft_kernel(device):
    """One call is one ``stat_abft_matmul`` at ``stat_abft.work`` and no
    ``abft_matmul``, on meta and CPU tensors alike; the CPU route
    launches nothing."""
    m, k, n, bn = 64, 96, 256, 64
    aq, bq, flips = (torch.from_numpy(x) for x in _operands(5, m, k, n))
    flips = flips.view(torch.int32)
    n0 = (stat_abft.launches, tak.launches)
    out = op_analysis.analyze(stat_abft.stat_abft_matmul,
                              *(t.to(device) for t in (aq, bq, flips)), 0,
                              bm=bn, bn=bn)
    assert (stat_abft.launches, tak.launches) == n0
    assert out["kernels"] == {"stat_abft_matmul": 1}
    work = stat_abft.work(m, k, n, bn)
    assert work["int8_ops"] == 2 * m * n * k
    for key in ("flops", "int8_ops", "bytes"):
        assert out[key] == work[key], key


def test_kernel_library_is_built_from_its_source():
    """``_lib`` builds ``csrc/stat_abft.cu`` with the other kernels; its
    mainloop (in the shared header ``sm90.cuh``, which enters the build
    hash) is TMA loads and ``wgmma`` on the int8 tensor cores."""
    assert "stat_abft" in _lib.KERNELS
    paths = _lib.sources("stat_abft")
    assert _lib.CSRC / "sm90.cuh" in paths
    src = "".join(p.read_text() for p in paths)
    for needle in ("wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8",
                   "cp.async.bulk.tensor.2d", "mbarrier.try_wait.parity",
                   '#include "sm90.cuh"', "group_kernel<<<",
                   'extern "C" int stat_abft_launch',
                   'extern "C" int stat_abft_transpose_launch'):
        assert needle in src, needle
    assert _lib.library_path("stat_abft").name.startswith("stat_abft-")
