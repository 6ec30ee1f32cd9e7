"""The port's CUDA kernels against their plain PyTorch versions, the
checkpoint-offload store's side-stream copies into pinned memory, and a
drain through the telemetry front end's ``/events`` with offload on, on
the card.

Marked ``gpu``: each test skips without a CUDA device. This module imports
no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import abft_matmul as tak
from repro_torch.kernels import fault_inject as tfi
from repro_torch.kernels import flash_attention as tfk
from repro_torch.kernels import ops
from repro_torch.kernels import rollback_correct as trk
from repro_torch.kernels import stat_abft
from repro_torch.models.attention import full_attention
from repro_torch.serving.offload import OffloadConfig, OffloadStore
from repro_torch.serving.offload.layout import tree_leaves, tree_map


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


@pytest.mark.gpu
@pytest.mark.parametrize("blk,thr", [(128, 0), (32, 1 << 10)])
def test_stat_abft_matmul_matches_plain_on_card(cuda, blk, thr):
    rng = np.random.default_rng(blk)
    aq = torch.from_numpy(_int8(rng, (128, 96))).to(cuda)
    bq = torch.from_numpy(_int8(rng, (96, 256))).to(cuda)
    fl = _flips(rng, (128, 256), p=0.02)
    fl[3, 5] = np.uint32(1 << 31)
    flips = torch.from_numpy(fl.view(np.int32)).to(cuda)
    got = stat_abft.stat_abft_matmul(aq, bq, flips, thr, bm=blk, bn=blk)
    want = stat_abft.stat_abft_matmul_plain(aq, bq, flips, thr, bm=blk,
                                            bn=blk)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_drift_gemm_matches_plain_on_card(cuda):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((70, 50)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((50, 90)).astype(np.float32))
    ck = torch.from_numpy(rng.standard_normal((70, 90)).astype(np.float32))
    fl = _flips(rng, ops.padded_shape(70, 90), p=0.05)
    flips = torch.from_numpy(fl.view(np.int32))
    args = [t.to(cuda) for t in (x, w, ck, flips)]
    got = ops.drift_gemm(*args)
    want = ops.drift_gemm_plain(*args)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    assert int(got.n_flagged_tiles) > 0


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
