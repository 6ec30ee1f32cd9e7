"""The port's core modules against the JAX package's.

Quantization, the overflow-safe threshold, the fault law, DVFS table and
monitor, rollback fallbacks, metrics, the DDIM step, and
``ExecContext.matmul`` in each ported mode -- on numpy-seeded inputs
handed to both sides. ``JaxReplayFlipSource`` rebuilds the reference's
threefry key chain so the port draws exactly the reference's flip masks;
the other ``test_torch_*`` modules import it.
"""
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import abft as jabft
from repro.core import dvfs as jdvfs
from repro.core import fault as jfault
from repro.core import metrics as jmetrics
from repro.core import quant as jquant
from repro.core import rollback as jrollback
from repro.core.exec_ctx import DriftSystemConfig as JCfg
from repro.core.exec_ctx import ExecContext as JCtx
from repro.diffusion import schedule as jsched
from repro_torch.core import abft, dvfs, fault, metrics, quant, rollback
from repro_torch.core.exec_ctx import DriftSystemConfig, ExecContext
from repro_torch.diffusion import schedule as sched
from repro_torch.kernels import abft_matmul as tak
from repro_torch.kernels import rollback_correct as trk


@functools.partial(jax.jit, static_argnums=(4, 6, 7, 8))
def _replay_mask(run_key, step, scope, sid, shape, ber, fold_scope=True,
                 double_flip=False, force_bit=-1):
    k = jax.random.fold_in(run_key, step)
    if fold_scope:
        k = jax.random.fold_in(k, scope)
    fkey = jfault.site_key(k, step, sid, 0)
    return jfault.inject_int32(jnp.zeros(shape, jnp.int32), fkey, ber,
                               double_flip=double_flip, force_bit=force_bit)


class JaxReplayFlipSource:
    """Flip source replaying the reference's masks bit for bit.

    ``run_key`` is the batch key (the engine's ``fold_in(PRNGKey(seed),
    batch_index)``); the chain is the reference's: ``fold_in(run_key,
    step)`` in the sampler, ``fold_in(., scope)`` in the DiT (not in the
    UNet, whose one context takes the step key as it is: ``fold_scope``
    False), then ``fault.site_key(., step, crc32(name), 0)`` and
    ``inject_int32`` on a zero accumulator in ``ExecContext.matmul``,
    with the context's ``double_flip`` and ``force_bit``."""

    def __init__(self, run_key, fold_scope: bool = True):
        self.run_key = run_key
        self.fold_scope = fold_scope
        self.calls = []

    def __call__(self, site, shape, ber, double_flip=False, force_bit=-1):
        self.calls.append(site)
        sid = zlib.crc32(site.name.encode()) & 0x7FFFFFFF
        mask = _replay_mask(self.run_key, jnp.int32(site.step),
                            jnp.int32(site.scope), jnp.int32(sid),
                            tuple(shape), jnp.float32(ber), self.fold_scope,
                            bool(double_flip), int(force_bit))
        return torch.from_numpy(np.array(mask))


def jax_replay_factory(base_seed: int, fold_scope: bool = True):
    """``flip_source_factory`` replaying the reference engine's batches
    (``fold_scope`` False for the UNet)."""
    base = jax.random.PRNGKey(base_seed)
    return lambda batch_index: JaxReplayFlipSource(
        jax.random.fold_in(base, batch_index), fold_scope)


# ----------------------------------------------------------------- quant
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [None, 1])
def test_quantize_matches_jax(dtype, axis):
    """Int8 values and f32 scales bit-equal, in f32 and in bf16 arithmetic
    (the DiT quantizes bf16 activations and bf16-cast weights)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((64, 96)) * 3).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    want = jquant.quantize(jx, axis=axis)
    got = quant.quantize(tx, axis=axis)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    assert got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.scale.numpy().ravel(),
                                  np.asarray(want.scale).ravel())


def test_exceeds_survives_int32_min():
    d = torch.tensor([-2 ** 31, -1024, -1023, 0, 1023, 1024, 2 ** 31 - 1],
                     dtype=torch.int32)
    got = abft._exceeds(d, 1024)
    want = jabft._exceeds(jnp.asarray(d.numpy()), jnp.int32(1024))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(got[0])                     # abs(INT32_MIN) would miss it
    assert not bool(torch.abs(d)[0] >= 1024)


def test_tile_checksums_and_mask_match_jax():
    """The kernels' plain versions give the reference's per-tile checksum
    differences (``abft_matmul_plain``, operands zero-padded to the tile as
    ``ExecContext`` pads them) and its element mask and tile flags
    (``rollback_correct_plain`` with ckpt 1 and c 0 returns the mask),
    bit for bit, on a ragged 70x50x90 GEMM with a bit-31 flip."""
    rng = np.random.default_rng(4)
    aq = rng.integers(-127, 128, (70, 50), dtype=np.int8)
    bq = rng.integers(-127, 128, (50, 90), dtype=np.int8)
    clean = (aq.astype(np.int64) @ bq.astype(np.int64)).astype(np.int32)
    acc = clean.copy()
    acc[5, 7] ^= 1 << 20
    acc[40, 80] ^= np.int32(-2 ** 31)
    mp, np_ = 96, 96
    pad = functools.partial(np.pad, mode="constant")
    flips = pad(acc ^ clean, ((0, mp - 70), (0, np_ - 90)))
    _, ar, er, ac, ec = tak.abft_matmul_plain(
        torch.from_numpy(pad(aq, ((0, mp - 70), (0, 0)))),
        torch.from_numpy(pad(bq, ((0, 0), (0, np_ - 90)))),
        torch.from_numpy(flips))
    rd = abft.wrap_i32(ar.long() - er.long())                 # (Mp, Nt)
    cd = abft.wrap_i32(ac.long() - ec.long())                 # (Mt, Np)
    jcfg = jabft.AbftConfig()
    jrd, jcd = jabft.tile_checksum_diff(jnp.asarray(acc), jnp.asarray(aq),
                                        jnp.asarray(bq), jcfg)
    mt, nt = mp // 32, np_ // 32
    np.testing.assert_array_equal(
        rd.numpy(), np.asarray(jrd).transpose(0, 2, 1).reshape(mp, nt))
    np.testing.assert_array_equal(cd.numpy(),
                                  np.asarray(jcd).reshape(mt, np_))
    zeros, ones = torch.zeros((mp, np_)), torch.ones((mp, np_))
    for policy in ("union", "cross"):
        m, cnt = trk.rollback_correct_plain(zeros, ones, rd, cd,
                                            jcfg.threshold,
                                            union=policy == "union")
        jm, jf = jabft.tile_error_mask(jrd, jcd, jabft.AbftConfig(
            mask_policy=policy), acc.shape)
        np.testing.assert_array_equal(m[:70, :90].bool().numpy(),
                                      np.asarray(jm))
        np.testing.assert_array_equal((cnt > 0).numpy(), np.asarray(jf))
        assert np.asarray(jm).any()


# ----------------------------------------------------------------- fault
@pytest.mark.parametrize("ber", [0.0, 1e-6, 3e-3, 0.5, 0.9])
def test_word_flip_prob_matches_jax_f32(ber):
    """Same f32 formula; XLA's and PyTorch's log1p/expm1 may land an f32
    ulp apart (1.2e-7 relative), so the bound is 2.4e-7."""
    want = float(jfault.word_flip_prob(ber))
    got = fault.word_flip_prob(ber)
    assert abs(got - want) <= 2.4e-7 * want
    assert (got == 0.0) == (want == 0.0)


def test_philox_source_law_at_3e3():
    """Flip rate within a 5-sigma binomial band of 1-(1-ber)^32, bit
    positions uniform (chi-square, 31 dof, far below the 0.1% point 61.1),
    bit 31 as INT32_MIN, and the same mask for the same site."""
    ber = 3e-3
    src = fault.PhiloxFlipSource(base_seed=11, batch_index=2, device="cpu")
    site = fault.FaultSite(step=5, scope=3, name="mlp.w1")
    shape = (512, 1024)
    mask = src(site, shape, ber)
    assert mask.dtype == torch.int32 and tuple(mask.shape) == shape
    n = mask.numel()
    p = fault.word_flip_prob(ber)
    hits = int((mask != 0).sum())
    sigma = (n * p * (1 - p)) ** 0.5
    assert abs(hits - n * p) < 5 * sigma
    bits = mask[mask != 0].view(torch.int32).numpy().view(np.uint32)
    assert np.all(bits & (bits - 1) == 0)          # one bit per word
    pos = np.log2(bits.astype(np.float64)).astype(int)
    counts = np.bincount(pos, minlength=32)
    chi2 = ((counts - hits / 32) ** 2 / (hits / 32)).sum()
    assert chi2 < 61.1, chi2
    assert counts[31] > 0 and int(mask.min()) == -2 ** 31
    assert torch.equal(mask, src(site, shape, ber))
    other = src(fault.FaultSite(5, 3, "mlp.w2"), shape, ber)
    assert not torch.equal(mask, other)
    other_batch = fault.PhiloxFlipSource(11, 3, "cpu")(site, shape, ber)
    assert not torch.equal(mask, other_batch)
    assert not bool(src(site, shape, 0.0).any())


def test_replay_source_matches_reference_injection():
    """The test-side replay gives inject_int32's mask for the site key."""
    key = jax.random.PRNGKey(5)
    src = JaxReplayFlipSource(key)
    site = fault.FaultSite(step=3, scope=1000, name="patch")
    got = src(site, (64, 32), 3e-3)
    k = jax.random.fold_in(jax.random.fold_in(key, 3), 1000)
    fkey = jfault.site_key(k, 3, zlib.crc32(b"patch") & 0x7FFFFFFF, 0)
    want = jfault.inject_int32(jnp.zeros((64, 32), jnp.int32), fkey,
                               jnp.float32(3e-3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any()


# ------------------------------------------------------------------ dvfs
def test_dvfs_table_and_ladder_match_jax():
    for op in (dvfs.NOMINAL, dvfs.UNDERVOLT, dvfs.OVERCLOCK) + dvfs.OP_LADDER:
        jop = jdvfs.OperatingPoint(op.voltage, op.freq_ghz, op.name)
        assert dvfs.ber_of(op) == jdvfs.ber_of(jop)
        assert op.energy_factor == jop.energy_factor
    assert [p.name for p in dvfs.OP_LADDER] == [p.name
                                                for p in jdvfs.OP_LADDER]
    for agg in ("undervolt", "overclock"):
        got = dvfs.fine_grained_schedule(7, dvfs.OP_BY_NAME[agg])
        want = jdvfs.fine_grained_schedule(
            7, {"undervolt": jdvfs.UNDERVOLT,
                "overclock": jdvfs.OVERCLOCK}[agg])
        assert isinstance(got.ber_table, np.ndarray)
        np.testing.assert_array_equal(got.ber_table,
                                      np.asarray(want.ber_table))
    assert dvfs.ladder_op(9).name == "nominal"


def test_ber_monitor_matches_jax():
    """A hot run walks the ladder up, a cold run back down; the op index is
    exact at every step and the EMA agrees to f32 rounding."""
    counts = [0, 0, 500, 4000, 4000, 4000, 30, 0, 0, 0, 0]
    s, js = dvfs.ber_monitor_init("cpu"), jdvfs.ber_monitor_init()
    for c in counts:
        s = dvfs.ber_monitor_update(s, torch.tensor(c), 256, 10, 3e-3)
        js = jdvfs.ber_monitor_update(js, jnp.int32(c), 256, 10, 3e-3)
        assert int(s.op_index) == int(js.op_index)
        np.testing.assert_allclose(float(s.ema_ber), float(js.ema_ber),
                                   rtol=1e-6)
    assert s.n_updates == len(counts)


# -------------------------------------------------------------- rollback
def test_rollback_correct_fallbacks():
    """Masked positions take ``effective_checkpoint``'s values, as the
    reference's ``correct``: zeros with no checkpoint or ``have_ckpt``
    false, else the checkpoint."""
    cur = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    ck = torch.full((2, 3), -1.0)
    mask = torch.tensor([[True, False, False], [False, False, True]])
    for ckpt, have in ((None, True), (ck, False), (ck, True)):
        got = torch.where(mask, rollback.effective_checkpoint(cur, ckpt, have),
                          cur)
        want = jrollback.correct(
            jnp.asarray(cur.numpy()),
            None if ckpt is None else jnp.asarray(ckpt.numpy()),
            jnp.asarray(mask.numpy()), jnp.asarray(have))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rollback.should_checkpoint(20, 10)
    assert not rollback.should_checkpoint(21, 10)


# --------------------------------------------------------------- metrics
def test_metrics_match_jax():
    """lpips_proxy and psnr on (B, 8, 8, 4) images: 1e-5 relative (conv
    and reductions run in another order)."""
    rng = np.random.default_rng(6)
    a = np.clip(rng.standard_normal((2, 8, 8, 4)), -1, 1).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), -1, 1
                ).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(metrics.lpips_proxy(ta, tb)),
                               float(jmetrics.lpips_proxy(a, b)), rtol=1e-5)
    np.testing.assert_allclose(float(metrics.psnr(ta, tb)),
                               float(jmetrics.psnr(a, b)), rtol=1e-5)
    assert float(metrics.lpips_proxy(ta, ta)) == 0.0


def test_ddim_step_matches_jax():
    """f32 DDIM update incl. the +-4 clip and the final t_prev = -1 step:
    1e-6 (one rounding apart at most)."""
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((2, 4, 4, 4)) * 3).astype(np.float32)
    eps = rng.standard_normal(x.shape).astype(np.float32)
    s, js = sched.DdpmSchedule.default(), jsched.DdpmSchedule.default()
    np.testing.assert_array_equal(sched.ddim_timesteps(1000, 7),
                                  jsched.ddim_timesteps(1000, 7))
    for t, tp in ((999, 832), (166, 0), (0, -1)):
        got = s.ddim_step(torch.from_numpy(x), torch.from_numpy(eps), t, tp)
        want = js.ddim_step(jnp.asarray(x), jnp.asarray(eps), jnp.int32(t),
                            jnp.int32(tp))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


# ------------------------------------------------------------ exec_ctx
def _ctx_pair(mode, step, have_ckpt, ber, rng, m, n):
    key = jax.random.PRNGKey(21)
    src = JaxReplayFlipSource(key)
    ber_tab = np.array([ber, ber, ber], np.float32)
    store = {"attn.q": rng.standard_normal((m, n)).astype(np.float32)}
    jctx = JCtx(JCfg(mode=mode), key=jax.random.fold_in(
        jax.random.fold_in(key, step), 4), step=step,
        ber_by_class=jnp.asarray(ber_tab),
        state_in={k: jnp.asarray(v) for k, v in store.items()},
        have_ckpt=have_ckpt)
    tctx = ExecContext(DriftSystemConfig(mode=mode), flip_source=src,
                       step=step, scope=4, ber_by_class=ber_tab,
                       state_in={k: torch.from_numpy(v.copy())
                                 for k, v in store.items()},
                       have_ckpt=have_ckpt)
    return jctx, tctx, store


@pytest.mark.parametrize("mode,step,have_ckpt,m,n", [
    ("drift", 3, True, 70, 96),       # ragged M (pads to 96)
    ("drift", 10, True, 64, 40),      # refresh step, ragged N
    ("drift", 0, False, 64, 64),      # first step: zero fallback
    ("faulty", 3, True, 64, 64),
    ("clean", 3, True, 64, 64),
])
def test_exec_ctx_matches_jax(mode, step, have_ckpt, m, n):
    """Counts exact (detected rows, corrected elements, GEMM words) and the
    checkpoint refresh exact; outputs within 1e-6 relative of the output
    scale (the dequantization scales may differ by an f32 ulp)."""
    rng = np.random.default_rng(step + m + n)
    x = rng.standard_normal((m, 48)).astype(np.float32)
    w = rng.standard_normal((48, n)).astype(np.float32)
    jctx, tctx, store = _ctx_pair(mode, step, have_ckpt, 2e-2, rng, m, n)

    @jax.jit
    def jax_matmul(x, w):
        y = jctx.matmul(x, w, name="attn.q", rclass=2)
        return y, jctx.stats, jctx.state_out
    want, jstats, jstate = jax_matmul(jnp.asarray(x), jnp.asarray(w))
    want = np.asarray(want)
    got = tctx.matmul(torch.from_numpy(x), torch.from_numpy(w),
                      name="attn.q", rclass=2).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-6 * scale, rtol=0)
    if mode == "drift":
        for stat in ("detected_row_errors", "corrected_elems", "gemm_words"):
            assert int(tctx.stats[stat]) == int(jstats[stat]), stat
        assert int(tctx.stats["corrected_elems"]) > 0
        np.testing.assert_allclose(tctx.state_in["attn.q"].numpy(),
                                   np.asarray(jstate["attn.q"]),
                                   atol=1e-6 * scale, rtol=0)
        if step % 10:       # no refresh: the checkpoint is untouched
            np.testing.assert_array_equal(tctx.state_in["attn.q"].numpy(),
                                          store["attn.q"])
    elif mode == "clean":
        assert not tctx.flip_source.calls       # BER 0 draws nothing
