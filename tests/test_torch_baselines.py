"""The Fig 12 baselines of the port against the JAX package's.

Unit level: the full-matrix detector (``detect_int``, ``detect_f32``,
``correction_mask``), the per-tile flag, the four baselines and DRIFT's
rollback as plain functions, the ``double_flip``/``force_bit`` flip
options, the resilience policies. Module level: ``ExecContext.matmul`` in
each baseline mode at ragged shapes, and ``bmm`` with
``protect_attention_gemms``. Slice level: one reference engine and one
port engine each serve the SMOKE DiT in the four modes, with the
reference's masks (``jax_replay_factory``).

Integer outputs, masks, flags and counts are bit-equal; the float32
recovery costs compare with ``==`` (same f32 operations in the same
order); float outputs within the tolerance each test states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import abft as jabft
from repro.core import baselines as jbaselines
from repro.core import dvfs as jdvfs
from repro.core import fault as jfault
from repro.core import policies as jpolicies
from repro.core.exec_ctx import DriftSystemConfig as JCfg
from repro.core.exec_ctx import ExecContext as JCtx
from repro.serving import DriftServeEngine as JaxEngine
from repro_torch.core import abft, baselines, dvfs, fault, policies
from repro_torch.core.exec_ctx import DriftSystemConfig, ExecContext
from repro_torch.kernels import abft_matmul as tak
from repro_torch.launch import serve
from repro_torch.models import dit
from repro_torch.serving import DriftServeEngine

from test_torch_core import JaxReplayFlipSource, jax_replay_factory
from test_torch_dit import perturbed_jax_params
from test_torch_serving import assert_attribution_equal

BASELINES = ("thundervolt", "approx_abft", "dmr", "stat_abft")
ARCH = "dit-xl-512"
STEPS = 3
SEEDS = (0, 1)


def _faulty_acc(rng, m, k, n):
    """int8 operands, the clean int32 product and a faulty copy with a few
    large flips (bit 31 among them) and some small ones."""
    aq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    bq = rng.integers(-127, 128, (k, n), dtype=np.int8)
    clean = (aq.astype(np.int64) @ bq.astype(np.int64)).astype(np.int32)
    acc = clean.copy()
    acc[3, 5] ^= 1 << 20
    acc[m - 1, n // 2] ^= np.int32(-2 ** 31)
    acc[m // 2, 1] ^= 1 << 12
    acc[m // 2, n - 1] ^= 1 << 3          # below the threshold
    return aq, bq, clean, acc


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


# ------------------------------------------------------------ detection
@pytest.mark.parametrize("m,k,n", [(70, 50, 90), (64, 48, 64)])
def test_detect_int_and_correction_mask_match_jax(m, k, n):
    """Differences, flags, counts and the cross mask bit-equal."""
    aq, bq, _, acc = _faulty_acc(np.random.default_rng(m), m, k, n)
    cfg, jcfg = abft.AbftConfig(), jabft.AbftConfig()
    got = abft.detect_int(_t(acc), _t(aq), _t(bq), cfg)
    want = jabft.detect_int(jnp.asarray(acc), jnp.asarray(aq),
                            jnp.asarray(bq), jcfg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got.n_row_err) == 3 and int(got.n_col_err) == 3
    np.testing.assert_array_equal(abft.correction_mask(got).numpy(),
                                  np.asarray(jabft.correction_mask(want)))


def test_kernel_tile_sums_give_detect_int_and_tile_flags():
    """The ABFT kernel's per-tile differences (its plain version, operands
    zero-padded as ExecContext pads them) summed over the N tiles and over
    the M tiles are detect_int's full-row and full-column differences, and
    ``tile_flags`` is tile_error_mask's tile flag, union and cross."""
    m, k, n = 70, 50, 90
    aq, bq, clean, acc = _faulty_acc(np.random.default_rng(5), m, k, n)
    mp, np_ = 96, 96
    flips = np.pad(acc ^ clean, ((0, mp - m), (0, np_ - n)))
    _, ar, er, ac, ec = tak.abft_matmul_plain(
        _t(np.pad(aq, ((0, mp - m), (0, 0)))),
        _t(np.pad(bq, ((0, 0), (0, np_ - n)))), _t(flips))
    rd = abft.wrap_i32(ar.long() - er.long())
    cd = abft.wrap_i32(ac.long() - ec.long())
    want = jabft.detect_int(jnp.asarray(acc), jnp.asarray(aq),
                            jnp.asarray(bq), jabft.AbftConfig())
    np.testing.assert_array_equal(
        abft.wrap_i32(rd.long().sum(1))[:m].numpy(), np.asarray(want.row_diff))
    np.testing.assert_array_equal(
        abft.wrap_i32(cd.long().sum(0))[:n].numpy(), np.asarray(want.col_diff))
    jrd, jcd = jabft.tile_checksum_diff(jnp.asarray(acc), jnp.asarray(aq),
                                        jnp.asarray(bq), jabft.AbftConfig())
    for policy in ("union", "cross"):
        _, jflag = jabft.tile_error_mask(
            jrd, jcd, jabft.AbftConfig(mask_policy=policy), (m, n))
        got = abft.tile_flags(rd, cd, abft.AbftConfig(mask_policy=policy))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jflag))
        assert got.any() and not got.all()


def test_detect_f32_matches_jax():
    """Float-path detection on an f32 GEMM with two injected errors: flags
    and counts equal, differences within 1e-3 of the checksum scale (f32
    sums in another order)."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal((40, 24)).astype(np.float32)
    b = rng.standard_normal((24, 56)).astype(np.float32)
    c = a @ b
    c[4, 9] += 3000.0
    c[30, 50] -= 5000.0
    cfg, jcfg = abft.AbftConfig(), jabft.AbftConfig()
    got = abft.detect_f32(_t(c), _t(a), _t(b), cfg)
    want = jabft.detect_f32(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b),
                            jcfg)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3,
                                   rtol=0)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got.n_row_err) == 2 and int(got.n_col_err) == 2


# ------------------------------------------------------------ baselines
@pytest.mark.parametrize("strategy", BASELINES + ("drift_rollback",))
def test_baseline_functions_match_jax(strategy):
    """Outputs and corrected counts bit-equal, float32 costs ==, on a
    ragged 70x90 GEMM (stat_abft stretches its 3x3 tile flags over 24x30
    elements, as the reference does)."""
    m, k, n = 70, 50, 90
    rng = np.random.default_rng(11)
    aq, bq, clean, acc = _faulty_acc(rng, m, k, n)
    y = (acc.astype(np.float32) * 1e-4).astype(np.float32)
    y_clean = (clean.astype(np.float32) * 1e-4).astype(np.float32)
    ckpt = rng.standard_normal((m, n)).astype(np.float32)
    rep = abft.detect_int(_t(acc), _t(aq), _t(bq), abft.AbftConfig())
    jrep = jabft.detect_int(jnp.asarray(acc), jnp.asarray(aq),
                            jnp.asarray(bq), jabft.AbftConfig())
    if strategy in ("thundervolt", "approx_abft"):
        got = getattr(baselines, strategy)(_t(y), rep)
        want = getattr(jbaselines, strategy)(jnp.asarray(y), jrep)
    elif strategy == "dmr":
        got = baselines.dmr(_t(y_clean), rep.n_row_err, 2.0 * m * k * n)
        want = jbaselines.dmr(jnp.asarray(y_clean), jrep.n_row_err,
                              2.0 * m * k * n)
    elif strategy == "stat_abft":
        jrd, jcd = jabft.tile_checksum_diff(
            jnp.asarray(acc), jnp.asarray(aq), jnp.asarray(bq),
            jabft.AbftConfig())
        _, jflag = jabft.tile_error_mask(jrd, jcd, jabft.AbftConfig(),
                                         (m, n))
        got = baselines.stat_abft(_t(y_clean), _t(y), _t(jflag), 1024, k)
        want = jbaselines.stat_abft(jnp.asarray(y_clean), jnp.asarray(y),
                                    jflag, 1024, k)
    else:
        got = baselines.drift_rollback(_t(y), rep, _t(ckpt), True)
        want = jbaselines.drift_rollback(jnp.asarray(y), jrep,
                                         jnp.asarray(ckpt), jnp.asarray(True))
    (y_got, cost), (y_want, jcost) = got, want
    np.testing.assert_array_equal(y_got.numpy(), np.asarray(y_want))
    assert int(cost.corrected_elems) == int(jcost.corrected_elems)
    for f in ("extra_compute_flops", "extra_dram_bytes"):
        assert np.float32(getattr(cost, f)) == np.asarray(getattr(jcost, f))
    if strategy != "dmr":
        assert int(cost.corrected_elems) > 0


# ------------------------------------------------------------ flip options
@pytest.mark.parametrize("opts", [dict(double_flip=True),
                                  dict(force_bit=31), dict(force_bit=4)])
def test_flip_options_reach_the_source_and_match_jax(opts):
    """ExecContext hands double_flip / force_bit to its flip source: the
    replayed masks are bit-equal to the reference's inject_int32 with the
    option, and the faulty GEMM's output matches the reference's within
    1e-6 of its scale (the dequantization scales may differ by an f32
    ulp) and differs from the same context's without the option."""
    key = jax.random.PRNGKey(2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 40)).astype(np.float32)
    w = rng.standard_normal((40, 48)).astype(np.float32)
    ber = np.full((3,), 5e-2, np.float32)
    jctx = JCtx(JCfg(mode="faulty", **opts),
                key=jax.random.fold_in(jax.random.fold_in(key, 4), 2),
                step=4, ber_by_class=jnp.asarray(ber))
    want = np.asarray(jax.jit(lambda a, b: jctx.matmul(a, b, name="mlp.w1"))(
        jnp.asarray(x), jnp.asarray(w)))
    src = JaxReplayFlipSource(key)
    tctx = ExecContext(DriftSystemConfig(mode="faulty", **opts),
                       flip_source=src, step=4, scope=2, ber_by_class=ber)
    got = tctx.matmul(_t(x), _t(w), name="mlp.w1").numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(),
                               rtol=0)
    plain = ExecContext(DriftSystemConfig(mode="faulty"), flip_source=src,
                        step=4, scope=2, ber_by_class=ber)
    assert not np.array_equal(
        plain.matmul(_t(x), _t(w), name="mlp.w1").numpy(), got)
    mask = src(fault.FaultSite(4, 2, "mlp.w1"), (64, 48), 5e-2, **opts)
    jmask = jfault.inject_int32(
        jnp.zeros((64, 48), jnp.int32),
        jfault.site_key(jax.random.fold_in(jax.random.fold_in(key, 4), 2),
                        4, fault.site_id("mlp.w1"), 0),
        jnp.float32(5e-2), **opts)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert mask.any()


def test_philox_flip_options_law():
    """The port's own draw: force_bit flips only that bit, at the per-word
    rate (5-sigma band); double_flip leaves two bits set in a share of the
    flipped words near clip(15.5 * ber) * 31/32 (5-sigma band)."""
    g = torch.Generator().manual_seed(9)
    n, ber = 1 << 18, 2e-2
    m = fault.draw_flips((n,), ber, g, "cpu", force_bit=31)
    hits = int((m != 0).sum())
    assert bool((m[m != 0] == -2 ** 31).all())
    assert abs(hits - n * ber) < 5 * (n * ber * (1 - ber)) ** 0.5
    g = torch.Generator().manual_seed(10)
    m = fault.draw_flips((n,), ber, g, "cpu", double_flip=True)
    bits = m[m != 0].numpy().view(np.uint32)
    two = int(np.count_nonzero(bits & (bits - 1)))
    p2 = 15.5 * ber * 31 / 32
    f = bits.size
    assert abs(two - f * p2) < 5 * (f * p2 * (1 - p2)) ** 0.5
    assert not bool(fault.draw_flips((8,), 0.0, g, "cpu",
                                     double_flip=True).any())


# ------------------------------------------------------------- policies
def test_resilience_policies_match_jax():
    for pol, jpol in ((policies.PAPER_DEFAULT, jpolicies.PAPER_DEFAULT),
                      (policies.UNPROTECTED, jpolicies.UNPROTECTED),
                      (policies.ResiliencePolicy(False, 3),
                       jpolicies.ResiliencePolicy(False, 3))):
        for kind in ("embed", "text_embed", "final", "block", "head"):
            for i in range(5):
                assert pol.classify(kind, i) == jpol.classify(kind, i)
        got = pol.class_vector(["b"] * 6)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jpol.class_vector(["b"] * 6)))
    assert policies.PAPER_DEFAULT.classify("embed", 0) == dvfs.CLASS_EMBED
    assert dvfs.CLASS_BODY == jdvfs.CLASS_BODY
    rng = np.random.default_rng(1)
    deltas = rng.standard_normal(12)
    np.testing.assert_array_equal(policies.sensitivity_score(deltas),
                                  jpolicies.sensitivity_score(deltas))
    for scores, emb in ((np.array([0.9, 0.8, 0.1, 0.2, 0.05]), 0.95),
                        (np.array([0.1, 0.9, 0.8]), 0.0),
                        (rng.random(20), 0.5)):
        assert (policies.derive_policy(scores, emb)
                == policies.ResiliencePolicy(
                    **vars(jpolicies.derive_policy(scores, emb))))


# ----------------------------------------------------- ExecContext modes
def _ctx_pair(mode, m, n, rng, **cfg_kw):
    key = jax.random.PRNGKey(21)
    ber = np.full((3,), 2e-2, np.float32)
    store = {"attn.q": rng.standard_normal((m, n)).astype(np.float32)}
    jctx = JCtx(JCfg(mode=mode, **cfg_kw),
                key=jax.random.fold_in(jax.random.fold_in(key, 3), 4),
                step=3, ber_by_class=jnp.asarray(ber),
                state_in={k: jnp.asarray(v) for k, v in store.items()},
                have_ckpt=True)
    tctx = ExecContext(DriftSystemConfig(mode=mode, **cfg_kw),
                       flip_source=JaxReplayFlipSource(key), step=3, scope=4,
                       ber_by_class=ber,
                       state_in={k: _t(v) for k, v in store.items()},
                       have_ckpt=True)
    return jctx, tctx, store


STATS = ("detected_row_errors", "corrected_elems", "gemm_words",
         "extra_compute_flops", "extra_dram_bytes")


@pytest.mark.parametrize("mode", BASELINES + ("drift",))
@pytest.mark.parametrize("m,n", [(70, 90), (64, 40)])
def test_exec_ctx_modes_match_jax(mode, m, n):
    """Every stat equal (counts exact, f32 costs ==), outputs within 1e-6
    of the output scale (the dequantization scales may differ by an f32
    ulp); only drift refreshes a checkpoint (step 3: none does)."""
    rng = np.random.default_rng(m * n)
    x = rng.standard_normal((m, 48)).astype(np.float32)
    w = rng.standard_normal((48, n)).astype(np.float32)
    jctx, tctx, store = _ctx_pair(mode, m, n, rng)

    @jax.jit
    def jax_matmul(x, w):
        y = jctx.matmul(x, w, name="attn.q", rclass=2)
        return y, jctx.stats, jctx.state_out
    want, jstats, jstate = jax_matmul(jnp.asarray(x), jnp.asarray(w))
    want = np.asarray(want)
    got = tctx.matmul(_t(x), _t(w), name="attn.q", rclass=2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(),
                               rtol=0)
    for stat in STATS:
        assert np.float64(tctx.stats[stat]) == np.float64(
            np.asarray(jstats[stat])), stat
    assert int(tctx.stats["detected_row_errors"]) > 0
    if mode == "dmr":
        assert int(tctx.stats["corrected_elems"]) == 0
        assert float(tctx.stats["extra_compute_flops"]) == 2 * 2.0 * m * 48 * n
    else:
        assert int(tctx.stats["corrected_elems"]) > 0
    assert (mode == "drift") == bool(jstate)
    np.testing.assert_array_equal(tctx.state_in["attn.q"].numpy(),
                                  store["attn.q"])


def test_dmr_returns_the_clean_product():
    """dmr's output is the clean quantized product bit for bit: the same as
    clean mode's on the same inputs, whatever the flips."""
    rng = np.random.default_rng(4)
    x = _t(rng.standard_normal((70, 48)).astype(np.float32))
    w = _t(rng.standard_normal((48, 90)).astype(np.float32))
    outs = {}
    for mode in ("dmr", "clean"):
        _, tctx, _ = _ctx_pair(mode, 70, 90, rng)
        outs[mode] = tctx.matmul(x, w, name="attn.q", rclass=2)
    assert torch.equal(outs["dmr"], outs["clean"])


@pytest.mark.parametrize("protect", [False, True])
def test_bmm_matches_jax(protect):
    """bmm over (2, 3) leading slices: plain a @ b without
    protect_attention_gemms, else one protected GEMM per slice, named
    f"{name}.{i}"; outputs within 1e-6 of scale, counts exact."""
    rng = np.random.default_rng(8)
    a = rng.standard_normal((2, 3, 40, 32)).astype(np.float32)
    b = rng.standard_normal((2, 3, 32, 36)).astype(np.float32)
    jctx, tctx, _ = _ctx_pair("drift", 40, 36, rng,
                              protect_attention_gemms=protect)

    @jax.jit
    def jax_bmm(a, b):
        return jctx.bmm(a, b, name="attn.qk"), jctx.stats
    want, jstats = jax_bmm(jnp.asarray(a), jnp.asarray(b))
    want = np.asarray(want)
    got = tctx.bmm(_t(a), _t(b), name="attn.qk").numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(),
                               rtol=0)
    for stat in STATS:
        assert np.float64(tctx.stats[stat]) == np.float64(
            np.asarray(jstats[stat])), stat
    calls = tctx.flip_source.calls
    assert [c.name for c in calls] == (
        [f"attn.qk.{i}" for i in range(6)] if protect else [])
    assert (int(tctx.stats["corrected_elems"]) > 0) == protect


# ----------------------------------------------------------- the slice
@pytest.fixture(scope="module")
def jax_baselines_run():
    """One reference engine serving 2 requests in each baseline mode (4
    batches, one shared clean reference): (params, latents, class ids,
    results)."""
    eng = JaxEngine(arch=ARCH, smoke=True, bucket=2, base_seed=0)
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    np_params = perturbed_jax_params(jcfg, seed=5)
    eng._params[(ARCH, True)] = jax.tree.map(jnp.asarray, np_params)
    lat, cond, _ = eng.servable_for(ARCH).batch_inputs(jcfg, list(SEEDS))
    for mode in BASELINES:
        for s in SEEDS:
            eng.submit(steps=STEPS, mode=mode, op="undervolt", seed=s)
    return np_params, np.asarray(lat), np.asarray(cond), eng.run()


def test_slice_serves_the_baselines_like_jax_engine(jax_baselines_run):
    """The port's engine fed the same params, latents and masks: per
    request, corrected elements, evaluations, the monitor's ladder index
    and the perfmodel attribution exact; latents within 1e-4 (f32 SMOKE,
    sums in other orders), PSNR within 0.05 dB; dmr equal to clean."""
    np_params, lat, cond, want = jax_baselines_run
    eng = DriftServeEngine(arch=ARCH, smoke=True, bucket=2, base_seed=0,
                           device="cpu",
                           flip_source_factory=jax_replay_factory(0))
    eng.set_params(ARCH, True, dit.params_from_jax(np_params))
    eng.servable.batch_inputs = lambda cfg, seeds: (_t(lat),
                                                    _t(cond).long())
    for mode in BASELINES:
        for s in SEEDS:
            eng.submit(steps=STEPS, mode=mode, op="undervolt", seed=s)
    got = eng.run()
    assert [g.mode for g in got] == [w.mode for w in want]
    for g, w in zip(got, want):
        assert g.batch_corrected_elems == w.batch_corrected_elems
        assert g.n_model_evals == w.n_model_evals == STEPS
        assert g.monitor_op_index == w.monitor_op_index
        np.testing.assert_allclose(g.latents.numpy(), np.asarray(w.latents),
                                   atol=1e-4, rtol=0)
        assert abs(g.psnr_vs_clean_db - w.psnr_vs_clean_db) < 0.05
        assert_attribution_equal(g, w)
        if g.mode == "dmr":
            assert g.batch_corrected_elems == 0
            assert g.psnr_vs_clean_db > 90
        else:
            assert g.batch_corrected_elems > 0
    assert eng.stats.clean_samples_computed == 1
    assert eng.clock_s == got[-1].completed_at_s


def test_cli_serves_dmr_on_cpu(capsys):
    """``--mode dmr`` through the CLI: every request matches its clean
    reference, with 0 corrected elements, and prints its perfmodel line."""
    res = serve.main(["--device", "cpu", "--mode", "dmr", "--steps", "3"])
    out = capsys.readouterr().out
    assert "mode=dmr" in out and out.count("perfmodel/request") == 2
    assert all(r.batch_corrected_elems == 0 and r.mode == "dmr"
               for r in res)
