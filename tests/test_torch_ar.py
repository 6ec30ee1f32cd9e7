"""The port's autoregressive slice against the JAX package's.

The injection kernel's plain version against the Pallas ``fault_inject``
(interpret mode), statistical ABFT (float ``detect`` and the quantized
``stat_abft_matmul``), the ``drift_gemm`` composite, the decode loop
``ar.decode_batch`` in each AR mode, and the engine serving
``olmo-1b-smoke`` requests -- on numpy-seeded inputs handed to both sides.
Flip masks are the reference's, replayed through its key chain
(``JaxReplayFlipSource``; the AR chain ``fold_in(fold_in(run_key, step),
layer)`` is the one the DiT tests replay with scope = layer).
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import dvfs as jdvfs
from repro.core import fault as jfault
from repro.kernels import fault_inject as jfi
from repro.kernels import ops as jops
from repro.kernels import stat_abft as jstat
from repro.serving import DriftServeEngine as JaxEngine
from repro.serving import ar as jar
from repro.serving.servable import UNSUPPORTED_FAMILIES as JAX_UNSUPPORTED
from repro_torch import configs
from repro_torch.core import dvfs, fault
from repro_torch.kernels import abft_matmul as tak
from repro_torch.kernels import fault_inject as tfi
from repro_torch.kernels import ops
from repro_torch.kernels import rollback_correct as trk
from repro_torch.kernels import stat_abft
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.perfmodel import energy
from repro_torch.serving import DriftServeEngine
from repro_torch.serving import UnsupportedArchError, ar

from test_torch_core import JaxReplayFlipSource, jax_replay_factory
from test_torch_transformer import ARCH, lm_jax_params

STEPS = 8
WINDOW = 3


def _masks(rng, shape):
    """Sparse single-bit masks plus one bit-31 word and one exponent-bit
    word, as uint32."""
    hit = rng.random(shape) < 0.05
    pos = rng.integers(0, 32, size=shape).astype(np.uint32)
    m = np.where(hit, np.left_shift(np.uint32(1), pos), 0).astype(np.uint32)
    m.flat[0] = np.uint32(1 << 31)
    m.flat[1] = np.uint32(1 << 30)                 # f32 exponent MSB
    m.flat[2] = np.uint32(1 << 23)                 # f32 exponent LSB
    return m


# ------------------------------------------------------------ fault_inject
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("m,n,blk", [(128, 256, 128), (64, 96, 32)])
def test_fault_inject_plain_matches_pallas(dtype, m, n, blk):
    """Bit-equal on int32 views, against the Pallas kernel in interpret
    mode at its (bm, bn) blocks."""
    rng = np.random.default_rng(m + n)
    if dtype == "int32":
        x = rng.integers(-2 ** 31, 2 ** 31, (m, n), dtype=np.int64
                         ).astype(np.int32)
    else:
        x = rng.standard_normal((m, n)).astype(np.float32)
    mask = _masks(rng, (m, n))
    want = jfi.fault_inject(jnp.asarray(x), jnp.asarray(mask), bm=blk,
                            bn=blk, interpret=True)
    got = tfi.fault_inject(torch.from_numpy(x),
                           torch.from_numpy(mask.view(np.int32)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    assert not np.array_equal(got.numpy().view(np.int32), x.view(np.int32))


def test_inject_f32_matches_jax_with_replayed_mask():
    """The port's ``inject_f32`` given the replay source's mask for a
    decode site equals ``fault.inject_f32`` under the site's key, on the
    int32 views (the flips make Inf and NaN, so no float ==)."""
    run_key = jax.random.fold_in(jax.random.PRNGKey(2), 0)
    step, layer, name = 5, 1, "mlp.up"
    y = np.random.default_rng(0).standard_normal((2, 1, 256)).astype(
        np.float32)
    mask = JaxReplayFlipSource(run_key)(fault.FaultSite(step, layer, name),
                                        y.shape, 3e-2)
    got = fault.inject_f32(torch.from_numpy(y), mask)
    base = jax.random.fold_in(jax.random.fold_in(run_key, step), layer)
    fkey = jfault.site_key(base, step, zlib.crc32(name.encode())
                           & 0x7FFFFFFF, 0)
    want = jfault.inject_f32(jnp.asarray(y), fkey, jnp.float32(3e-2))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    assert int((mask != 0).sum()) > 10


@pytest.mark.parametrize("bad", ["dtype", "mask_dtype", "shape"])
def test_fault_inject_rejects_bad_inputs(bad):
    x = torch.zeros((4, 8))
    mask = torch.zeros((4, 8), dtype=torch.int32)
    if bad == "dtype":
        x = x.to(torch.bfloat16)
    elif bad == "mask_dtype":
        mask = mask.to(torch.int64)
    else:
        mask = mask[:, :4]
    with pytest.raises((TypeError, ValueError)):
        tfi.fault_inject(x, mask)
    with pytest.raises(TypeError):
        fault.inject_f32(torch.zeros((4, 8), dtype=torch.int32), mask)


# --------------------------------------------------- statistical detection
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stat_detection_matches_jax(dtype):
    """threshold within rtol 1e-6 (both sum in f32, in other orders);
    residuals within rtol 1e-6 plus atol 1e-5, since a clean row's
    residual is nothing but the f32 rounding noise of its sums (~1e-6
    here) and differs with the order; with precomputed weight sums too;
    and the flags agree, with
    every row whose injected delta exceeds ``min_detectable_magnitude``
    flagged on both sides."""
    rng = np.random.default_rng(1)
    x32 = rng.standard_normal((6, 1, 64)).astype(np.float32)
    w32 = rng.standard_normal((64, 96)).astype(np.float32) / 8
    jx, jw = jnp.asarray(x32).astype(dtype), jnp.asarray(w32).astype(dtype)
    x = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    w = torch.from_numpy(np.asarray(jw.astype(jnp.float32))).to(
        getattr(torch, dtype))
    y = (x.float() @ w.float())
    mdm = stat_abft.min_detectable_magnitude(x, w)
    # rows 0-2 get 1.5x the detectable delta, rows 3-5 nothing
    delta = torch.zeros_like(y)
    delta[:3, 0, 7] = 1.5 * mdm[:3, 0]
    y_bad = y + delta
    jy_bad = jnp.asarray(y_bad.numpy())
    np.testing.assert_allclose(stat_abft.threshold(x, w).numpy(),
                               np.asarray(jstat.threshold(jx, jw)),
                               rtol=1e-6)
    np.testing.assert_allclose(
        stat_abft.residuals(x, w, y_bad).numpy(),
        np.asarray(jstat.residuals(jx, jw, jy_bad)), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(mdm.numpy(), np.asarray(
        jstat.min_detectable_magnitude(jx, jw)), rtol=1e-6)
    w_sum, w_abs_sum = stat_abft.weight_sums(w)
    got = stat_abft.detect(x, w, y_bad, w_sum, w_abs_sum)
    assert torch.equal(got, stat_abft.detect(x, w, y_bad))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jstat.detect(jx, jw, jy_bad)))
    assert got[:3].all() and not got[3:].any()


def test_nan_residual_escapes_detect_and_is_counted_apart():
    """A NaN in a row's output makes its residual NaN, which ``|r| > tau``
    never flags, in the reference and in ``detect`` alike (ROADMAP Queue C
    item 6); ``detect_and_nan`` returns the same flags and the NaN rows
    apart."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 1, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 96)) / 8).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    y = tx @ tw
    y[1, 0, 3] = float("nan")
    y[2, 0, 0] += 1.5 * float(stat_abft.min_detectable_magnitude(tx, tw)[2])
    want = np.asarray(jstat.detect(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(y.numpy())))
    flags, nan = stat_abft.detect_and_nan(tx, tw, y)
    np.testing.assert_array_equal(flags.numpy(), want)
    assert torch.equal(flags, stat_abft.detect(tx, tw, y))
    assert flags[:, 0].tolist() == [False, False, True, False]
    assert nan[:, 0].tolist() == [False, True, False, False]


@pytest.mark.parametrize("mode", ["stat_abft", "faulty"])
def test_nan_only_window_rolls_back(mode):
    """A window whose faults made only NaN residuals (no statistical
    detection) is replayed in stat_abft, where the reference would keep
    its tokens; detections and the heatmap stay 0, ``nan_rows`` counts
    them. Faulty mode keeps the corrupted token. The decode loop is
    driven by stub callables: step 5's faulted pass reports 2 NaN rows and
    emits token 999."""
    dcfg = ar.DecodeConfig(steps=8, window=3, mode=mode,
                           monitor_target_ber=3e-3)

    def prefill(params, tokens):
        return torch.zeros((2,), dtype=torch.long), None

    def step(params, cache, tok, i, monitor, src, ber_scale):
        hit = i == 5 and ber_scale == 1.0
        nan = torch.tensor(2) if hit else 0
        nxt = torch.full((2,), 999 if hit else i, dtype=torch.long)
        return nxt, cache, monitor, 0, nan, 0.0
    out = ar.decode_batch(ar.DecoderFns(dcfg, prefill, step), None,
                          torch.zeros((2, ar.PROMPT_LEN), dtype=torch.long),
                          dvfs.ber_monitor_init("cpu"), None)
    assert out.detections == 0 and int(out.heatmap.sum()) == 0
    assert out.nan_rows == 2.0
    if mode == "stat_abft":
        assert out.rollbacks == 1 and out.n_model_evals == 1 + 7 + 3
        assert out.tokens[0].tolist() == [0, 1, 2, 3, 4, 5, 6, 7]
    else:
        assert out.rollbacks == 0 and out.n_model_evals == 8
        assert out.tokens[0, 5] == 999


def test_unit_roundoff_follows_finfo():
    """eps / 2 as the reference computes it: 2^-8 for bf16 (its docstring
    says 2^-9), 2^-24 for f32."""
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        assert stat_abft.unit_roundoff(dt) == jstat.unit_roundoff(jdt)
    assert stat_abft.unit_roundoff(torch.bfloat16) == 2.0 ** -8


@pytest.mark.parametrize("blk", [128, 32])
@pytest.mark.parametrize("thr", [0, 1 << 10])
def test_stat_abft_matmul_matches_pallas(blk, thr):
    """Bit-equal c and row-tile flags against the Pallas composite, with
    a bit-31 flip and low and high single-bit flips. At tile 128 the port
    sums four 32-column checksums."""
    rng = np.random.default_rng(blk + thr)
    m, k, n = 128, 96, 256
    aq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    bq = rng.integers(-127, 128, (k, n), dtype=np.int8)
    flips = np.zeros((m, n), np.uint32)
    flips[3, 5] = 1 << 31
    flips[9, 200] = 1 << 4           # below 1 << 10
    flips[70, 40] = 1 << 20
    want_c, want_d = jstat.stat_abft_matmul(
        jnp.asarray(aq), jnp.asarray(bq), jnp.asarray(flips), thr,
        bm=blk, bn=blk, bk=32, interpret=True)
    got_c, got_d = stat_abft.stat_abft_matmul(
        torch.from_numpy(aq), torch.from_numpy(bq),
        torch.from_numpy(flips.view(np.int32)), thr, bm=blk, bn=blk)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    assert got_d.shape == (m, n // blk)
    assert bool(got_d[70, 40 // blk])
    assert bool(got_d[9, 200 // blk]) == (thr == 0)
    # |INT32_MIN| wraps negative: the bit-31 flip is never flagged.
    assert not bool(got_d[3, 0])


def test_stat_abft_matmul_rejects_unaligned_tiles():
    a = torch.zeros((64, 32), dtype=torch.int8)
    b = torch.zeros((32, 64), dtype=torch.int8)
    f = torch.zeros((64, 64), dtype=torch.int32)
    with pytest.raises(ValueError):
        stat_abft.stat_abft_matmul(a, b, f, 0, bm=48, bn=32)
    with pytest.raises(ValueError):
        stat_abft.stat_abft_matmul(a, b, f, 0, bm=128, bn=32)


# ---------------------------------------------------------------- drift_gemm
def _jax_drift_flips(key, ber, mp, np_):
    """``ops.drift_gemm``'s own mask over the padded grid, as int32."""
    kf, kb = jax.random.split(key)
    p = jfault.word_flip_prob(ber)
    flip = jax.random.uniform(kf, (mp, np_)) < p
    pos = jax.random.randint(kb, (mp, np_), 0, 32, dtype=jnp.uint32)
    m = jnp.where(flip, jnp.left_shift(jnp.uint32(1), pos), jnp.uint32(0))
    return np.asarray(m).view(np.int32)


@pytest.mark.parametrize("with_ckpt", [False, True])
def test_drift_gemm_matches_jax(with_ckpt):
    """Against ``ops.drift_gemm(bm=bn=bk=32)`` on a ragged 70x50x90 GEMM
    with the same mask: row and column differences and the flagged-tile
    count (padding included) equal, y within 1e-6 relative (dequantize
    and splice are f32 elementwise, the same ops)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((70, 50)).astype(np.float32)
    w = rng.standard_normal((50, 90)).astype(np.float32)
    ck = rng.standard_normal((70, 90)).astype(np.float32) if with_ckpt \
        else None
    key = jax.random.PRNGKey(9)
    ber = jnp.float32(3e-3)
    want = jops.drift_gemm(jnp.asarray(x), jnp.asarray(w),
                           None if ck is None else jnp.asarray(ck), key, ber,
                           bm=32, bn=32, bk=32, interpret=True)
    mp, np_ = ops.padded_shape(70, 90)
    flips = torch.from_numpy(_jax_drift_flips(key, ber, mp, np_))
    got = ops.drift_gemm(torch.from_numpy(x), torch.from_numpy(w),
                         None if ck is None else torch.from_numpy(ck),
                         flips)
    np.testing.assert_array_equal(got.row_diff.numpy(),
                                  np.asarray(want.row_diff))
    np.testing.assert_array_equal(got.col_diff.numpy(),
                                  np.asarray(want.col_diff))
    assert int(got.n_flagged_tiles) == int(want.n_flagged_tiles) > 0
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y),
                               rtol=1e-6, atol=0)
    plain = ops.drift_gemm_plain(torch.from_numpy(x), torch.from_numpy(w),
                                 None if ck is None else torch.from_numpy(ck),
                                 flips)
    assert torch.equal(plain.y, got.y)
    with pytest.raises(ValueError):
        ops.drift_gemm(torch.from_numpy(x), torch.from_numpy(w), None, flips,
                       bm=128, bn=128, bk=128)


def test_cpu_calls_count_no_launches():
    n0 = (tfi.launches, tak.launches, trk.launches)
    tfi.fault_inject(torch.zeros(8), torch.ones(8, dtype=torch.int32))
    stat_abft.stat_abft_matmul(torch.zeros((32, 32), dtype=torch.int8),
                               torch.zeros((32, 32), dtype=torch.int8),
                               torch.zeros((32, 32), dtype=torch.int32), 0,
                               bm=32, bn=32)
    ops.drift_gemm(torch.ones((4, 8)), torch.ones((8, 4)), None,
                   torch.zeros((32, 32), dtype=torch.int32))
    assert (tfi.launches, tak.launches, trk.launches) == n0


# ----------------------------------------------------------------- decode
def test_stat_abft_context_matches_reference_semantics():
    """BER 0: the clean product, no detections, no draw; an aggressive BER
    on a replayed site perturbs the output and reports detections, with
    the reference's counts."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 1, 64)).astype(np.float32)
    w = rng.standard_normal((64, 128)).astype(np.float32)
    run_key = jax.random.PRNGKey(0)
    proj = transformer.Proj(torch.from_numpy(w),
                            *stat_abft.weight_sums(torch.from_numpy(w)))
    src = JaxReplayFlipSource(run_key)
    zeros = np.zeros((dvfs.N_CLASSES,), np.float32)
    ctx0 = ar.StatAbftContext(src, 0, 0, zeros, detect=True)
    y0 = ctx0.matmul(torch.from_numpy(x), proj, name="attn.q",
                     rclass=dvfs.CLASS_BODY)
    assert torch.equal(y0, torch.from_numpy(x) @ torch.from_numpy(w))
    assert int(ctx0.stats["detected_rows"]) == 0 and not src.calls
    assert ctx0.stats["gemm_words"] == 4 * 128

    hot = np.full((dvfs.N_CLASSES,), 3e-2, np.float32)
    ctx1 = ar.StatAbftContext(src, 0, 0, hot, detect=True)
    y1 = ctx1.matmul(torch.from_numpy(x), proj, name="attn.q",
                     rclass=dvfs.CLASS_BODY)
    jctx = jar.StatAbftContext(
        jax.random.fold_in(jax.random.fold_in(run_key, 0), 0),
        jnp.int32(0), jnp.asarray(hot), detect=True)
    jy1 = jctx.matmul(jnp.asarray(x), jnp.asarray(w), name="attn.q",
                      rclass=dvfs.CLASS_BODY)
    np.testing.assert_array_equal(y1.numpy().view(np.int32),
                                  np.asarray(jy1).view(np.int32))
    assert int(ctx1.stats["detected_rows"]) == int(
        jctx.stats["detected_rows"]) > 0
    assert not torch.equal(y1, y0)


def test_protected_words_and_prompts():
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    for smoke in (True, False):
        c = configs.get_config(ARCH, smoke=smoke)
        jc = jconfigs.get_config(ARCH, smoke=smoke)
        assert ar.protected_words_per_step(c, 2) == \
            jar.protected_words_per_step(jc, 2)
    p = ar.prompt_tokens(configs.get_config(ARCH, smoke=True), [0, 1, 0])
    assert p.shape == (3, ar.PROMPT_LEN) == (3, jar.PROMPT_LEN)
    assert torch.equal(p[0], p[2]) and not torch.equal(p[0], p[1])
    assert int(p.min()) >= 0 and int(p.max()) < jcfg.vocab


@pytest.fixture(scope="module")
def lm_setup():
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    np_params = lm_jax_params(jcfg)
    prompts = np.asarray(jar.prompt_tokens(jcfg, [0, 1]))
    return jcfg, np_params, prompts


@pytest.mark.parametrize("mode", ["clean", "faulty", "stat_abft"])
def test_decode_batch_matches_jax(lm_setup, mode):
    """8 tokens, window 3, undervolt table (nominal_steps 2, layer 0 at
    BER 0), the reference's masks: tokens, per-step detection heatmap,
    detections, rollbacks, evaluations and the monitor's ladder index all
    equal. With these seeds every faulted window detects, so stat_abft
    rolls back 3 windows and its tokens equal the clean decode's, while
    faulty mode's tokens leave it."""
    jcfg, np_params, prompts = lm_setup
    cfg = configs.get_config(ARCH, smoke=True)
    run_key = jax.random.fold_in(jax.random.PRNGKey(3), 0)
    sched = (None if mode == "clean"
             else dvfs.fine_grained_schedule(STEPS, dvfs.UNDERVOLT))
    jsched = (None if mode == "clean"
              else jdvfs.fine_grained_schedule(STEPS, jdvfs.UNDERVOLT))
    jf = jar.make_decoder(jcfg, jar.DecodeConfig(STEPS, WINDOW, mode, 3e-3),
                          schedule=jsched)
    want = jar.decode_batch(jf, jax.tree.map(jnp.asarray, np_params),
                            jnp.asarray(prompts), jdvfs.ber_monitor_init(),
                            run_key)
    fns = ar.make_decoder(cfg, ar.DecodeConfig(STEPS, WINDOW, mode, 3e-3),
                          schedule=sched)
    got = ar.decode_batch(fns, transformer.params_from_jax(np_params),
                          torch.from_numpy(prompts), dvfs.ber_monitor_init(
                              "cpu"), JaxReplayFlipSource(run_key))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.heatmap.numpy(),
                                  np.asarray(want.heatmap))
    assert got.detections == want.detections
    assert got.rollbacks == want.rollbacks
    assert got.n_model_evals == want.n_model_evals
    assert got.n_words == want.n_words
    assert int(got.monitor.op_index) == int(want.monitor.op_index)
    if mode == "stat_abft":
        assert got.detections > 0 and got.rollbacks == 3
        assert got.n_model_evals == 1 + 2 * (STEPS - 1)
    if mode == "faulty":
        clean = ar.decode_batch(
            ar.make_decoder(cfg, ar.DecodeConfig(STEPS, WINDOW, "clean",
                                                 3e-3)),
            transformer.params_from_jax(np_params),
            torch.from_numpy(prompts), dvfs.ber_monitor_init("cpu"), None)
        assert not torch.equal(got.tokens, clean.tokens)


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def jax_engine_run(lm_setup):
    """One reference engine run: 2 olmo-1b-smoke requests in stat_abft at
    undervolt, 8 tokens, window 3 (plus its clean reference)."""
    jcfg, np_params, prompts = lm_setup
    eng = JaxEngine(bucket=2, base_seed=0)
    eng._params[(ARCH, True)] = jax.tree.map(jnp.asarray, np_params)
    for s in (0, 1):
        eng.submit(arch=ARCH, steps=STEPS, mode="stat_abft", op="undervolt",
                   seed=s, rollback_interval=WINDOW)
    return eng.run()


def _port_engine(np_params, prompts):
    eng = DriftServeEngine(arch=ARCH, smoke=True, bucket=2, base_seed=0,
                           device="cpu",
                           flip_source_factory=jax_replay_factory(0))
    eng.set_params(ARCH, True, transformer.params_from_jax(np_params))
    eng.servable_for(ARCH).batch_inputs = lambda cfg, seeds: (
        torch.from_numpy(prompts),)
    return eng


def test_engine_matches_jax_engine(lm_setup, jax_engine_run):
    """The port's engine on the CPU, through its CLI: per request tokens,
    token match, detections, rollbacks and evaluations equal the
    reference engine's, and so, with ==, does the perfmodel attribution
    (replayed decodes billed as compute_replay); 2 builds (stat_abft and
    its clean reference)."""
    _, np_params, prompts = lm_setup
    eng = _port_engine(np_params, prompts)
    got = serve.main(["--arch", ARCH, "--steps", str(STEPS), "--requests",
                      "2", "--rollback-interval", str(WINDOW), "--device",
                      "cpu"], engine=eng)
    want = jax_engine_run
    assert [r.mode for r in got] == ["stat_abft", "stat_abft"]
    for g, w in zip(got, want):
        assert g.tokens == w.tokens and len(g.tokens) == STEPS
        assert g.token_match_vs_clean == w.token_match_vs_clean == 1.0
        assert g.ar_detections == w.ar_detections > 0
        assert g.ar_rollbacks == w.ar_rollbacks >= 1
        assert g.n_model_evals == w.n_model_evals > STEPS
        assert g.latents is None and g.op == w.op == "undervolt"
        assert g.monitor_op_index == w.monitor_op_index
        for f in ("energy_j", "baseline_energy_j", "latency_s",
                  "baseline_latency_s", "completed_at_s"):
            assert getattr(g, f) == getattr(w, f), f
        assert g.energy_breakdown == w.energy_breakdown
        assert energy.ledger_total(g.energy_breakdown) == g.energy_j
        # evals = 1 prefill + STEPS decodes + replays; nominal_steps 2
        replays = g.n_model_evals - 1 - STEPS
        assert g.energy_breakdown["compute_replay"] > 0
        assert g.energy_breakdown["compute_replay"] / g.energy_breakdown[
            "compute_aggressive"] == pytest.approx(
                replays / (g.n_model_evals - 2 - replays))
    assert eng.cache.builds == 2
    assert eng.stats.clean_samples_computed == 1
    assert int(eng.monitor.n_updates) == STEPS - 1


def test_engine_serves_both_paradigms_and_rejects_unported():
    """One engine holds both servables; modes outside a paradigm raise,
    and the enc-dec and VLM archs raise ``UnsupportedArchError`` with the
    reference's reason, as the reference's engine does. The diffusion
    paradigm takes every mode, the Fig 12 baselines included
    (stat_abft there is the tile-recompute baseline)."""
    eng = DriftServeEngine(device="cpu")
    assert eng.servable_for(ARCH).paradigm == "autoregressive"
    assert eng.servable.paradigm == "diffusion"
    with pytest.raises(ValueError, match="autoregressive serving"):
        eng.submit(arch=ARCH, mode="drift")
    for arch in ("whisper-base", "internvl2-76b"):
        family = jconfigs.get_config(arch).family
        with pytest.raises(UnsupportedArchError) as err:
            eng.submit(arch=arch, mode="stat_abft")
        assert str(err.value) == \
            f"arch {arch!r}: {JAX_UNSUPPORTED[family]}"
        assert isinstance(err.value, ValueError)
    assert len(eng.queue) == 0
    eng.submit(steps=2, mode="stat_abft", op="undervolt", seed=0)
    eng.submit(arch=ARCH, steps=3, mode="faulty", op="undervolt", seed=0)
    dif, res = eng.run()
    assert dif.mode == "stat_abft" and dif.tokens is None
    assert res.tokens is not None and len(res.tokens) == 3
    assert res.ar_rollbacks == 0 and res.mode == "faulty"


@pytest.mark.parametrize("field,value", [("taylorseer", True),
                                         ("precision", "int8-body6")])
def test_ar_rejects_diffusion_knobs(field, value):
    """TaylorSeer and precision plans are diffusion knobs: an AR request
    setting one raises at submit with the reference's reason."""
    eng = DriftServeEngine(device="cpu")
    with pytest.raises(ValueError, match="does not apply to token decoding"
                       if field == "taylorseer" else "do not apply to token "
                       "decoding"):
        eng.submit(arch=ARCH, mode="stat_abft", **{field: value})
    assert len(eng.queue) == 0


def test_cli_default_mode_per_paradigm():
    assert serve.default_mode_for(ARCH) == "stat_abft"
    assert serve.default_mode_for("dit-xl-512") == "drift"
    ap = serve.build_parser()
    assert ap.parse_args(["--arch", ARCH]).mode is None
    assert ap.parse_args(["--mode", "dmr"]).mode == "dmr"
    with pytest.raises(SystemExit):
        ap.parse_args(["--mode", "tmr"])
