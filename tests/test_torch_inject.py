"""Single-bit flips through the ABFT path, and the reference's last four
public helpers, against the reference.

``fault.inject_at`` flips one chosen bit of one chosen word: the tool the
reference's own tests pin detection with, one bit at a time
(``tests/test_core.py``: ``test_abft_detects_iff_above_threshold``,
``test_abft_bit31_flip_detected``). Here it is held bitwise to the
reference's on int32 and float32 words, every bit, with the reference's
behaviour at a negative index, an index past the end and a bit outside
0..31 mirrored; then its flips go through the port's ``abft.detect_int``
and, as one-hot masks, through the plain versions of ``abft_matmul`` and
``drift_gemm_fused`` (what the CUDA kernels are held to on the card),
each against the reference's ``detect_int`` or ``kernels/ref.py``
oracles. The int8 operands are made with numpy from a seed, so no
quantization enters. Last, ``quant.quant_error_bound``,
``rollback.store_bytes`` and ``common.count_params`` ``==`` the
reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:                         # deterministic local fallback
    from _hypothesis_stub import given, settings, st

from repro import configs as jconfigs
from repro.core import abft as jabft
from repro.core import fault as jfault
from repro.core import quant as jquant
from repro.core import rollback as jrollback
from repro.core.exec_ctx import DriftSystemConfig as JCfg
from repro.diffusion import sampler as jsampler
from repro.kernels import ref as jref
from repro.models import common as jcommon
from repro.models import transformer as jtransformer
from repro.train import steps as jsteps
from repro_torch import configs
from repro_torch.core import abft, fault, quant, rollback
from repro_torch.diffusion import sampler
from repro_torch.kernels import abft_matmul as ak
from repro_torch.kernels import ops
from repro_torch.models import common, transformer

from test_torch_train import port_params

THR_BIT = 10
TILE = 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread: these ops are too small to split, and other
    test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _words(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int32)
    return rng.standard_normal(shape).astype(np.float32)


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint32)


def _port_at(x: np.ndarray, idx, bit) -> np.ndarray:
    return fault.inject_at(torch.from_numpy(x.copy()), idx, bit).numpy()


# ------------------------------------------------------------ inject_at
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("shape", [(8, 8), (64, 48), (3, 5, 7)])
def test_inject_at_matches_reference(shape, dtype):
    """Every bit of the first, a middle and the last word, bitwise
    ``==`` the reference's, and that word alone changed."""
    x = _words(shape, dtype, seed=len(shape) * 100 + shape[0])
    n = x.size
    jx = jnp.asarray(x)
    for idx in (0, n // 2, n - 1):
        for bit in range(32):
            got = _port_at(x, idx, bit)
            assert got.dtype == x.dtype and got.shape == x.shape
            want = np.asarray(jfault.inject_at(jx, idx, bit))
            assert np.array_equal(_bits(got), _bits(want)), (idx, bit)
            changed = np.flatnonzero(_bits(got) != _bits(x))
            assert changed.tolist() == [idx]
            assert (_bits(got) ^ _bits(x)).reshape(-1)[idx] == 1 << bit


# The reference's ``.at[].set`` and shift, mirrored: a negative index
# counts from the end, one outside [-n, n) and a bit in [32, 2^32) flip
# nothing; a bit outside [0, 2^32) raises OverflowError (as
# ``jnp.uint32(bit)`` does).
EDGES = [("last from the end", -1, 3), ("first from the end", -64, 2),
         ("before the start", -65, 2), ("one past the end", 64, 5),
         ("far past the end", 1000, 5), ("bit 32", 3, 32), ("bit 40", 3, 40),
         ("bit 2^32 - 1", 3, 2 ** 32 - 1)]


@pytest.mark.parametrize("label,idx,bit", EDGES, ids=[e[0] for e in EDGES])
def test_inject_at_edge_cases_match_reference(label, idx, bit):
    x = _words((8, 8), np.int32, seed=7)
    got = _port_at(x, idx, bit)
    want = np.asarray(jfault.inject_at(jnp.asarray(x), idx, bit))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("bit", [-1, 2 ** 32])
def test_inject_at_bit_out_of_uint32_raises_as_reference(bit):
    x = _words((8, 8), np.int32, seed=8)
    with pytest.raises(OverflowError):
        jfault.inject_at(jnp.asarray(x), 3, bit)
    with pytest.raises(OverflowError):
        fault.inject_at(torch.from_numpy(x), 3, bit)


def test_inject_at_returns_a_new_tensor_and_reads_no_value():
    """The input is left as it was, and on meta tensors (no values at
    all) the flip still runs: nothing is read back to the host."""
    x = torch.from_numpy(_words((4, 6), np.int32, seed=9))
    before = x.clone()
    out = fault.inject_at(x, 5, 31)
    assert torch.equal(x, before) and out.data_ptr() != x.data_ptr()
    assert int(out.view(-1)[5]) == int(before.view(-1)[5]) ^ -2 ** 31
    meta = fault.inject_at(torch.empty((4, 6), dtype=torch.float32,
                                       device="meta"), 5, 31)
    assert meta.device.type == "meta" and meta.dtype == torch.float32
    with pytest.raises(ValueError):
        fault.inject_at(torch.zeros(4, dtype=torch.float16), 1, 1)


# ------------------------------------------------- detection, one flip
def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, (m, k), dtype=np.int8),
            rng.integers(-127, 128, (k, n), dtype=np.int8))


def _acc(aq, bq) -> np.ndarray:
    return aq.astype(np.int32) @ bq.astype(np.int32)


def _reports(acc, aq, bq, idx, bit):
    """(port report, reference report) of ``detect_int`` on the
    accumulator with one flip, at threshold bit 10."""
    got = abft.detect_int(fault.inject_at(torch.from_numpy(acc), idx, bit),
                          torch.from_numpy(aq), torch.from_numpy(bq),
                          abft.AbftConfig(threshold_bit=THR_BIT))
    want = jabft.detect_int(jfault.inject_at(jnp.asarray(acc), idx, bit),
                            jnp.asarray(aq), jnp.asarray(bq),
                            jabft.AbftConfig(threshold_bit=THR_BIT))
    for field, g, w in zip(got._fields, got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), field
    return got


@settings(max_examples=30, deadline=None)
@given(bit=st.integers(min_value=0, max_value=31),
       idx=st.integers(min_value=0, max_value=64 * 48 - 1))
def test_abft_detects_iff_above_threshold(bit, idx):
    """The port of the reference's test: a flipped accumulator bit is
    flagged iff ``bit >= threshold_bit``, on its row and its column, and
    the whole report ``==`` the reference's."""
    aq, bq = _operands(64, 32, 48, seed=bit)
    rep = _reports(_acc(aq, bq), aq, bq, idx, bit)
    detected = int(rep.n_row_err) > 0 and int(rep.n_col_err) > 0
    assert detected == (bit >= THR_BIT)
    if detected:
        assert bool(rep.row_flag[idx // 48]) and bool(rep.col_flag[idx % 48])


def test_abft_bit31_flip_detected():
    """A delta of -2^31 (abs(INT32_MIN) wraps negative) still flags."""
    aq, bq = _operands(32, 32, 32, seed=3)
    rep = _reports(_acc(aq, bq), aq, bq, 5, 31)
    assert int(rep.n_row_err) >= 1 and int(rep.n_col_err) >= 1
    assert int(rep.row_diff[0]) == -2 ** 31


# ------------------------------------------- the kernels' plain versions
def _positions(m, n):
    """(0, 0), a tile corner, the next tile's first element, the last
    valid element."""
    return [(0, 0), (min(31, m - 1), min(31, n - 1)),
            (min(32, m - 1), min(32, n - 1)), (m - 1, n - 1)]


def _one_hot(m, n, i, j, bit) -> torch.Tensor:
    return fault.inject_at(torch.zeros((m, n), dtype=torch.int32),
                           i * n + j, bit)


def _wrap(x) -> np.ndarray:
    return np.asarray(x, np.int64).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("pos", range(4))
def test_abft_matmul_plain_one_hot_flips(pos):
    """``abft_matmul_plain`` under a one-hot mask, every bit: every
    output ``==`` ``ref.abft_matmul_ref``'s, and the per-tile checksum
    differences are the flip's delta (+-2^bit, mod 2^32) in the flipped
    element's tile row and tile column and zero everywhere else."""
    m, k, n = 64, 96, 96
    aq, bq = _operands(m, k, n, seed=11)
    i, j = _positions(m, n)[pos]
    clean = _acc(aq, bq)[i, j]
    ta, tb = torch.from_numpy(aq), torch.from_numpy(bq)
    for bit in range(32):
        flips = _one_hot(m, n, i, j, bit)
        got = ak.abft_matmul_plain(ta, tb, flips)
        want = jref.abft_matmul_ref(jnp.asarray(aq), jnp.asarray(bq),
                                    jnp.asarray(flips.numpy().view(np.uint32)),
                                    TILE, TILE)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), bit
        delta = _wrap(np.int64(clean ^ np.int32(flips[i, j].item()))
                      - np.int64(clean))
        assert abs(int(delta)) == 1 << bit or bit == 31
        row = (got[1] - got[2]).numpy()
        col = (got[3] - got[4]).numpy()
        want_row = np.zeros_like(row)
        want_row[i, j // TILE] = delta
        want_col = np.zeros_like(col)
        want_col[i // TILE, j] = delta
        assert np.array_equal(row, want_row) and np.array_equal(col,
                                                                want_col)


def _ref_drift(aq, bq, flips, sx, sw, ckpt):
    """``abft_matmul_ref``, the dequantization and
    ``rollback_correct_ref`` over the zero-padded operands (union,
    threshold 2^10), unpadded: (out, row_diff, col_diff, tile_flag)."""
    m, k = aq.shape
    n = bq.shape[1]
    mp, np_ = ops.padded_shape(m, n)

    def pad(x, r, c):
        return jnp.pad(jnp.asarray(x), ((0, r - x.shape[0]),
                                        (0, c - x.shape[1])))
    c, act_row, exp_row, act_col, exp_col = jref.abft_matmul_ref(
        pad(aq, mp, k), pad(bq, k, np_),
        pad(flips.view(np.uint32), mp, np_), TILE, TILE)
    row_diff, col_diff = act_row - exp_row, act_col - exp_col
    y = jquant.dequantize_matmul(c[:m, :n], jnp.asarray(sx),
                                 jnp.asarray(sw).reshape(1, -1))
    out, tile_flag = jref.rollback_correct_ref(
        pad(y, mp, np_), pad(ckpt, mp, np_), row_diff, col_diff,
        1 << THR_BIT, TILE, TILE, union=True)
    return (np.asarray(out)[:m, :n], np.asarray(row_diff),
            np.asarray(col_diff), np.asarray(tile_flag))


@pytest.mark.parametrize("mkn", [(64, 96, 64), (50, 40, 70)],
                         ids=["tiled", "ragged"])
@pytest.mark.parametrize("pos", range(4))
def test_drift_gemm_fused_plain_one_hot_flips(mkn, pos):
    """``drift_gemm_fused_plain`` under a one-hot mask, every bit: a
    tile is flagged iff ``bit >= threshold_bit``; where it is, the masked
    elements (the flipped element's row and column within its tile, the
    union policy) take the checkpoint and the rest keep the clean output;
    every output ``==`` the reference's oracles in sequence. The ragged
    shape's M and N are not multiples of 32."""
    m, k, n = mkn
    aq, bq = _operands(m, k, n, seed=m + k + n)
    rng = np.random.default_rng(5)
    sx = np.float32(rng.uniform(1e-3, 1e-2))
    sw = rng.uniform(1e-3, 1e-2, n).astype(np.float32)
    ckpt = rng.standard_normal((m, n)).astype(np.float32)
    i, j = _positions(m, n)[pos]
    t = [torch.from_numpy(v) for v in (aq, bq)]
    ts = [torch.tensor(sx), torch.from_numpy(sw), torch.from_numpy(ckpt)]
    clean = ops.drift_gemm_fused_plain(*t, None, *ts, 1 << THR_BIT)[0]
    for bit in range(32):
        flips = _one_hot(m, n, i, j, bit)
        # counted inside the unpadded region, as the drift path counts
        out, row_diff, col_diff, count = ops.drift_gemm_fused_plain(
            *t, flips, *ts, 1 << THR_BIT, valid=(m, n))
        w_out, w_row, w_col, w_flag = _ref_drift(aq, bq, flips.numpy(), sx,
                                                 sw, ckpt)
        assert np.array_equal(out.numpy().view(np.int32),
                              w_out.view(np.int32)), bit
        assert np.array_equal(row_diff.numpy(), w_row)
        assert np.array_equal(col_diff.numpy(), w_col)
        assert np.array_equal((count > 0).numpy(), w_flag)
        flagged = (count > 0).nonzero().tolist()
        assert flagged == ([[i // TILE, j // TILE]] if bit >= THR_BIT
                           else [])
        masked = np.zeros((m, n), bool)
        if bit >= THR_BIT:
            r0, c0 = i // TILE * TILE, j // TILE * TILE
            masked[i, c0:c0 + TILE] = True
            masked[r0:r0 + TILE, j] = True
        assert int(count.sum()) == int(masked.sum())
        mk = torch.from_numpy(masked)
        assert torch.equal(out[mk], ts[2][mk])
        keep = ~mk
        keep[i, j] = False           # the flipped element, where kept
        assert torch.equal(out[keep], clean[keep])


# ----------------------------------------------------- the other helpers
@pytest.mark.parametrize("k", [1, 16, 4608, 21504, 133143, 133144])
def test_quant_error_bound_matches_reference(k):
    got, want = quant.quant_error_bound(k), jquant.quant_error_bound(k)
    assert type(got) is type(want) is float and got == want


def _largest_contraction(cfg) -> int:
    """The largest K of any protected GEMM the config runs: the model
    width, the FFN width, the attention's heads x head_dim, an SSM's
    inner width, the text width and, for the UNet, a 3x3 convolution
    over a skip concatenation (9 x 2 x the widest channel count)."""
    ks = [cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.hd, cfg.cond_dim]
    if cfg.family in ("ssm", "hybrid"):
        ks.append(cfg.d_inner)
    if cfg.unet_channels:
        ks.append(9 * 2 * max(cfg.unet_channels))
    return max(ks)


@pytest.mark.parametrize("arch", configs.list_archs())
def test_int32_accumulator_headroom(arch):
    """As the reference's ``test_int32_accumulator_headroom``: 127^2 * K
    stays below 2^31 at the largest contraction of every full-width
    config in the port's registry (configs only; no params)."""
    k = _largest_contraction(configs.get_config(arch))
    assert quant.quant_error_bound(k) < 2 ** 31, (arch, k)


def _jax_smoke(arch):
    """The reference's SMOKE config and params of ``arch``, each leaf the
    shape and dtype ``init_model_params`` gives it, in zeros: the counts
    and byte sizes compared here read shapes alone, and tracing the init
    (``eval_shape``) costs a fraction of running it."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    spec = jax.eval_shape(lambda k: jsteps.init_model_params(jcfg, k),
                          jax.random.PRNGKey(0))
    return jcfg, jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), spec)


@pytest.fixture(scope="module")
def smoke_params():
    """The reference's SMOKE params of every arch in the port's
    registry, built once."""
    return {arch: _jax_smoke(arch) for arch in configs.list_archs()}


@pytest.mark.parametrize("arch", configs.list_archs())
def test_count_params_matches_reference(smoke_params, arch):
    jcfg, jparams = smoke_params[arch]
    cfg = configs.get_config(arch, smoke=True)
    got = common.count_params(port_params(cfg, jparams))
    want = jcommon.count_params(jparams)
    assert got == want > 0


def _as_stores(stores) -> tuple:
    """The DiT's (embed, block) stores as they are, a flat store as one."""
    return (stores,) if isinstance(stores, dict) else stores


@pytest.mark.parametrize("arch", ["dit-xl-512", "sd15-unet", "olmo-1b"])
def test_store_bytes_matches_reference(smoke_params, arch):
    """The drift checkpoint stores' bytes: the diffusion samplers'
    (``init_stores``) and ``DriftDecode``'s (``drift_store_spec``), at
    batch 2."""
    jcfg, jparams = smoke_params[arch]
    cfg = configs.get_config(arch, smoke=True)
    b = 2
    if cfg.family in ("dit", "unet"):
        lat = jnp.zeros((b, jcfg.latent_size, jcfg.latent_size,
                         jcfg.latent_channels))
        text = (jnp.zeros((b, jcfg.cond_tokens, jcfg.cond_dim))
                if jcfg.cond_tokens else None)
        cond = None if jcfg.cond_tokens else jnp.zeros((b,), jnp.int32)
        want = jsampler.init_stores(jcfg, jparams, lat, jnp.zeros((b,)),
                                    cond, text, JCfg(mode="drift"))
        got = sampler.init_stores(cfg, b, "cpu")
    else:
        want = jtransformer.drift_store_spec(jcfg, b)
        got = transformer.drift_store_spec(cfg, b)
    got_bytes = sum(rollback.store_bytes(s) for s in _as_stores(got))
    want_bytes = sum(jrollback.store_bytes(s) for s in _as_stores(want))
    assert got_bytes == want_bytes > 0
