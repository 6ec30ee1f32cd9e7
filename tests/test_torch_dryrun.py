"""The port's dry-run, op counter and roofline against the JAX package's.

The reference's dry-run does not run under jax 0.9.0 (its meshes lose
their axes; ROADMAP Queue C), so the port is held to the reference's
pure-Python pieces (``perfmodel.flops.cell_flops``, ``roofline_row``),
to the hand-counted programs of ``tests/test_hlo_analysis.py`` (the
reference's analyzer counting them too), and to itself: each kernel
wrapper's count on meta tensors against its count on CPU tensors and its
``work``, a SMOKE DiT drift evaluation on meta against the same call on
CPU tensors, and the ``CountingMesh`` against one process and a real
2-rank gloo mesh.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.launch import hlo_analysis as jH
from repro.launch import roofline as jroof
from repro.perfmodel import flops as jflops
from repro.perfmodel.hw import TPU_V5E
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.core import fault
from repro_torch.kernels import abft_matmul as tak
from repro_torch.kernels import fault_inject as tfi
from repro_torch.kernels import flash_attention as tfk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rollback_correct as trk
from repro_torch.launch import dryrun, mesh as mesh_lib, op_analysis as H
from repro_torch.launch import roofline
from repro_torch.models import dit
from repro_torch.perfmodel import flops
from repro_torch.perfmodel.hw import H100, H100_SXM
from repro_torch.train import steps

import test_torch_train_sharded as ts

DOT = 2 * 128 ** 3          # flops of one 128^3 matmul


def _jax_count(fn, *args):
    return jH.analyze(jax.jit(fn).lower(*args).compile().as_text())


A = jax.ShapeDtypeStruct((128, 128), jnp.float32)
W8 = jax.ShapeDtypeStruct((8, 128, 128), jnp.float32)


def _stack(x, w):
    for wi in w:
        x = x @ wi
    return x.sum()


def _jstack(x, w):
    y, _ = jax.lax.scan(lambda c, wi: (c @ wi, None), x, w)
    return y.sum()


# ------------------------------------------------------ model FLOPs
@pytest.mark.parametrize("arch", list(jconfigs.ALL_ARCHS))
def test_cell_flops_match_reference(arch):
    """``model_flops`` and ``tokens`` of every cell ``==`` the
    reference's ``cell_flops``; the cells and the registry's order are
    the reference's."""
    assert shapes.cells_for(arch) == jshapes.cells_for(arch)
    assert configs.list_archs() == jconfigs.list_archs()
    for cell in shapes.cells_for(arch):
        got = flops.cell_flops(configs.get_config(arch),
                               shapes.get_shape(cell))
        want = jflops.cell_flops(jconfigs.get_config(arch),
                                 jshapes.get_shape(cell))
        assert got == want, (arch, cell)


# ------------------------------------------------------ the counter
def test_single_dot():
    a = torch.randn(128, 128)
    assert H.analyze(torch.mm, a, a)["flops"] == DOT == \
        _jax_count(lambda x, y: x @ y, A, A)["flops"]


def test_bytes_counts_dot_traffic():
    """Exact here: two operands plus the result (the reference's rule,
    which its own test bounds from below)."""
    a = torch.randn(128, 128)
    got = H.analyze(torch.mm, a, a)
    assert got["bytes"] == 3 * 128 * 128 * 4
    assert _jax_count(lambda x, y: x @ y, A, A)["bytes"] >= got["bytes"]


def test_scan_multiplies_by_trip_count():
    got = H.analyze(_stack, torch.randn(128, 128), torch.randn(8, 128, 128))
    assert got["flops"] == 8 * DOT == _jax_count(_jstack, A, W8)["flops"]


def test_grad_scan_counts_both_loops():
    x = torch.randn(128, 128, requires_grad=True)
    w = torch.randn(8, 128, 128, requires_grad=True)
    got = H.analyze(lambda: torch.autograd.grad(_stack(x, w), (x, w)))
    want = _jax_count(jax.value_and_grad(_jstack, argnums=(0, 1)), A, W8)
    assert got["flops"] == 24 * DOT == want["flops"]   # 8 fwd + 16 bwd


def test_conv_flops():
    x = torch.randn(1, 8, 16, 16)
    k = torch.randn(16, 8, 3, 3)
    got = H.analyze(lambda a, b: torch.nn.functional.conv2d(a, b, padding=1),
                    x, k)
    want = _jax_count(
        lambda a, b: jax.lax.conv_general_dilated(
            a, b, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")),
        jax.ShapeDtypeStruct((1, 16, 16, 8), jnp.float32),
        jax.ShapeDtypeStruct((3, 3, 8, 16), jnp.float32))
    assert got["flops"] == 2 * 16 * 16 * 16 * (3 * 3 * 8) == want["flops"]


def test_views_and_broadcasts_move_no_extra_bytes():
    """A view moves nothing; a broadcast operand counts its source once;
    an in-place copy counts what it writes and what it reads."""
    x = torch.randn(64, 32)
    b = torch.randn(32)
    assert H.analyze(lambda: x.t()[1:].unsqueeze(0))["bytes"] == 0
    assert H.analyze(torch.add, x, b)["bytes"] == (64 * 32 * 2 + 32) * 4
    y = torch.empty(64, 32)
    assert H.analyze(y.copy_, x)["bytes"] == 2 * 64 * 32 * 4


def _wrapper_calls():
    rng = np.random.default_rng(5)
    m, k, n = 64, 96, 128
    aq = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    bq = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    flips = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, (m, n),
                                          dtype=np.int32))
    c, ck = torch.randn(m, n), torch.randn(m, n)
    rd = torch.from_numpy(rng.integers(-2048, 2048, (m, n // 32),
                                       dtype=np.int32))
    cd = torch.from_numpy(rng.integers(-2048, 2048, (m // 32, n),
                                       dtype=np.int32))
    q = torch.randn(2, 40, 4, 16)
    kv = torch.randn(2, 40, 2, 16)
    q3 = torch.randn(6, 24, 16)
    return {
        "abft_matmul": (tak.abft_matmul, (aq, bq, flips), {},
                        tak.work(m, k, n)),
        "rollback_correct": (trk.rollback_correct, (c, ck, rd, cd, 1024),
                             {}, trk.work(m, n)),
        "drift_gemm_fused": (tops.drift_gemm_fused,
                             (aq, bq, flips, torch.tensor(0.01),
                              torch.ones(n), ck, 1024),
                             dict(valid=(m, n)),
                             tops.work(m, k, n, flip_words=m * n)),
        "fault_inject": (tfi.fault_inject, (c, flips), {},
                         tfi.work(m * n)),
        "mha_flash": (tfk.mha_flash, (q, kv, kv),
                      dict(causal=True, window=9),
                      tfk.work(2, 40, 4, 2, 16, 4, True, 9)),
        "flash_attention": (tfk.flash_attention, (q3, q3, q3),
                            dict(causal=True),
                            tfk.work(6, 24, 1, 1, 16, 4, True)),
    }


@pytest.mark.parametrize("name", list(_wrapper_calls()))
def test_kernel_count_meta_equals_cpu_and_work(name):
    """Each wrapper counts its kernel's ``work`` once, on meta tensors
    and on CPU tensors alike (its plain version's ops not counted), and
    takes meta tensors only under a count."""
    fn, args, kw, work = _wrapper_calls()[name]
    cpu = H.analyze(fn, *args, **kw)
    meta = H.analyze(fn, *(a.to("meta") if isinstance(a, torch.Tensor)
                           else a for a in args), **kw)
    for key in ("flops", "int8_ops", "bytes"):
        assert cpu[key] == meta[key] == work[key], key
    kernel = {"mha_flash": "flash_attention"}.get(name, name)
    assert cpu["kernels"] == meta["kernels"] == {kernel: 1}
    with pytest.raises(ValueError, match="only inside"):
        fn(*(a.to("meta") if isinstance(a, torch.Tensor) else a
             for a in args), **kw)


def test_attn_pairs_closed_form():
    """``attn_pairs`` against a row-by-row count, causal or not, windows
    shorter and longer than the sequence."""
    for s in (1, 7, 33):
        for causal in (True, False):
            for w in (0, 1, 5, 33, 40):
                want = sum((r if causal else s - 1)
                           - (max(0, r - w + 1) if w else 0) + 1
                           for r in range(s))
                assert tfk.attn_pairs(s, causal, w) == want


def test_dit_drift_evaluation_meta_equals_cpu():
    """One SMOKE DiT drift evaluation (``dryrun.drift_sample_step``) on
    meta tensors counts exactly what it counts on CPU tensors; every GEMM
    goes through the fused drift kernel, one launch each."""
    cfg = configs.get_config("dit-xl-512", smoke=True)
    g = torch.Generator()
    g.manual_seed(3)
    params = dit.init_params(cfg, 3)
    lat = torch.randn((2, cfg.latent_size, cfg.latent_size,
                       cfg.latent_channels), generator=g)
    args = (params, lat, 500, torch.tensor([1, 2]),
            *dit.drift_store_spec(cfg, 2))
    kw = dict(flip_source=fault.PhiloxFlipSource(3, 0, "cpu"))
    step = dryrun.drift_sample_step(cfg)
    cpu = H.analyze(step, *args, **kw)
    meta = H.analyze(step, *dryrun.to_meta(args), **kw)
    for key in ("flops", "int8_ops", "bytes", "kernels"):
        assert cpu[key] == meta[key], key
    gemms = 4 + 6 * cfg.n_layers        # embeddings + 6 a block
    assert meta["kernels"] == {"drift_gemm_fused": gemms,
                               "flash_attention": cfg.n_layers}


# ------------------------------------------------------ roofline
def _report():
    return {"arch": "olmo-1b", "shape": "train_4k", "mesh": [16, 16],
            "n_devices": 256, "hlo_flops_per_device": 3.1e14,
            "hlo_bytes_per_device": 7.7e11,
            "collective_bytes_per_device": 4.4e9, "model_flops": 8.2e15,
            "compile_s": 1.0}


def test_roofline_row_matches_reference():
    """Given the reference's ``TPU_V5E`` constants, the port's row of a
    reference report ``==`` the reference's row (every key the two share;
    the per-rank FLOPs under the port's name)."""
    tpu = H100(peak_flops_bf16=TPU_V5E.peak_flops_bf16,
               hbm_bytes_per_s=TPU_V5E.hbm_bytes_per_s,
               link_bytes_per_s=TPU_V5E.ici_bytes_per_s_per_link)
    rep = _report()
    got = roofline.roofline_row(rep, tpu)
    want = jroof.roofline_row(rep)
    shared = set(got) & set(want)
    assert len(shared) == 11
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert got["flops_per_device"] == want["hlo_flops_per_device"]
    # the port's own report on the H100: the int8 term joins compute
    port = dict(rep, flops_per_device=rep["hlo_flops_per_device"],
                bytes_per_device=rep["hlo_bytes_per_device"],
                int8_ops_per_device=1.979e15)
    row = roofline.roofline_row(port)
    assert row["t_compute_s"] == 3.1e14 / 989e12 + 1.0
    assert row["dominant"] == "compute"
    assert roofline.advice(row) == roofline._ADVICE["compute"]


def test_h100_constants():
    assert (H100_SXM.peak_flops_bf16, H100_SXM.peak_ops_int8,
            H100_SXM.peak_flops_f32, H100_SXM.hbm_bytes_per_s,
            H100_SXM.hbm_bytes, H100_SXM.link_bytes_per_s) == (
        989e12, 1979e12, 67e12, 3.35e12, 80e9, 450e9)


# ------------------------------------------------------ dry-run cells
def test_lower_cell_report_and_cli(tmp_path, capsys):
    """One cell through ``lower_cell`` and the CLI: the reference's keys,
    ``model_flops`` and ``tokens`` from ``cell_flops``, the per-rank
    counts; the CLI writes one JSON a cell, skips it on a second run, and
    the roofline reads it. ``dp_only`` raises."""
    rep = dryrun.lower_cell("mamba2-370m", "decode_32k", (2, 16, 16))
    want = jflops.cell_flops(jconfigs.get_config("mamba2-370m"),
                             jshapes.get_shape("decode_32k"))
    assert (rep["model_flops"], rep["tokens"]) == (want["model_flops"],
                                                   want["tokens"])
    assert rep["n_devices"] == 512 and rep["axes"] == ["pod", "data",
                                                       "model"]
    assert rep["flops_per_device"] > 0 and rep["bytes_per_device"] > 0
    assert rep["collective_ops_executed"] > 0
    assert rep["argument_bytes_per_device"] > 0
    argv = ["--arch", "mamba2-370m", "--shape", "decode_32k", "--mesh",
            "card", "--out", str(tmp_path)]
    dryrun.main(argv)
    dryrun.main(argv)
    out = capsys.readouterr().out
    assert "all cells passed" in out and "[skip]" in out
    (path,) = tmp_path.glob("*.json")
    assert path.name == "mamba2-370m_decode_32k_card.json"
    card = json.loads(path.read_text())
    assert card["collective_bytes_per_device"] == 0
    roofline.main(["--dir", str(tmp_path), "--markdown"])
    assert "| mamba2-370m | decode_32k | 1x1 |" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dryrun.lower_cell("olmo-1b", "train_4k", (16, 16), opt="dp_only")


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "kimi-k2-1t-a32b"])
def test_moe_train_cells_count(arch, mesh):
    """The MoE archs' ``train_4k`` cells count on one rank of (16, 16) and
    (2, 16, 16): every MoE layer routes the global batch, so each data
    rank runs the whole batch's experts and the useful FLOPs fall well
    under 1/16; each layer's gather sends at least the ring's share of
    the global tokens, bf16 forward and the f32 gradient backward."""
    shape, axes = dryrun.MESHES[mesh]
    rep = dryrun.lower_cell(arch, "train_4k", shape, axes=axes)
    n = rep["n_devices"]
    assert rep["model_flops"] / (rep["flops_per_device"] * n) < 1 / 32
    cfg = configs.get_config(arch)
    spec = shapes.get_shape("train_4k")
    tokens = spec.global_batch * spec.seq_len
    nd = n // shape[-1]
    gather = 2 * (nd - 1) / nd * tokens * cfg.d_model * (2 + 4)
    assert rep["collective_bytes_per_device"] >= cfg.n_layers * gather
    assert rep["collective_ops_executed"] > 0


# ------------------------------------------------------ CountingMesh
def _train_count(mesh_shape, rank=0):
    """One step's count on meta tensors (a rank's collectives return its
    own values, which would fail the step's equal-loss check on real
    ones)."""
    cfg, ocfg, state = ts.init_state("olmo-1b")
    state, batch = dryrun.to_meta((state, ts.batches(cfg, 1)[0]))
    if mesh_shape is None:
        return H.analyze(steps.make_train_step(cfg, ocfg), state, batch)
    mesh = H.CountingMesh(mesh_shape, ("data", "model"), "meta", rank)
    st = ts.sharding.shard_state(state, mesh)
    out = H.analyze(steps.make_train_step(cfg, ocfg, mesh=mesh), st, batch)
    assert out["collective_ops_executed"] == mesh.collectives
    return out


def _gloo_rank(rank: int, tmp: str) -> None:
    torch.set_num_threads(1)
    mesh = mesh_lib.make_mesh((2, 1), ("data", "model"), device="cpu",
                              init_method=f"file://{tmp}/rdzv", rank=rank,
                              world_size=2, timeout_s=ts.TIMEOUT_S)
    cfg, ocfg, state = ts.init_state("olmo-1b")
    st = ts.sharding.shard_state(state, mesh)
    step = steps.make_train_step(cfg, ocfg, mesh=mesh)
    n0 = mesh.collectives
    step(st, ts.batches(cfg, 1)[0])
    torch.save(mesh.collectives - n0, f"{tmp}/coll{rank}.pt")
    torch.distributed.destroy_process_group()


def test_counting_mesh_against_one_process_and_gloo(tmp_path):
    """A SMOKE olmo-1b train step (batch 4, seq 16):
    - on (2, 1) the two ranks' FLOPs sum to one process's within 1e-9
      relative (each rank computes its half of the batch);
    - on (1, 2) each rank's FLOPs equal one process's (the model axis
      computes the whole block on every rank);
    - a rank's collectives on (2, 1) equal, in number, those a real 2-rank
      gloo mesh runs for the same step (the real mesh counts calls, not
      bytes); every all-reduce is the ring's 2 (n - 1) / n of its
      buffer."""
    one = _train_count(None)
    r0, r1 = _train_count((2, 1), 0), _train_count((2, 1), 1)
    assert one["collective_ops_executed"] == 0
    assert abs(r0["flops"] + r1["flops"] - one["flops"]) <= \
        1e-9 * one["flops"]
    for rank in (0, 1):
        assert _train_count((1, 2), rank)["flops"] == one["flops"]
    assert r0["collectives"]["all-reduce"] == r0["collective_bytes"] > 0

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank, args=(r, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(ts.JOIN_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert [p.exitcode for p in procs] == [0, 0]
    for rank in (0, 1):
        real = torch.load(tmp_path / f"coll{rank}.pt")
        assert real == r0["collective_ops_executed"] > 0


def test_counting_mesh_ring_bytes():
    """An all-reduce over a group of n sends 2 (n - 1) / n of its bytes;
    a group of one sends nothing; ``sum_bytes`` is an all-reduce of the
    buffer's words."""
    mesh = H.CountingMesh((2, 4, 8), ("pod", "data", "model"))
    t = torch.zeros(1024)
    got = H.analyze(lambda: (mesh.all_reduce(t),
                             mesh.all_reduce(t, group=mesh.data_group),
                             mesh.all_reduce(t, group=mesh.group("model")),
                             mesh.sum_bytes(torch.zeros(256, dtype=torch.uint8),
                                            group=mesh.group("pod")),
                             mesh.barrier()))
    b = 4096
    assert got["collective_bytes"] == (2 * 63 / 64 * b + 2 * 7 / 8 * b
                                       + 2 * 7 / 8 * b + 256)
    assert got["collective_ops_executed"] == mesh.collectives == 5
    assert mesh.coords == {"pod": 0, "data": 0, "model": 0}
    assert H.CountingMesh((2, 4, 8), ("pod", "data", "model"),
                          rank=13).coords == {"pod": 0, "data": 1,
                                              "model": 5}
