"""The DRIFT GEMM: its kernel (``drift_gemm_fused``) and the pipeline
around it (``drift_gemm``).

Counterpart of ``repro.kernels.ops.drift_gemm``: quantize -> fused faulty
ABFT GEMM -> dequantize -> rollback correction, the unit that
``ExecContext``'s ``drift`` mode computes on every protected GEMM. The
reference runs two Pallas kernels (``abft_matmul`` and
``rollback_correct``) with the dequantisation and the checksum
differences between them; the port runs all of that after the
quantization in one CUDA kernel, ``csrc/drift_gemm.cu``, behind
``drift_gemm_fused``. For ``aq (M, K)`` and ``bq (K, N)`` int8, ``flips``
int32 over ``(M, N)`` or the padded ``(Mp, Np)`` grid (or None: no
flips), the activation scale ``sx`` (0-d f32, read on the device), the
column scales ``sw (N,)`` f32 and the checkpoint ``ckpt (M, N)`` f32 (or
None: zeros, as ``rollback.effective_checkpoint`` gives), it returns

    out        (M, N)   f32: where(mask, ckpt, (c * sx) * sw)
    row_diff   (Mp, Nt) int32: per (row, N-tile) checksum differences
    col_diff   (Mt, Np) int32: per (M-tile, column) checksum differences
    tile_count (Mt, Nt) int32: masked elements inside ``valid``

with ``c = (aq @ bq) ^ flips`` and the mask the union (or cross) of each
32x32 tile's flagged rows and columns, exactly as
``abft_matmul`` -> ``rollback_correct`` over the zero-padded operands
compute them. ``valid`` is the region whose masked elements
``tile_count`` counts (the padded grid by default). M, N and K are any
sizes. The kernel's mainloop is ``wgmma`` fed by TMA on 64x128 CTA
tiles (``BM``, ``BN``), which reads both operands K-major: a call
zero-pads A's K to Kp, a multiple of 16, where K is not one (a copy),
and the launcher transposes B into a (N, Kp) buffer first, a second
kernel of the same call (``stat_abft.a_operand`` and
``stat_abft.k_major_plain`` build both operands), except at M <= ``BM``,
where the kernel reads B in place and transposes each K slab in shared
memory (``reads_b_in_place``). At M <= ``BM`` the K slabs also split
over several CTAs a tile, with int32 partials in a workspace
(``launch_plan``). ``drift_gemm_fused_plain`` is today's sequence over
the two kernels' plain versions; ``drift_gemm_fused`` takes it for CPU
tensors only, and a CUDA tensor launches the kernel or raises.
``launches`` counts calls, each one launch of the GEMM kernel (after its
transpose of B where it has one); ``work`` is the kernel's work, which
``launch.op_analysis`` counts for each call and the card check's bound
reads.

``drift_gemm`` is the reference's function on f32 ``x (M, K)`` and ``w
(K, N)``. The reference draws its flips inside, over the padded grid,
from a key and a BER (``ops.py:64-68``); the port takes that mask as an
argument, ``flips (Mp, Np)`` int32, so a test can hand in the
reference's mask. The checksum tile is 32: other tiles raise.
``n_flagged_tiles`` counts the tiles with any masked element over the
whole padded grid, as the reference does (a flip that lands in the
padding can flag a tile). ``drift_gemm_plain`` is the same over the
plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.core.abft import wrap_i32
from repro_torch.kernels import _count, _lib
from repro_torch.kernels import abft_matmul as _abft
from repro_torch.kernels import rollback_correct as _rc
from repro_torch.kernels import stat_abft as _stat

TILE = 32
#: the kernel's CTA tile (BM x BN) and K slab (BK bytes)
BM, BN, BK = 64, 128, 128
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
             + [ctypes.c_void_p] * 7)
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}

Valid = Optional[Tuple[int, int]]


class DriftGemmOut(NamedTuple):
    y: torch.Tensor                # (M, N) f32 corrected output
    n_flagged_tiles: torch.Tensor  # 0-d int64
    row_diff: torch.Tensor         # (Mp, Np/32) int32 (padded grid)
    col_diff: torch.Tensor         # (Mp/32, Np) int32


def _pad2(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return F.pad(x, (0, cols - x.shape[1], 0, rows - x.shape[0]))


def padded_shape(m: int, n: int) -> tuple:
    """The padded (Mp, Np) grid: M and N rounded up to the tile."""
    return -(-m // TILE) * TILE, -(-n // TILE) * TILE


def work(m: int, k: int, n: int, flip_words: int = 0,
         ckpt_reads: int = 0) -> Dict[str, int]:
    """The kernel's work on ``(M, K) @ (K, N)``: int8 operations of the
    product and of both expected checksums; bytes with each input read
    once (the int8 operands, ``flip_words`` int32 flips, the scales) and
    each output written once (out, the checksum differences, the tile
    counts). The checkpoint is read only where an element is masked:
    ``ckpt_reads`` counts those reads, which depend on the data (a shape
    count, as ``op_analysis``'s, passes 0)."""
    mp, np_ = padded_shape(m, n)
    mt, nt = mp // TILE, np_ // TILE
    return {"flops": 0,
            "int8_ops": 2 * m * n * k + 2 * m * k * nt + 2 * mt * k * n,
            "bytes": (m * k + k * n + 4 * flip_words + 4 + 4 * n
                      + 4 * ckpt_reads + 4 * m * n + 4 * mp * nt
                      + 4 * mt * np_ + 4 * mt * nt)}


def drift_gemm_fused_plain(aq: torch.Tensor, bq: torch.Tensor,
                           flips: Optional[torch.Tensor], sx: torch.Tensor,
                           sw: torch.Tensor, ckpt: Optional[torch.Tensor],
                           threshold: int, union: bool = True,
                           valid: Valid = None) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version: the operands zero-padded to the tile,
    ``abft_matmul_plain``, the differences through int64,
    ``quant.dequantize_matmul``, then ``rollback_correct_plain``."""
    m, k = aq.shape
    n = bq.shape[1]
    mp, np_ = padded_shape(m, n)
    fl = (torch.zeros((mp, np_), dtype=torch.int32, device=aq.device)
          if flips is None else _pad2(flips, mp, np_))
    c, act_row, exp_row, act_col, exp_col = _abft.abft_matmul_plain(
        _pad2(aq, mp, k), _pad2(bq, k, np_), fl)
    row_diff = wrap_i32(act_row.long() - exp_row.long())
    col_diff = wrap_i32(act_col.long() - exp_col.long())
    y = quant.dequantize_matmul(c[:m, :n], sx, sw.reshape(1, -1))
    ck = (torch.zeros((mp, np_), dtype=torch.float32, device=aq.device)
          if ckpt is None else _pad2(ckpt, mp, np_))
    out, tile_count = _rc.rollback_correct_plain(
        _pad2(y, mp, np_), ck, row_diff, col_diff, threshold, union=union,
        valid=valid)
    return out[:m, :n].contiguous(), row_diff, col_diff, tile_count


def _check(aq, bq, flips, sx, sw, ckpt, valid):
    if aq.dtype != torch.int8 or bq.dtype != torch.int8:
        raise TypeError(f"drift_gemm_fused takes int8 operands, got "
                        f"{aq.dtype}, {bq.dtype}")
    if aq.ndim != 2 or bq.ndim != 2 or aq.shape[1] != bq.shape[0]:
        raise ValueError(f"bad GEMM shapes {tuple(aq.shape)} @ "
                         f"{tuple(bq.shape)}")
    m, n = aq.shape[0], bq.shape[1]
    mp, np_ = padded_shape(m, n)
    if flips is not None:
        if flips.dtype != torch.int32:
            raise TypeError(f"flips must be int32 bit patterns, got "
                            f"{flips.dtype}")
        if tuple(flips.shape) not in ((m, n), (mp, np_)):
            raise ValueError(f"flips {tuple(flips.shape)} cover neither "
                             f"{(m, n)} nor the padded {(mp, np_)}")
    for label, t, shape in (("sx", sx, ()), ("sw", sw, (n,)),
                            ("ckpt", ckpt, (m, n))):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{label} must be f32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{label} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    tensors = [t for t in (aq, bq, flips, sx, sw, ckpt) if t is not None]
    if any(t.device != aq.device for t in tensors):
        raise ValueError("drift_gemm_fused operands on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("drift_gemm_fused takes contiguous tensors")
    if valid is not None and not (0 <= valid[0] <= mp
                                  and 0 <= valid[1] <= np_):
        raise ValueError(f"valid region {valid} outside {(mp, np_)}")


def launch_plan(m: int, k: int, n: int, sms: int = 132
                ) -> Tuple[int, int, int]:
    """(Kp, splits, slabs) for the CUDA launcher: K zero-padded to Kp, a
    multiple of 16 (a tensor map's row stride), in K slabs of ``BK``; at
    M <= ``BM`` (one row of CTAs) the slabs split into ``splits`` CTAs
    along K of ``slabs`` slabs each, so that about ``sms`` CTAs stream
    B; otherwise one split of every slab."""
    kp = max(16, -(-k // 16) * 16)
    total = -(-kp // BK)
    if m > BM:
        return kp, 1, total
    tiles = -(-padded_shape(m, n)[1] // BN)
    slabs = -(-total // min(total, -(-sms // tiles)))
    return kp, -(-total // slabs), slabs


def reads_b_in_place(m: int, bq: torch.Tensor) -> bool:
    """True where the kernel reads ``bq (K, N)`` as it lies, transposing
    each K slab in shared memory: M <= ``BM`` (one row of CTAs, where B's
    bytes bind), N % 16 == 0 and ``bq`` 16-byte aligned (a tensor map's
    row stride and base). Otherwise the call first transposes B into an
    (N, Kp) buffer, a kernel of its own."""
    return (m <= BM and bq.shape[1] % 16 == 0
            and bq.data_ptr() % 16 == 0)


def launch_args(aq, bq, flips, sw, ckpt, out) -> bool:
    """``vec`` for the CUDA launcher: the epilogue's 16-byte loads and
    stores need N % 4 == 0 and aligned pointers (every serving shape);
    otherwise it moves word by word. The mainloop takes any shape."""
    n = bq.shape[1]
    ok = (n % 4 == 0 and out.data_ptr() % 16 == 0
          and sw.data_ptr() % 16 == 0)
    if ckpt is not None:
        ok = ok and ckpt.data_ptr() % 16 == 0
    if flips is not None:
        ok = ok and flips.data_ptr() % 16 == 0 and flips.shape[1] % 4 == 0
    return ok


def drift_gemm_fused(aq: torch.Tensor, bq: torch.Tensor,
                     flips: Optional[torch.Tensor], sx: torch.Tensor,
                     sw: torch.Tensor, ckpt: Optional[torch.Tensor],
                     threshold: int, union: bool = True,
                     valid: Valid = None) -> Tuple[torch.Tensor, ...]:
    """(out, row_diff, col_diff, tile_count); see the module docstring."""
    _check(aq, bq, flips, sx, sw, ckpt, valid)
    m, k = aq.shape
    n = bq.shape[1]
    words = 0 if flips is None else flips.numel()
    with _count.kernel("drift_gemm_fused", work, m, k, n, words):
        return _drift_gemm_fused(aq, bq, flips, sx, sw, ckpt, threshold,
                                 union, valid)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tickets(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """The split-K tile counters of ``stream``: zero, and left zero by
    every launch (the last CTA of a tile resets its counter)."""
    key = (dev.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(max(n, 256), dtype=torch.int32,
                                        device=dev)
    return t


def _drift_gemm_fused(aq, bq, flips, sx, sw, ckpt, threshold, union,
                      valid):
    global launches
    m, k = aq.shape
    n = bq.shape[1]
    mp, np_ = padded_shape(m, n)
    mt, nt = mp // TILE, np_ // TILE
    shapes = ((m, n), (mp, nt), (mt, np_), (mt, nt))
    if _count.meta_call(aq.device):
        return (torch.empty(shapes[0], dtype=torch.float32, device="meta"),
                *(torch.empty(s, dtype=torch.int32, device="meta")
                  for s in shapes[1:]))
    if aq.device.type == "cpu":
        return drift_gemm_fused_plain(aq, bq, flips, sx, sw, ckpt,
                                      threshold, union, valid)
    if aq.device.type != "cuda":
        raise ValueError(f"drift_gemm_fused: unsupported device "
                         f"{aq.device}")
    vm, vn = (mp, np_) if valid is None else valid
    dev = aq.device
    out = torch.empty(shapes[0], dtype=torch.float32, device=dev)
    row_diff, col_diff, tile_count = (
        torch.empty(s, dtype=torch.int32, device=dev) for s in shapes[1:])
    fm, fn = (0, 0) if flips is None else flips.shape
    vec = launch_args(aq, bq, flips, sw, ckpt, out)
    fn_ = _lib.function("drift_gemm", "drift_gemm_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        kp, splits, slabs = launch_plan(m, k, n, _sm_count(dev.index))
        stream = _lib.stream_of(dev)
        a = _stat.a_operand(aq, kp)
        bt = (None if reads_b_in_place(m, bq) else
              torch.empty((n, kp), dtype=torch.int8, device=dev))
        ws = tickets = None
        if splits > 1:
            tiles = -(-np_ // BN)
            ws = torch.empty(tiles * splits * m * BN, dtype=torch.int32,
                             device=dev)
            tickets = _tickets(dev, stream, tiles)
        err = fn_(a.data_ptr(), bq.data_ptr(),
                  None if bt is None else bt.data_ptr(),
                  None if flips is None else flips.data_ptr(), fn, fm, fn,
                  sx.data_ptr(), sw.data_ptr(),
                  None if ckpt is None else ckpt.data_ptr(),
                  int(threshold), int(bool(union)), m, n, k, kp, int(vm),
                  int(vn), int(vec), slabs,
                  None if ws is None else ws.data_ptr(),
                  None if tickets is None else tickets.data_ptr(),
                  out.data_ptr(), row_diff.data_ptr(), col_diff.data_ptr(),
                  tile_count.data_ptr(), stream)
    _lib.check(err, "drift_gemm_fused")
    launches += 1
    return out, row_diff, col_diff, tile_count


def _drift_gemm(fused, x, w, ckpt, flips, threshold_bit, bm, bn, bk,
                union) -> DriftGemmOut:
    if (bm, bn, bk) != (TILE, TILE, TILE):
        raise ValueError(f"drift_gemm's checksum tile is {TILE}, got "
                         f"(bm, bn, bk) = ({bm}, {bn}, {bk})")
    mp, np_ = padded_shape(x.shape[0], w.shape[1])
    if tuple(flips.shape) != (mp, np_) or flips.dtype != torch.int32:
        raise ValueError(f"flips must be int32 over the padded grid "
                         f"{(mp, np_)}, got {flips.dtype} "
                         f"{tuple(flips.shape)}")
    xq = quant.quantize(x, axis=None)
    wq = quant.quantize(w, axis=1)
    y, row_diff, col_diff, tile_count = fused(
        xq.q, wq.q, flips, xq.scale, wq.scale.reshape(-1), ckpt,
        1 << threshold_bit, union=union)
    return DriftGemmOut(y, (tile_count > 0).sum(), row_diff, col_diff)


def drift_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                     ckpt: Optional[torch.Tensor], flips: torch.Tensor,
                     threshold_bit: int = 10, bm: int = TILE, bn: int = TILE,
                     bk: int = TILE, union: bool = True) -> DriftGemmOut:
    """``drift_gemm`` over the kernel's plain version."""
    return _drift_gemm(drift_gemm_fused_plain, x, w, ckpt, flips,
                       threshold_bit, bm, bn, bk, union)


def drift_gemm(x: torch.Tensor, w: torch.Tensor,
               ckpt: Optional[torch.Tensor], flips: torch.Tensor,
               threshold_bit: int = 10, bm: int = TILE, bn: int = TILE,
               bk: int = TILE, union: bool = True) -> DriftGemmOut:
    """Kernel-backed DRIFT-protected GEMM: ``x (M, K) f32 @ w (K, N) f32``
    with ``flips (Mp, Np)`` int32 xored into the int32 accumulators."""
    return _drift_gemm(drift_gemm_fused, x, w, ckpt, flips, threshold_bit,
                       bm, bn, bk, union)
