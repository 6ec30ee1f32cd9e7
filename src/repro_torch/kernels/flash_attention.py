"""Online-softmax (flash) attention (wrapper, plain version, strided layout).

Replaces the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention`` (``pl.pallas_call`` at line 83, body ``_kernel`` at
line 30) and its ``(B, S, H, D)`` wrapper ``mha_flash`` (line 105).
``q, k, v`` are f32 or bf16 with D <= 256; the output has the input
dtype. The constants are the TPU kernel's: masked scores
``NEG_INF = -2e38``, the normaliser clamped at ``1e-37``, scale
``D ** -0.5`` rounded to f32; causal or not.

``mha_flash`` also computes what the reference's ``full_attention``
adds for the LM prefill (``repro/models/attention.py:40``): GQA (k and v
at ``Hkv`` heads, ``H % Hkv == 0``; query head h reads KV head
``h // (H // Hkv)``, never a repeated copy), a sliding window
(``window > 0`` masks keys with ``row - key >= window``) and a softcap
(``cap * tanh(s / cap)`` on the scaled score, before the mask).

The CUDA kernel (``csrc/flash_attention.cu``) reads q, k and v where they
lie, at the strides ``launch_args`` hands it, so ``mha_flash`` launches on
the caller's ``(B, S, H, D)`` tensors (views of a fused projection
included) and writes a contiguous ``(B, S, H, D)`` output: one kernel per
call, no head folds. ``flash_attention`` on ``(BH, S, D)`` is the case
H = 1. bf16, the serving paths' dtype, runs on the tensor cores
(``mma.sync`` m16n8k16, f32 accumulation, P rounded to bf16 before P V as
the Pallas kernel rounds it); operations bind it on an H100 SXM,
4*B*H*S*S*D flops over 989 TFLOP/s, 0.0098 ms at the DiT's
(32, 1024, 72). f32 runs on the first port's CUDA-core kernel (bound by
the f32 rate, 67 TFLOP/s), in the SMOKE configs and tests only.

The plain version is ``models.attention.full_attention``, which keeps P
in f32: the bf16 kernel agrees with it within 3e-2, the Pallas test's own
tolerance, and the f32 kernel within 2e-5. The wrappers take it for CPU
tensors only; a CUDA tensor launches the kernel or raises. ``launches``
counts kernel launches, those made through ``mha_flash`` (the wrapper the
DiT block and the LM prefill call) included.

Training differentiates through both wrappers. On the card every launch
runs inside ``_Attention``, a ``torch.autograd.Function``, which records
a graph only where grad mode is on and an input requires grad: its
forward is the launch, and its backward recomputes the plain ``full_attention`` from
the saved q, k and v and differentiates it (``backward_calls`` counts
those). The reference has no backward kernel either: its training
differentiates plain ``jnp`` attention. So the card's gradient is the
plain version's at the kernel's inputs, while its forward rounds P to
bf16 (ROADMAP Queue C 3). On the CPU the wrappers are ``full_attention``,
which autograd differentiates as it is.

``work`` is the kernel's own work, causal pairs and windows clipped
(``abft_matmul``'s docstring says who reads it); under a count the
wrappers take meta tensors and ``_Attention``'s backward is counted as
the plain version it runs.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _count, _lib
from repro_torch.models.attention import full_attention

MAX_D = 256
launches = 0
backward_calls = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                ctypes.c_int, ctypes.c_int, ctypes.c_float]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def attn_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs one head attends over a length ``s``: causal
    (row r reads keys up to r) and window clipped (``window`` > 0 drops
    keys with ``row - key >= window``)."""
    w = window if 0 < window < s else 0
    if causal:
        return w * (w + 1) // 2 + (s - w) * w if w else s * (s + 1) // 2
    # row r reads keys max(0, r - w + 1) .. s - 1
    return s * s - (s - w + 1) * (s - w) // 2 if w else s * s


def work(b: int, s: int, h: int, hkv: int, d: int, itemsize: int,
         causal: bool = False, window: int = 0) -> Dict[str, int]:
    """The kernel's work on (B, S, H, D) q and (B, S, Hkv, D) k, v: 4 D
    FLOPs (Q K^T and P V) per attended pair and query head; bytes with
    q, k, v read once and o written once."""
    return {"flops": 4 * b * h * d * attn_pairs(s, causal, window),
            "int8_ops": 0, "bytes": itemsize * b * s * d * (2 * h + 2 * hkv)}


def _work_of(q, k, causal, window=0):
    b, s, h, d = q.shape
    return work(b, s, h, k.shape[2], d, q.element_size(), causal, window)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False) -> torch.Tensor:
    """(BH, S, D) attention through ``full_attention``."""
    bh, s, d = q.shape
    o = full_attention(q.reshape(bh, s, 1, d), k.reshape(bh, s, 1, d),
                       v.reshape(bh, s, 1, d), causal=causal)
    return o.reshape(bh, s, d)


def _check(q, k, v, ndim, window=0, softcap=0.0):
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention takes f32 or bf16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != ndim or k.shape != v.shape or k.ndim != ndim:
        raise ValueError(f"q, k, v must be {ndim}-d with k and v of one "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    kv_heads = k.shape[2] if ndim == 4 else 1
    heads = q.shape[2] if ndim == 4 else 1
    if (q.shape[:2] != k.shape[:2] or q.shape[-1] != k.shape[-1]
            or kv_heads == 0 or heads % kv_heads):
        raise ValueError(f"q {tuple(q.shape)} and k, v {tuple(k.shape)}: "
                         "self-attention takes one batch, length and head "
                         "dim, and H a multiple of Hkv")
    if q.shape[-1] > MAX_D:
        raise ValueError(f"head dim {q.shape[-1]} > {MAX_D}")
    if int(window) < 0 or not float(softcap) >= 0.0:
        raise ValueError(f"window {window} and softcap {softcap} must be "
                         ">= 0 (0: off)")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention operands on different devices")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")


def launch_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                o: torch.Tensor):
    """The C launcher's layout arguments for ``(B, S, H, D)`` tensors.

    Returns ``(B, S, H, D, strides, vec)``: ``strides`` holds the batch,
    token and head strides in elements of q, k, v and o (12 ints; the last
    dim must be contiguous; k's and v's head strides step over their own
    ``Hkv`` heads), and ``vec`` says that every row start is
    16-byte aligned and D a whole number of 16-byte chunks, so the kernel
    may move tiles in 16-byte copies. Strides of size-1 dims are ignored
    for alignment (they address nothing).
    """
    b, s, h, d = q.shape
    per16 = 16 // q.element_size()
    strides, vec = [], d % per16 == 0
    for x in (q, k, v, o):
        if x.stride(3) != 1 and d > 1:
            raise ValueError(f"last dim must be contiguous, stride "
                             f"{x.stride(3)}")
        st = x.stride()[:3]
        strides.extend(st)
        vec = vec and x.data_ptr() % 16 == 0 and all(
            st[i] % per16 == 0 for i in range(3) if x.shape[i] > 1)
    return b, s, h, d, tuple(strides), vec


def _launch(q, k, v, causal, window=0, softcap=0.0):
    """Launch on (B, S, H, D) q and (B, S, Hkv, D) k, v CUDA tensors; a
    contiguous (B, S, H, D) out (empty, with no launch, for meta tensors
    under a count)."""
    with _count.kernel("flash_attention", _work_of, q, k, causal, window):
        o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        if _count.meta_call(q.device):
            return o
        return _launch_into(o, q, k, v, causal, window, softcap)


def _launch_into(o, q, k, v, causal, window, softcap):
    global launches
    b, s, h, d, strides, vec = launch_args(q, k, v, o)
    fn = _lib.function("flash_attention", "flash_attention_launch",
                       _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b,
                 s, h, k.shape[2], d, (ctypes.c_longlong * 12)(*strides),
                 d ** -0.5, int(bool(causal)), int(window), float(softcap),
                 _DTYPES[q.dtype], int(vec), _lib.stream_of(q.device))
    _lib.check(err, "flash_attention")
    launches += 1
    return o


class _Attention(torch.autograd.Function):
    """The kernel launch with the plain version's gradient (see the module
    docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, softcap)
        return _launch(q, k, v, causal, window, softcap)

    @staticmethod
    def backward(ctx, grad_o):
        global backward_calls
        causal, window, softcap = ctx.args
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        with torch.enable_grad():
            o = full_attention(*inputs, causal=causal, window=window,
                               attn_softcap=softcap)
            grads = torch.autograd.grad(
                o, [t for t in inputs if t.requires_grad], grad_o)
        backward_calls += 1
        it = iter(grads)
        return tuple(next(it) if t.requires_grad else None
                     for t in inputs) + (None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """q, k, v: (BH, S, D) -> (BH, S, D) in the input dtype."""
    _check(q, k, v, 3)
    if q.device.type == "cpu":
        with _count.kernel("flash_attention", _work_of, q.unsqueeze(2),
                           k.unsqueeze(2), causal):
            return flash_attention_plain(q, k, v, causal)
    return _Attention.apply(q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2),
                            causal, 0, 0.0).squeeze(2)


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, window: int = 0,
              softcap: float = 0.0) -> torch.Tensor:
    """q: (B, S, H, D), k, v: (B, S, Hkv, D), any strides with a contiguous
    last dim -> a contiguous (B, S, H, D) output; one kernel launch, no
    copies, KV never repeated. ``window`` > 0 and ``softcap`` > 0 as in
    ``full_attention``; 0 turns each off."""
    _check(q, k, v, 4, window, softcap)
    if q.device.type == "cpu":
        with _count.kernel("flash_attention", _work_of, q, k, causal,
                           window):
            # contiguous, as the kernel writes it
            return full_attention(q, k, v, causal=causal, window=window,
                                  attn_softcap=softcap).contiguous()
    return _Attention.apply(q, k, v, causal, window, softcap)
