"""Error-feedback INT8 gradient compression for the cross-pod all-reduce.

Counterpart of ``repro.optim.compression``. At 512+ ranks the cross-pod
data-parallel all-reduce is the longest-haul collective, so pod-crossing
gradients go as int8 with per-tensor scales, and the quantization
residual stays in an error-feedback buffer (Seide et al. / 1-bit Adam
lineage) so compression noise is unbiased over steps.

The reference's ``psum`` over a named axis becomes an int32
``all_reduce`` over that axis's process group of the mesh
(``launch.mesh.Mesh.group``), and its ``pmax`` a ``MAX``. Every division
takes a 0-d tensor divisor, so the card divides as the CPU does (CUDA
turns a division by a host scalar into a product with its reciprocal).
As in the reference, the train step does not call it.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map, tree_unflatten

Params = Any


def _on(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def init_error_buffer(grads: Params) -> Params:
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                    grads)


def _compress_one(g: torch.Tensor, e: torch.Tensor):
    gf = g.float() + e
    amax = gf.abs().max()
    scale = torch.clamp(amax, min=1e-12) / _on(127.0, gf)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_e = gf - q.float() * scale
    return q, scale, new_e


def compress(grads: Params, err: Params) -> Tuple[Params, Params, Params]:
    """Returns (q_int8, scales, new_error_buffer)."""
    out = []
    tree_map(lambda g, e: out.append(_compress_one(g, e)), grads, err)
    return tuple(tree_unflatten(grads, [o[i] for o in out])
                 for i in range(3))


def decompress(q: Params, scales: Params) -> Params:
    return tree_map(lambda qq, ss: qq.float() * ss, q, scales)


def allreduce_compressed(grads: Params, err: Params, mesh, axis: str
                         ) -> Tuple[Params, Params]:
    """Mean-all-reduce over ``mesh``'s ``axis`` with an int8 payload and
    error feedback: the int8 payloads are summed in int32 (exact for
    <= 2^23 contributors) and dequantized against the axis's largest
    scale, so the wire carries 1 byte a gradient and a scalar a tensor."""
    q, s, new_err = compress(grads, err)
    group = mesh.group(axis)
    n = mesh.shape[axis]

    def reduce_one(qq, ss):
        acc = mesh.all_reduce(qq.to(torch.int32), group=group)
        smax = mesh.all_reduce(ss.clone(), op=dist.ReduceOp.MAX,
                               group=group)
        return acc.float() * smax / _on(n, acc)

    return tree_map(reduce_one, q, s), new_err
