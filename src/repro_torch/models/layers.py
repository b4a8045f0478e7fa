"""Shared layer primitives, the counterpart of ``repro/models/layers.py``:
RMSNorm, RoPE, activations, the gated MLP and the row-parallel
projection.

A weight is either whole or this rank's block of it, as the train
state's layout holds it on a mesh (``parallel/sharding.place``): d_model
(``fsdp``) split over ``data``, heads, mlp and vocab over ``model``.
``fsdp_gather`` makes a block whole on d_model (its backward the
reduce-scatter of the grad over ``data``); a block of the ``model`` dim
is computed tensor-parallel: the replicated input enters through
``pvary`` (its grad summed over ``model``), the column-parallel product
gives this rank's heads or mlp columns, and the row-parallel product's
partial sums meet in ``tp_product``. What XLA's partitioner makes of
JAX's sharded weights.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import all_gather, all_reduce, pvary, shard
from repro_torch.models import precision
from repro_torch.parallel.sharding import current_mesh


def _contract(x: torch.Tensor, w: torch.Tensor, k0: int) -> torch.Tensor:
    """x's dims from ``k0`` on against w's dims but the last: (..., K...)
    x (K..., D) -> (..., D), one matrix product."""
    return x.reshape(*x.shape[:k0], -1) @ w.reshape(-1, w.shape[-1])


def row_parallel(x: torch.Tensor, w: torch.Tensor, x_shard_dim: int,
                 w_shard_dim: int = 0) -> torch.Tensor:
    """The tensor-parallel row-parallel product (``layers.py:15-56``):
    x's dims from ``x_shard_dim`` on contract with w's leading dims, and
    ``x_shard_dim`` / ``w_shard_dim`` split over the ``model`` axis.

    Under ``precision.bf16_collectives()`` with a ``model`` axis of size
    n > 1 in ``current_mesh()``, and both split dims and the sequence
    (x's dim 1) divisible by n, each rank takes its 1/n of x and w (both
    whole on every rank: the replicated compute outside), multiplies them
    in f32, sums the partial products over ``model`` once in f32 and
    rounds the sum to bf16. Otherwise it is the plain product in x's
    dtype. Backward (JAX's transpose of ``layers.py:46-56``): the sum's
    is the identity, so dx and dw of a rank's slices are its own, and the
    slices' grads are gathered over ``model`` into the whole x's and w's."""
    mesh = current_mesh()
    msize = mesh.shape.get("model", 1) if mesh is not None else 1
    applicable = (precision.enabled() and msize > 1
                  and x.shape[x_shard_dim] % msize == 0
                  and w.shape[w_shard_dim] % msize == 0
                  and x.shape[1] % msize == 0)
    if not applicable:
        return _contract(x, w, x_shard_dim)
    group = mesh.get_group("model")
    part = _contract(shard(x.float(), group, x_shard_dim),
                     shard(w.float(), group, w_shard_dim), x_shard_dim)
    return all_reduce(part, group).to(torch.bfloat16)


def fsdp_gather(w: torch.Tensor, dim: int, d: int, mesh) -> torch.Tensor:
    """``w`` whole on its d_model dim ``dim``: as it is if whole (or
    without a mesh), else the all-gather of its FSDP blocks over ``data``
    (backward: the grad's reduce-scatter, summed over ``data``)."""
    if mesh is None or w.shape[dim] == d:
        return w
    if w.shape[dim] * mesh.shape.get("data", 1) != d:
        raise ValueError(f"dim {dim} of {tuple(w.shape)} is neither d_model {d} "
                         f"nor its share over data")
    return all_gather(w, mesh.get_group("data"), dim)


def tp_enter(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x``, replicated over ``model``, as the input of this rank's block
    of a column-parallel weight (``pvary``: its grad summed over model)."""
    return pvary(x, mesh.get_group("model"))


def tp_product(x: torch.Tensor, w: torch.Tensor, k0: int, mesh) -> torch.Tensor:
    """The row-parallel product of this rank's blocks: x's dims from
    ``k0`` on against w's leading dims, the bf16 values multiplied in f32
    and the partial sums added over ``model`` in f32, rounded once to bf16
    (``row_parallel``'s arithmetic: the whole product's one rounding, the
    sum only in another order). Backward: the sum's is the identity."""
    part = _contract(x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float(), k0)
    return all_reduce(part, mesh.get_group("model")).to(torch.bfloat16)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Math in f32, result in ``x.dtype``."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope(q: torch.Tensor, positions: torch.Tensor, theta: float,
         fraction: float = 1.0) -> torch.Tensor:
    """Rotary embedding, half-split (NeoX) layout on the first
    ``fraction`` of head dims. q (..., S, H, hd); positions (S,) or (B,S)."""
    hd = q.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    if rot == 0:
        return q
    qr, qp = q[..., :rot], q[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=q.device) / half)
    ang = positions[..., None].float() * freqs               # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    q1, q2 = qr[..., :half], qr[..., half:]                  # broadcast over heads
    out = torch.cat([q1 * cos - q2 * sin, q2 * cos + q1 * sin], dim=-1)
    return torch.cat([out.to(q.dtype), qp], dim=-1)


def activation_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def mlp(x: torch.Tensor, params: dict, activation,
        d_ff: Optional[int] = None) -> torch.Tensor:
    """Gated MLP (SwiGLU / GeGLU) in bf16. w_in (D,2,F), w_out (F,D),
    whole or this rank's blocks under ``current_mesh()``: F a block of
    ``d_ff`` (the whole width) makes it tensor-parallel over ``model``."""
    mesh = current_mesh()
    d = x.shape[-1]
    w_in = fsdp_gather(params["w_in"], 0, d, mesh)
    w_out = fsdp_gather(params["w_out"], 1, d, mesh)
    f = w_in.shape[2]
    tp = d_ff is not None and f != d_ff
    xc = x.to(torch.bfloat16)
    if tp:
        xc = tp_enter(xc, mesh)
    h = (xc @ w_in.to(torch.bfloat16).reshape(d, 2 * f))
    h = h.unflatten(-1, (2, f))
    h = activation(h[..., 0, :]) * h[..., 1, :]
    if tp:
        out = tp_product(h, w_out, 2, mesh)
    else:
        out = row_parallel(h, w_out.to(torch.bfloat16), x_shard_dim=2)
    return out.to(x.dtype)
