"""AdamW with optional int8 moments, the counterpart of
``repro/optim/adamw.py``.

``moments="int8"`` stores m and v blockwise-int8 (blocks of 256, one f32
scale each): 1.0 byte per value plus 1/64 for the scales, against 8 for
f32 moments. On the card every step dequantizes m and v of each leaf
(CUDA kernel K4b), updates them in f32 and quantizes them again (K4a).

The arithmetic is the JAX version's, in its order: clip by the global
norm, ``bc1``/``bc2`` in f32, the moment updates, the bias-corrected
step, weight decay on leaves with ``ndim >= 2`` only (decided on the
stacked leaf, so the stacked norm scales (L, D) decay and ``final_norm``
does not). Each operation rounds once as its jnp twin does; in-place
operations only reuse memory.

Unlike the pure JAX function, ``adamw_update`` writes the new params,
and f32 moments, into the tensors it is given (the JAX launcher donates
them) and returns them: at full width (internlm2-1.8b) a second copy of
the f32 masters would cost 7.6 GB, of f32 moments 15.1 GB.
Leaves are visited in ``jax.tree`` order (dict keys sorted), so the
global norm sums them in the same order.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple

import torch

from repro_torch.core.compression import (Quantized, dequantize_int8_blockwise,
                                          quantize_int8_blockwise)

PyTree = Any
_QBLOCK = 256
MOMENTS = ("f32", "int8")


class AdamWState(NamedTuple):
    step: int
    m: PyTree                 # f32 tensors or Quantized pairs
    v: PyTree


def _is_node(x) -> bool:
    return isinstance(x, dict) or (isinstance(x, (tuple, list))
                                   and not isinstance(x, Quantized))


def tree_leaves(tree: PyTree) -> List[Any]:
    """Leaves in ``jax.tree`` order: dict keys sorted, tuples in order; a
    ``Quantized`` pair is one leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if _is_node(tree):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like: PyTree, leaves: List[Any]) -> PyTree:
    """A tree of ``like``'s structure holding ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if _is_node(node):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(like)


def tree_map(fn: Callable, tree: PyTree) -> PyTree:
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def _maybe_quant(x: torch.Tensor, mode: str):
    return quantize_int8_blockwise(x, _QBLOCK) if mode == "int8" else x


def adamw_init(params: PyTree, *, moments: str = "f32") -> AdamWState:
    """Zero moments in f32 or, with ``moments="int8"``, quantized zeros
    (each a K4a launch on the card)."""
    if moments not in MOMENTS:
        raise ValueError(f"moments must be one of {MOMENTS}, got {moments!r}")

    def zero_like(p):
        return _maybe_quant(torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device), moments)
    return AdamWState(step=0, m=tree_map(zero_like, params),
                      v=tree_map(zero_like, params))


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads: PyTree, state: AdamWState, params: PyTree, *,
                 lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0,
                 moments: str = "f32") -> Tuple[PyTree, AdamWState, dict]:
    """One AdamW step. ``params`` and f32 moments are updated in place and
    returned; int8 moments are dequantized, updated and quantized anew.
    ``moments`` is the JAX signature's; as there, each leaf's own state
    (f32 or ``Quantized``) decides."""
    if moments not in MOMENTS:
        raise ValueError(f"moments must be one of {MOMENTS}, got {moments!r}")
    step = state.step + 1
    gnorm = global_norm(grads)
    # a tensor numerator: ``float / tensor`` is reciprocal-then-multiply
    # in torch, two roundings where jnp divides once
    scale = (torch.clamp(torch.tensor(grad_clip, dtype=torch.float32, device=gnorm.device)
                         / (gnorm + 1e-9), max=1.0) if grad_clip > 0 else 1.0)

    # bc1, bc2 on the grads' device: torch divides a CUDA tensor by a CPU
    # scalar as a multiply by its reciprocal, jnp truly divides
    stepf = torch.tensor(float(step), dtype=torch.float32)
    bc1 = (1.0 - torch.tensor(b1, dtype=torch.float32) ** stepf).to(gnorm.device)
    bc2 = (1.0 - torch.tensor(b2, dtype=torch.float32) ** stepf).to(gnorm.device)
    lr = torch.as_tensor(lr, dtype=torch.float32)

    new_m, new_v = [], []
    for g, p, m, v in zip(tree_leaves(grads), tree_leaves(params),
                          tree_leaves(state.m), tree_leaves(state.v)):
        g = g.float() * scale
        mf = dequantize_int8_blockwise(m, g.shape) if isinstance(m, Quantized) else m
        vf = dequantize_int8_blockwise(v, g.shape) if isinstance(v, Quantized) else v
        mf.mul_(b1).add_(g * (1 - b1))                 # b1 * m + (1 - b1) * g
        vf.mul_(b2).add_((1 - b2) * g * g)             # b2 * v + (1 - b2) * g * g
        del g
        update = (mf / bc1).div_((vf / bc2).sqrt_().add_(eps))
        if p.dim() >= 2:                               # decay matrices only
            update.add_(weight_decay * p.float())
        p.sub_(update.mul_(lr))                        # p - lr * update
        del update
        new_m.append(_maybe_quant(mf, "int8") if isinstance(m, Quantized) else mf)
        new_v.append(_maybe_quant(vf, "int8") if isinstance(v, Quantized) else vf)
    state2 = AdamWState(step=step, m=tree_unflatten(state.m, new_m),
                        v=tree_unflatten(state.v, new_v))
    return params, state2, {"grad_norm": gnorm}
