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

On a mesh (``mesh`` and ``layout``), a rank holds its blocks of the
params, grads and f32 moments (JAX's ``param_shardings``) and its run of
each int8 moment's blocks (``opt_logical``: ``("flat_shard", None)``,
the flattened leaf's 256-value blocks cut over data and model). The
global norm is the all-reduce over the mesh of each leaf's local sum of
squares divided by the ranks that hold the same block. f32 moments
update their blocks in place. An int8 moment's run is not its param's
block: the run's values of the grad and the param are brought from the
blocks that hold them, the run updated (dequantized, stepped, quantized)
and its param values sent back to the blocks, one leaf at a time; each
value crosses between ranks once (``parallel/sharding.RunExchange``).
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.collectives import all_reduce, host_back
from repro_torch.core.compression import (Quantized, dequantize_int8_blockwise,
                                          quantize_int8_blockwise)
from repro_torch.parallel import sharding as S

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


def opt_logical(params_logical: PyTree, int8: bool) -> AdamWState:
    """The logical axes of ``adamw_init``'s state (JAX's ``_opt_logical``,
    ``launch/dryrun.py:31-40``): f32 moments as their params, int8
    moments' blocks and scales flat over ``flat_shard`` (data, model)."""
    def leaf(lg):
        return Quantized(q=("flat_shard", None), scale=("flat_shard",)) if int8 else lg
    m = S.tree_map(leaf, params_logical, is_leaf=S.is_logical)
    v = S.tree_map(leaf, params_logical, is_leaf=S.is_logical)
    return AdamWState(step=(), m=m, v=v)


def abstract_state(params: PyTree, *, moments: str = "f32") -> AdamWState:
    """``adamw_init``'s state as tensors on the ``meta`` device (shapes
    and dtypes, no allocation; no kernel)."""
    def leaf(p):
        if moments != "int8":
            return torch.empty(p.shape, dtype=torch.float32, device="meta")
        nblk = -(-p.numel() // _QBLOCK)
        return Quantized(q=torch.empty((nblk, _QBLOCK), dtype=torch.int8, device="meta"),
                         scale=torch.empty((nblk,), dtype=torch.float32, device="meta"))
    return AdamWState(step=0, m=tree_map(leaf, params), v=tree_map(leaf, params))


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def _mesh_norm(grads: PyTree, layout: PyTree, mesh) -> torch.Tensor:
    """The global norm of grads held in blocks: each leaf's sum of squares
    over the ranks that hold the same block (a power of two: the division
    is exact), all-reduced over every axis of the mesh."""
    world = 1
    for n in mesh.shape.values():
        world *= n
    tot = 0.0
    for g, b in zip(tree_leaves(grads), tree_leaves(layout)):
        held = 1
        if b.is_block(g):
            for a in b.axes():
                held *= mesh.shape[a]
        part = torch.sum(torch.square(g.float()))
        tot = tot + part / torch.tensor(float(world // held), device=part.device)
    for a in mesh.axis_names:
        if mesh.shape[a] > 1:
            tot = all_reduce(tot, mesh.get_group(a))
    return torch.sqrt(tot)


def _update_run(g, p, m: Quantized, v: Quantized, pb, qb, mesh, *, scale, b1, b2,
                bc1, bc2, lr, eps, weight_decay) -> Tuple[Quantized, Quantized]:
    """One leaf whose int8 moments this rank holds as a run of blocks
    (``qb``: the layout of their ``q``): the run's values of the grad and
    the param brought from the ranks' blocks (``pb``) to this rank and its
    param's device (``parallel/sharding.RunExchange``: each value crosses
    once, in host memory), stepped as ``adamw_update`` steps a whole
    leaf, and sent back to the blocks that hold them, ``p`` written in
    place. The card holds a run of the leaf, never the whole. Returns the
    new moment runs."""
    entry = qb.spec[0] if qb.is_block(m.q) else None
    c = m.q.shape[0] * m.q.shape[1]
    rx = S.RunExchange(pb, entry, mesh, c)
    gr = host_back(rx.to_run(g), p.device).float() * scale
    pr = host_back(rx.to_run(p), p.device)
    mf = dequantize_int8_blockwise(m, (c,))
    vf = dequantize_int8_blockwise(v, (c,))
    mf.mul_(b1).add_(gr * (1 - b1))
    vf.mul_(b2).add_((1 - b2) * gr * gr)
    del gr
    update = (mf / bc1).div_((vf / bc2).sqrt_().add_(eps))
    if len(pb.shape) >= 2:
        update.add_(weight_decay * pr.float())
    pr.sub_(update.mul_(lr))
    del update
    rx.to_block(pr, p)
    return _maybe_quant(mf, "int8"), _maybe_quant(vf, "int8")


@torch.no_grad()
def adamw_update(grads: PyTree, state: AdamWState, params: PyTree, *,
                 lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0,
                 moments: str = "f32", mesh=None,
                 layout: Optional[Tuple[PyTree, AdamWState]] = None
                 ) -> Tuple[PyTree, AdamWState, dict]:
    """One AdamW step. ``params`` and f32 moments are updated in place and
    returned; int8 moments are dequantized, updated and quantized anew.
    ``moments`` is the JAX signature's; as there, each leaf's own state
    (f32 or ``Quantized``) decides. With ``mesh`` and ``layout`` (the
    params' and the state's ``BlockSpec`` trees), each rank steps its
    blocks (module docstring)."""
    if moments not in MOMENTS:
        raise ValueError(f"moments must be one of {MOMENTS}, got {moments!r}")
    step = state.step + 1
    gnorm = global_norm(grads) if layout is None else _mesh_norm(grads, layout[0], mesh)
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
    n_leaves = len(tree_leaves(params))
    pbs = [None] * n_leaves if layout is None else tree_leaves(layout[0])
    qbs = [None] * n_leaves if layout is None else tree_leaves(layout[1].m)
    for g, p, m, v, pb, qb in zip(tree_leaves(grads), tree_leaves(params),
                                  tree_leaves(state.m), tree_leaves(state.v), pbs, qbs):
        if pb is not None and isinstance(m, Quantized):
            mq, vq = _update_run(g, p, m, v, pb, qb.q, mesh, scale=scale, b1=b1, b2=b2,
                                 bc1=bc1, bc2=bc2, lr=lr, eps=eps,
                                 weight_decay=weight_decay)
            new_m.append(mq)
            new_v.append(vq)
            continue
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
