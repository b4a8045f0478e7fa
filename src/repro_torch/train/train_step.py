"""The train step, the counterpart of ``repro/train/train_step.py``:
forward + CE, backward, clip, AdamW.

- ``microbatch``: gradient accumulation over k microbatches of B/k (the
  JAX ``lax.scan`` is a loop here): f32 sums, then the mean;
- ``node_shares``: skew-aware batch assembly, each node's contiguous
  sub-batch accumulated on its own; equal shares take the plain path;
- remat policy (``RunConfig.remat_policy``): none | minimal | full
  (``models/model.py::forward``);
- ``moments_int8``: AdamW moments stored blockwise-int8, through the CUDA
  quantize / dequantize kernels on the card.

Grads come from ``torch.autograd.grad`` on the f32 master leaves. One
card, no mesh: ``pod_sync="compressed"`` (the int8 ring across pods)
raises until the multi-device slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import model as M
from repro_torch.models.attention import train_impl
from repro_torch.optim.adamw import adamw_update, tree_leaves, tree_unflatten
from repro_torch.optim.schedule import lr_at

PyTree = Any
Batch = Dict[str, torch.Tensor]


def loss_fn(cfg: ModelConfig, params: PyTree, batch: Batch, *,
            impl: str = "auto", remat: str = "minimal",
            capacity_factor: Optional[float] = 1.25, loss_chunk: int = 512):
    """(CE + router_aux_loss · aux, {"ce", "aux"}) (``train_step.py:36-46``):
    the batch's ``frontend_embeds`` go in front of its tokens, MoE layers
    dispatch at ``capacity_factor``. ``impl="auto"`` is the JAX package's
    rule for a training forward (``train_impl``) at the whole sequence's
    length: the plain attention below 2048 tokens, the blocked scan from
    2048, never the forward-only CUDA kernels."""
    fe = batch.get("frontend_embeds")
    if impl == "auto":
        impl = train_impl(batch["tokens"].shape[1] + (0 if fe is None else fe.shape[1]))
    res = M.forward(cfg, params, batch["tokens"], fe, impl=impl, remat=remat,
                    capacity_factor=capacity_factor)
    ce = M.cross_entropy(cfg, params, res.hidden, batch["labels"],
                         batch["loss_mask"], chunk=loss_chunk)
    aux_w = cfg.router_aux_loss if cfg.num_experts else 0.0
    return ce + aux_w * res.aux_loss, {"ce": ce, "aux": res.aux_loss}


def _split_microbatches(batch: Batch, k: int) -> list:
    """k contiguous microbatches of B/k rows (JAX's reshape to (k, B/k))."""
    out = []
    for x in batch.values():
        if x.shape[0] % k:
            raise ValueError(f"batch of {x.shape[0]} does not split into {k} microbatches")
    mb = next(iter(batch.values())).shape[0] // k
    for i in range(k):
        out.append({name: x[i * mb:(i + 1) * mb] for name, x in batch.items()})
    return out


def split_by_shares(batch: Batch, shares: Sequence[int]) -> list:
    """Split a global batch into contiguous per-node sub-batches of
    ``shares[j]`` microbatches each (``sum(shares)`` microbatches in all,
    so the microbatch size is ``B // sum(shares)``). A straggling node's
    share shrinks and its sub-batch with it; the union of the sub-batches
    is exactly the original batch."""
    shares = tuple(int(s) for s in shares)
    if any(s < 1 for s in shares):
        raise ValueError(f"every share must be >= 1, got {shares}")
    m = sum(shares)
    sizes = {x.shape[0] for x in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f"batch dim 0 must agree across leaves: {sizes}")
    b = sizes.pop()
    if b % m:
        raise ValueError(f"batch of {b} does not split into {m} "
                         f"microbatches (shares {shares})")
    mb = b // m
    subs, off = [], 0
    for s in shares:
        lo, hi = off * mb, (off + s) * mb
        subs.append({name: x[lo:hi] for name, x in batch.items()})
        off += s
    return subs


def make_train_step(cfg: ModelConfig, run: RunConfig, *, impl: str = "auto",
                    loss_chunk: int = 512):
    """Returns ``train_step(params, opt_state, batch, step,
    node_shares=None) -> (params, opt_state, metrics)``. ``params`` and
    f32 moments are updated in place (``optim/adamw.py``). ``node_shares``
    (per-node microbatch counts): equal shares take the unchanged plain
    path, so they are bit-identical to passing none; skewed shares run
    each node's sub-batch and combine the sums into the same global
    mean."""
    if run.pod_sync == "compressed":
        raise NotImplementedError(
            "pod_sync='compressed' (the int8 gradient ring across pods) needs "
            "the multi-device slice of the port (ROADMAP A9)")
    moments = "int8" if run.moments_int8 else "f32"

    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, parts = loss_fn(cfg, tree_unflatten(params, leaves), batch,
                                  impl=impl, remat=run.remat_policy,
                                  loss_chunk=loss_chunk)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        parts = {k: v.detach() for k, v in parts.items()}
        return loss.detach(), parts, list(grads)

    def add(tot, r):
        """Sum two (loss, parts, grads) results; the grads of ``tot`` in
        place."""
        for a, b in zip(tot[2], r[2]):
            a.add_(b.float())
        return (tot[0] + r[0], {k: tot[1][k] + r[1][k] for k in tot[1]}, tot[2])

    def scan_sum(params, batch, k):
        """Sum (not mean) of loss/parts/f32-grads over ``k`` microbatches.
        The first microbatch's grads start the sum (0 + g is g), which
        saves a zeroed f32 copy of the params."""
        tot = None
        for mb in _split_microbatches(batch, k):
            r = grads_of(params, mb)
            tot = r if tot is None else add(tot, r)
        return tot

    def mean(loss, parts, grads, k):
        # a device tensor divisor: a CUDA tensor divided by a Python
        # number is multiplied by its reciprocal, jnp truly divides
        kt = torch.tensor(float(k), device=loss.device)
        for g in grads:
            g.div_(kt)
        return loss / kt, {n: v / kt for n, v in parts.items()}, grads

    def accumulate(params, batch, node_shares=None):
        if node_shares is not None and len(node_shares) > 1 \
                and len(set(node_shares)) > 1:
            tot = None
            for s, sub in zip(node_shares, split_by_shares(batch, node_shares)):
                r = scan_sum(params, sub, s)
                tot = r if tot is None else add(tot, r)
            return mean(*tot, sum(node_shares))
        # equal (or absent) shares: literally the plain path
        k = run.microbatch or 1
        if k > 1:
            return mean(*scan_sum(params, batch, k), k)
        return grads_of(params, batch)

    def train_step(params, opt_state, batch, step,
                   node_shares: Optional[Sequence[int]] = None):
        loss, parts, grads = accumulate(params, batch, node_shares=node_shares)
        grads = tree_unflatten(params, grads)
        lr = lr_at(step, base_lr=run.learning_rate,
                   warmup_steps=run.warmup_steps, total_steps=run.total_steps)
        params2, opt2, om = adamw_update(
            grads, opt_state, params, lr=lr, b1=run.b1, b2=run.b2,
            eps=run.eps, weight_decay=run.weight_decay,
            grad_clip=run.grad_clip, moments=moments)
        metrics = {"loss": loss, "lr": lr, **parts, **om}
        return params2, opt2, metrics

    return train_step
