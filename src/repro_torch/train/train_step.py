"""The train step, the counterpart of ``repro/train/train_step.py``:
forward + CE, backward, clip, AdamW.

- ``microbatch``: gradient accumulation over k microbatches of B/k (the
  JAX ``lax.scan`` is a loop here): f32 sums, then the mean;
- ``node_shares``: skew-aware batch assembly, each node's contiguous
  sub-batch accumulated on its own; equal shares take the plain path;
- remat policy (``RunConfig.remat_policy``): none | minimal | full
  (``models/model.py::forward``);
- ``moments_int8``: AdamW moments stored blockwise-int8, through the CUDA
  quantize / dequantize kernels on the card;
- ``mesh``: SPMD ranks (``parallel/sharding.Mesh``), each given the
  whole global batch and the train state either in blocks (the
  launcher's: ``launch/inputs.train_layout``, JAX's ``param_shardings``
  and ``_opt_logical``, cut by ``parallel/sharding.place``) or whole. A
  rank takes its share of the batch over the batch axes (``pod``,
  ``data``; ``model`` ranks compute the same share). From blocks the
  step runs under ``use_mesh(mesh)`` and the model computes FSDP over
  ``data`` and tensor-parallel over ``model`` (``models/model.py``); a
  block's grad comes back as a block, and a leaf split over ``data``
  has been summed over it by its gather's backward (a reduce-scatter),
  so it is divided by the axis's size and not all-reduced again; the
  optimizer steps the blocks (``optim/adamw.py``). From whole params
  every rank computes the whole model on its share. Either way the
  grads (of a replicated axis), loss and parts are averaged over the
  batch axes by one exact all-reduce each, where JAX's SPMD partitioner
  takes the mean over the batch. With ``pod_sync=
  "compressed"`` and a ``pod`` axis of size > 1 (``train_step.py:
  160-191``), the exact mean runs over ``data`` only (the pod's share,
  with "batch" resolved to data), and each grad leaf crosses the pods
  through the int8 ring (``core/collectives.compressed_ring_all_reduce_inner``
  of g / n_pod, a block's ring on the block), the LineFS "compress
  before the slow path" choice;
  loss and parts take the pods' mean. Each shard's CE is weighted by
  its share of the mask count (one all-reduce of the counts per
  microbatch), so the mean over the shards is JAX's global mean,
  sum(mask·ce) / sum(mask), also where the shards' counts differ; and a
  rank's microbatch j is its share of the global batch's microbatch j,
  as JAX splits the global batch before the partitioner shards it. The
  MoE aux loss is the mean of the shards' own: under ``use_mesh`` the
  layer takes that mean itself (``models/moe.py``), and every rank holds
  it whole; its backward hands each of the n shards 1/n of the
  cotangent, and the step averages the ranks' grads, so the aux term
  weighs n times in each rank's differentiated objective (the loss it
  reports is the plain one).

Grads come from ``torch.autograd.grad`` on the f32 master leaves.

``host_tracer`` (an ``obs/host.HostTracer``) records the step's phases on
the host's wall clock, each in the profiler's timeline while one
records: ``train.step``; per microbatch ``train.forward`` (``loss_fn``;
its ``microbatch`` index in the accumulation and its ``tokens``) and
``train.backward`` (``torch.autograd.grad``); ``train.accumulate`` (each
sum of two microbatches' grads, and the mean); ``train.optimizer``
(``adamw_update``). The mesh path's collectives have no span of their
own. Without a tracer (the default) each site costs one test of
``None``; tracing changes no parameter.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.collectives import all_reduce, compressed_ring_all_reduce_inner
from repro_torch.launch.inputs import train_layout
from repro_torch.models import model as M
from repro_torch.models.attention import train_impl
from repro_torch.models.moe import aux_shards
from repro_torch.optim.adamw import adamw_update, tree_leaves, tree_unflatten
from repro_torch.optim.schedule import lr_at
from repro_torch.parallel.sharding import (local_shard, logical_to_spec, rule_overrides,
                                           spec_axes, use_mesh)

PyTree = Any
Batch = Dict[str, torch.Tensor]


def loss_fn(cfg: ModelConfig, params: PyTree, batch: Batch, *,
            impl: str = "auto", remat: str = "minimal",
            capacity_factor: Optional[float] = 1.25, loss_chunk: int = 512,
            ce_weight: Optional[torch.Tensor] = None):
    """(CE + router_aux_loss · aux, {"ce", "aux"}) (``train_step.py:36-46``):
    the batch's ``frontend_embeds`` go in front of its tokens, MoE layers
    dispatch at ``capacity_factor``. ``impl="auto"`` is the JAX package's
    rule for a training forward (``train_impl``) at the whole sequence's
    length: the plain attention below 2048 tokens, the blocked scan from
    2048, never the forward-only CUDA kernels. ``ce_weight`` scales the
    CE (a shard's share of a batch's mask count, on a mesh)."""
    fe = batch.get("frontend_embeds")
    if impl == "auto":
        impl = train_impl(batch["tokens"].shape[1] + (0 if fe is None else fe.shape[1]))
    res = M.forward(cfg, params, batch["tokens"], fe, impl=impl, remat=remat,
                    capacity_factor=capacity_factor)
    ce = M.cross_entropy(cfg, params, res.hidden, batch["labels"],
                         batch["loss_mask"], chunk=loss_chunk)
    if ce_weight is not None:
        ce = ce * ce_weight
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


def _mean_over(xs, mesh, axes, summed=None):
    """Each tensor of ``xs`` averaged over the mesh ``axes`` (one exact
    all-reduce per axis, then one division by a device tensor); item i
    skips the all-reduce over the axes in ``summed[i]``, over which it is
    a sum already. The list ``xs`` is returned with each item replaced as
    it is averaged, so no more than one tensor is held twice."""
    if not axes:
        return xs
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    for i, x in enumerate(xs):
        for a in axes:
            if summed is None or a not in summed[i]:
                x = all_reduce(x, mesh.get_group(a))
        xs[i] = x / torch.tensor(float(n), device=x.device)
    return xs


def make_train_step(cfg: ModelConfig, run: RunConfig, *, impl: str = "auto",
                    mesh=None, capacity_factor: Optional[float] = 1.25,
                    loss_chunk: int = 512, host_tracer=None):
    """Returns ``train_step(params, opt_state, batch, step,
    node_shares=None) -> (params, opt_state, metrics)``. ``params`` and
    f32 moments are updated in place (``optim/adamw.py``). ``node_shares``
    (per-node microbatch counts): equal shares take the unchanged plain
    path, so they are bit-identical to passing none; skewed shares run
    each node's sub-batch and combine the sums into the same global
    mean. With ``mesh``, every rank calls it with the same global batch
    and its blocks of the train state, or the whole state (module
    docstring). MoE layers dispatch at ``capacity_factor``; ``host_tracer``
    records the step's phases (module docstring)."""
    moments = "int8" if run.moments_int8 else "f32"
    aux_w = cfg.router_aux_loss if cfg.num_experts else 0.0
    layout = None if mesh is None else train_layout(cfg, mesh, moments)
    ht = host_tracer

    def grads_of(params, batch, weigh=None, index=0):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        w = None if weigh is None else weigh(batch["loss_mask"])
        n_aux = aux_shards() if mesh is not None and aux_w else 1
        with torch.enable_grad():
            if ht is not None:
                tok = batch["tokens"]
                span = ht.open("train.forward", microbatch=index,
                               tokens=tok.shape[0] * tok.shape[1])
            loss, parts = loss_fn(cfg, tree_unflatten(params, leaves), batch,
                                  impl=impl, remat=run.remat_policy,
                                  capacity_factor=capacity_factor,
                                  loss_chunk=loss_chunk, ce_weight=w)
            obj = loss if n_aux == 1 else loss + (n_aux - 1) * aux_w * parts["aux"]
            if ht is not None:
                ht.close(span)
                span = ht.open("train.backward", microbatch=index)
            grads = torch.autograd.grad(obj, leaves, allow_unused=True,
                                        materialize_grads=True)
            if ht is not None:
                ht.close(span)
        parts = {k: v.detach() for k, v in parts.items()}
        return loss.detach(), parts, list(grads)

    def add(tot, r):
        """Sum two (loss, parts, grads) results; the grads of ``tot`` in
        place."""
        if ht is not None:
            span = ht.open("train.accumulate")
        for a, b in zip(tot[2], r[2]):
            a.add_(b.float())
        out = (tot[0] + r[0], {k: tot[1][k] + r[1][k] for k in tot[1]}, tot[2])
        if ht is not None:
            ht.close(span)
        return out

    def scan_sum(params, batch, k, weigh=None):
        """Sum (not mean) of loss/parts/f32-grads over ``k`` microbatches.
        The first microbatch's grads start the sum (0 + g is g), which
        saves a zeroed f32 copy of the params."""
        tot = None
        for j, mb in enumerate(_split_microbatches(batch, k)):
            r = grads_of(params, mb, weigh, j)
            tot = r if tot is None else add(tot, r)
        return tot

    def mean(loss, parts, grads, k):
        if ht is not None:
            span = ht.open("train.accumulate")
        # a device tensor divisor: a CUDA tensor divided by a Python
        # number is multiplied by its reciprocal, jnp truly divides
        kt = torch.tensor(float(k), device=loss.device)
        for g in grads:
            g.div_(kt)
        out = loss / kt, {n: v / kt for n, v in parts.items()}, grads
        if ht is not None:
            ht.close(span)
        return out

    def skewed(node_shares):
        return node_shares is not None and len(node_shares) > 1 \
            and len(set(node_shares)) > 1

    def accumulate(params, batch, node_shares=None, weigh=None):
        if skewed(node_shares):
            tot = None
            for s, sub in zip(node_shares, split_by_shares(batch, node_shares)):
                r = scan_sum(params, sub, s, weigh)
                tot = r if tot is None else add(tot, r)
            return mean(*tot, sum(node_shares))
        # equal (or absent) shares: literally the plain path
        k = run.microbatch or 1
        if k > 1:
            return mean(*scan_sum(params, batch, k, weigh), k)
        return grads_of(params, batch, weigh)

    def on_mesh(params, batch, node_shares, sharded):
        """This rank's share of the batch, its grads and their means;
        ``sharded``: the params are this rank's blocks."""
        b = next(iter(batch.values())).shape[0]
        npod = mesh.shape.get("pod", 1)
        compressed = run.pod_sync == "compressed" and npod > 1
        if compressed:
            if b % npod:
                raise ValueError(f"batch of {b} does not split over {npod} pods")
            with rule_overrides({"batch": "data", "decode_batch": "data"}):
                mean_axes = spec_axes(logical_to_spec(("batch",), mesh,
                                                      dim_sizes=(b // npod,))[0])
            batch = {k: local_shard(v, mesh, ("pod",)) for k, v in batch.items()}
        else:
            mean_axes = spec_axes(logical_to_spec(("batch",), mesh, dim_sizes=(b,))[0])
        # this rank's share of each microbatch of the (pod's) batch, in
        # order, so that its microbatch j is its share of JAX's microbatch j
        nmb = sum(node_shares) if skewed(node_shares) else run.microbatch or 1
        spec0 = (mean_axes or None,)
        local = {k: torch.cat([local_shard(mb[k], mesh, spec0)
                               for mb in _split_microbatches(batch, nmb)])
                 for k in batch}
        n = 1
        for a in mean_axes:
            n *= mesh.shape[a]

        def weigh(mask):
            """This shard's share of the mask count over ``mean_axes``,
            times their size: the mean of the weighted CEs is the global
            sum(mask·ce) / sum(mask), as JAX's."""
            own = tot = mask.sum()
            for a in mean_axes:                 # a new tensor each time
                tot = all_reduce(tot, mesh.get_group(a))
            nt = torch.tensor(float(n), device=own.device)
            return torch.clamp(own, min=1.0) * nt / torch.clamp(tot, min=1.0)

        with use_mesh(mesh) if sharded else contextlib.nullcontext():
            loss, parts, grads = accumulate(params, local, node_shares=node_shares,
                                            weigh=weigh if mean_axes else None)
        names = list(parts)
        scalars = _mean_over([torch.stack([loss] + [parts[k] for k in names])], mesh,
                             mean_axes)[0]
        # a block split over a batch axis was summed over it by its gather's backward
        summed = [b.axes() if sharded and b.is_block(g) else ()
                  for g, b in zip(grads, tree_leaves(layout[0]))]
        grads = _mean_over(grads, mesh, mean_axes, summed)
        if compressed:
            pod = mesh.get_group("pod")
            npod_t = torch.tensor(float(npod), device=scalars.device)
            for i, g in enumerate(grads):   # in place: one leaf held twice at most
                grads[i] = compressed_ring_all_reduce_inner(g.float() / npod_t, pod).to(g.dtype)
            scalars = _mean_over([scalars], mesh, ("pod",))[0]
        return scalars[0], {k: scalars[i + 1] for i, k in enumerate(names)}, grads

    def train_step(params, opt_state, batch, step,
                   node_shares: Optional[Sequence[int]] = None):
        if ht is None:
            return one_step(params, opt_state, batch, step, node_shares)
        with ht.phase("train.step", step=step):
            return one_step(params, opt_state, batch, step, node_shares)

    def one_step(params, opt_state, batch, step, node_shares):
        sharded = layout is not None and any(
            b.is_block(p) for p, b in zip(tree_leaves(params), tree_leaves(layout[0])))
        if mesh is None:
            loss, parts, grads = accumulate(params, batch, node_shares=node_shares)
        else:
            loss, parts, grads = on_mesh(params, batch, node_shares, sharded)
        grads = tree_unflatten(params, grads)
        lr = lr_at(step, base_lr=run.learning_rate,
                   warmup_steps=run.warmup_steps, total_steps=run.total_steps)
        if ht is not None:
            span = ht.open("train.optimizer")
        params2, opt2, om = adamw_update(
            grads, opt_state, params, lr=lr, b1=run.b1, b2=run.b2,
            eps=run.eps, weight_decay=run.weight_decay,
            grad_clip=run.grad_clip, moments=moments,
            **(dict(mesh=mesh, layout=layout) if sharded else {}))
        if ht is not None:
            ht.close(span)
        metrics = {"loss": loss, "lr": lr, **parts, **om}
        return params2, opt2, metrics

    return train_step
