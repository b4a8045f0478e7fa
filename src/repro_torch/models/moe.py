"""Mixture-of-Experts with capacity-based dispatch, the counterpart of
``repro/models/moe.py``.

Two execution paths, as in the JAX module:

- no mesh: ``_moe_local`` (``moe.py:136``), the plain local dispatch;
- under ``use_mesh``: explicit **expert parallelism** (``moe.py:165-251``)
  on this rank's local tensors. Activations are replicated across the
  ``model`` axis, so every model rank holds the tokens: each routes them
  identically, takes only those routed to *its* E/TP experts
  (``lo = rank · E_local``), computes locally, and one sum over
  ``model`` combines the partial outputs (no all-to-all, no
  cross-rank cumsum). The FSDP gathers of the router and expert weights
  over ``data`` happen explicitly inside, so the collective schedule is
  visible. Its backward is the transpose JAX takes of ``moe.py:199-251``
  (``core/collectives.py``'s backward rules): the sum over ``model``
  is the identity, the tokens and router weights that enter the
  rank's experts sum their grads over ``model``, a whole weight cut to
  the rank's experts gathers its experts' grads over ``model``, an FSDP
  gather reduce-scatters over ``data``, and the aux loss's mean over the
  batch axes hands each shard 1/n of the cotangent.

Without a mesh the layer may hold only experts [0, E_held) of the E the
router scores (``_moe_local``): a chip's share of an expert-parallel
layer, routing over all and computing its own experts' part of the
result, as a rank of ``_moe_ep`` does, without the exchange. Its
lossless dispatch (capacity ``None``: ``_capacity`` gives T) has a
buffer of ``E_held x T`` rows whatever the routing, and nothing in it
reads the device from the host or copies a host value in, so the serve
engine replays an MoE decode step as a CUDA graph
(``serve/decode_graph.py``). The decode step leaves the metrics out
(``metrics=False``), which it would throw away.

Tokens are routed top-k (``router_topk``), scattered into a per-expert
capacity buffer of ``cap`` rows each (``_dispatch_compute_combine``), run
through the experts' gated MLPs as two batched bf16 products
(``_expert_compute``; the JAX package computes them outside any Pallas
kernel, so they stay ``torch`` products here) and combined back in token
order with the router weights. Assignments past an expert's capacity
drop. Two orders must be JAX's for the tokens to be:

- ``jax.lax.top_k`` puts the lower index first among equal values, and
  ``torch.topk`` promises no order: ``_topk`` takes a stable descending
  sort (router probabilities, and the integer ``counts`` of
  ``replicate_hot_experts``, where ties are common);
- a slot is its assignment's position within its expert in flattened
  (token, k) order, the cumsum of ``moe.py:83``, with the trash bucket
  at ``e_local * cap``.

Skew note (the paper's Advice #1): Zipfian routing collapses throughput
on the "wimpy" path exactly like DDIO-less SoC writes; capacity factors
bound the damage, and ``replicate_hot_experts`` splits the hottest
experts' queues.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import all_reduce, pvary, shard
from repro_torch.models.layers import fsdp_gather
from repro_torch.parallel.sharding import current_mesh


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor       # load-balancing loss
    dropped_frac: torch.Tensor   # fraction of (token, k) assignments dropped
    expert_load: torch.Tensor    # (E,) fraction of assignments per expert


def _topk(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest along the last dim, the lower
    index first among equal values (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def router_topk(x2d: torch.Tensor, w_router: torch.Tensor, k: int):
    """x2d (T,D); returns (weights (T,k) renormalized, idx (T,k), probs
    (T,E)), the router product and softmax in f32 (``moe.py:38-44``)."""
    logits = x2d.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    weights, idx = _topk(probs, k)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return weights, idx, probs


def _counts(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """How many entries of ``idx`` name each of ``n`` experts."""
    flat = idx.reshape(-1).long()
    return torch.zeros((n,), dtype=dtype, device=idx.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=dtype, device=idx.device))


def _share(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x / max(n, 1)`` in f32, a true division as jnp's. The divisor is a
    tensor on x's device: torch multiplies a CUDA tensor by the reciprocal
    of a Python number, so a count of n over n would not be 1. It is
    filled there (``torch.full``), not copied from the host, which would
    wait for the device."""
    return x.float() / torch.full((), float(max(n, 1)), dtype=torch.float32,
                                  device=x.device)


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * p_e (``moe.py:47-52``)."""
    f = _share(_counts(idx, num_experts, torch.float32), idx.numel())
    p = probs.mean(dim=0)
    return num_experts * torch.sum(f * p)


def _capacity(t: int, k: int, e: int, capacity_factor: Optional[float]) -> int:
    if capacity_factor is None:
        return t
    return max(1, -(-int(capacity_factor * t * k) // e))


def _expert_compute(buf_e: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
                    activation) -> torch.Tensor:
    """buf_e (E, C, D) x w_in (E, D, 2, F) -> (E, C, D), bf16 products
    (``moe.py:61-68``)."""
    h = torch.einsum("ecd,edtf->ectf", buf_e.to(torch.bfloat16), w_in.to(torch.bfloat16))
    h = activation(h[..., 0, :]) * h[..., 1, :]
    return torch.einsum("ecf,efd->ecd", h, w_out.to(torch.bfloat16))


def _dispatch_compute_combine(x2d, weights, idx, *, lo: int, e_local: int, cap: int,
                              w_in, w_out, activation):
    """Scatter the tokens routed to experts [lo, lo + e_local) into a
    capacity buffer, run them, and combine the weighted outputs back in
    token order (``moe.py:71-98``). Returns (y (T,D) f32, kept mask,
    is_mine mask over (T*k,))."""
    t, d = x2d.shape
    k = idx.shape[1]
    flat_e = idx.reshape(t * k)
    is_mine = (flat_e >= lo) & (flat_e < lo + e_local)
    eff = torch.where(is_mine, flat_e - lo, e_local)               # trash bucket
    # one-hot by comparison: F.one_hot may check its classes on the host
    onehot = (eff[:, None] == torch.arange(e_local, device=eff.device)).long()
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1       # (T*k,)
    keep = is_mine & (pos < cap) & (pos >= 0)
    slot = torch.where(keep, eff * cap + pos, e_local * cap)

    x_rep = x2d[:, None].expand(t, k, d).reshape(t * k, d)         # each token k times
    # every dropped assignment writes the trash row, which no expert reads
    buf = x2d.new_zeros((e_local * cap + 1, d)).index_put((slot,), x_rep)
    out = _expert_compute(buf[:e_local * cap].reshape(e_local, cap, d),
                          w_in, w_out, activation)
    out_flat = torch.cat([out.reshape(e_local * cap, d), out.new_zeros((1, d))])
    y_rep = out_flat[slot] * keep[:, None]
    y = (y_rep.reshape(t, k, d).float() * weights[..., None]).sum(dim=1)
    return y, keep, is_mine


def replicate_hot_experts(idx: torch.Tensor, probs: Optional[torch.Tensor], *,
                          num_experts: int, replicas: int, num_hot: int = 2):
    """The paper's Advice #1 (``moe.py:101-133``): assignments to the
    ``num_hot`` most-loaded experts are split round-robin across
    ``replicas`` virtual experts, each with its own capacity queue
    (DrTM-KV's "replicate a few hot keys to tame the skewness").

    Returns (virtual idx (T,k) over E + num_hot * (replicas - 1) experts,
    parent map (E_virt,) that gathers each virtual expert's weights).
    Among experts of equal load the lower index is the hotter, as
    ``jax.lax.top_k`` orders ties."""
    e = num_experts
    dev = idx.device
    if replicas <= 1 or num_hot <= 0:
        return idx, torch.arange(e, device=dev)
    t, k = idx.shape
    counts = _counts(idx, e, torch.int32)
    _, hot = _topk(counts, num_hot)                                # (num_hot,)
    # virtual expert table: parents[e + h*(replicas-1) + r] = hot[h]
    parents = torch.cat([torch.arange(e, device=dev)] + [hot] * (replicas - 1))
    # round-robin over (token, slot), mixing row and column indices so the
    # cycle never locks to the top-k column parity
    rows = torch.arange(t, device=dev)[:, None]
    cols = torch.arange(k, device=dev)[None, :]
    rep = (rows + cols) % replicas                                 # (T,k)
    match = idx[..., None] == hot[None, None, :]
    hot_slot = torch.argmax(match.to(torch.int32), dim=-1)
    is_hot = match.any(dim=-1)
    virt = torch.where(is_hot & (rep > 0), e + hot_slot * (replicas - 1) + (rep - 1), idx)
    return virt, parents


def _moe_local(x: torch.Tensor, params: dict, *, num_experts: int, top_k: int,
               activation, capacity_factor: Optional[float],
               hot_expert_replicas: int = 1, metrics: bool = True,
               held_count: Optional[torch.Tensor] = None):
    """``moe.py:136-163``: route, (optionally) replicate the hot experts,
    dispatch with capacity, combine; the metrics over the real experts.

    ``params["w_in"]`` holds experts [0, E_held) of the ``num_experts``
    the router scores (all of them, or a chip's share of an
    expert-parallel layer): every token is routed over all, and only the
    held experts' part of the result is computed, as ``_moe_ep``'s rank
    computes its own. ``metrics=False`` leaves the metrics out (None);
    ``held_count`` (an int64 device scalar) gains the (token, k)
    assignments the held experts kept. Neither reads the device from the
    host, so a decode step stays capturable as a CUDA graph."""
    b, s, d = x.shape
    e, k = num_experts, top_k
    held = params["w_in"].shape[0]
    if held != e and hot_expert_replicas > 1:
        raise ValueError("hot-expert replication needs every expert held")
    t = b * s
    x2d = x.reshape(t, d)
    weights, idx, probs = router_topk(x2d, params["router"], k)
    cap = _capacity(t, k, e, capacity_factor)
    w_in, w_out = params["w_in"], params["w_out"]
    didx = idx
    if hot_expert_replicas > 1:
        didx, parents = replicate_hot_experts(idx, probs, num_experts=e,
                                              replicas=hot_expert_replicas)
        w_in, w_out = w_in[parents], w_out[parents]
        held = parents.shape[0]
    y, keep, is_mine = _dispatch_compute_combine(
        x2d, weights, didx, lo=0, e_local=held, cap=cap,
        w_in=w_in, w_out=w_out, activation=activation)
    if held_count is not None:
        held_count.add_(keep.sum())
    y = y.reshape(b, s, d).to(x.dtype)
    if not metrics:
        return y, None
    aux = load_balance_loss(probs, idx, e)
    load = _share(_counts(idx, num_experts, torch.float32), idx.numel())
    if held < e:        # dropped among the assignments to the held experts
        dropped = 1.0 - keep.sum().float() / is_mine.sum().clamp(min=1).float()
    else:
        dropped = 1.0 - _share(keep.sum(), keep.numel())
    return y, MoEMetrics(aux_loss=aux, dropped_frac=dropped, expert_load=load)


def _moe_ep(x: torch.Tensor, params: dict, mesh, *, num_experts: int, top_k: int,
            activation, capacity_factor: Optional[float], ep: bool, bax):
    """The expert-parallel branch (``moe.py:199-251``) on this rank's
    local tensors. Each weight is this rank's shard (as its logical axes
    place it: experts over ``model``, d_model over ``data``) or the whole
    tensor, which is cut to this rank's experts locally (``shard``: its
    grad is gathered over ``model``)."""
    e = num_experts
    b_loc, s_loc, d = x.shape
    e_local = e // mesh.shape["model"] if ep else e
    lo = mesh.index("model") * e_local if ep else 0
    w_in, w_out = params["w_in"], params["w_out"]
    if w_in.shape[0] != e_local:
        w_in, w_out = (shard(w, mesh.get_group("model"), 0) for w in (w_in, w_out))
    router = fsdp_gather(params["router"], 0, d, mesh)
    w_in = fsdp_gather(w_in, 1, d, mesh)
    w_out = fsdp_gather(w_out, 2, d, mesh)
    t = b_loc * s_loc
    x2d = x.reshape(t, d)
    weights, idx, probs = router_topk(x2d, router, top_k)
    aux = load_balance_loss(probs, idx, e)
    cap = _capacity(t, top_k, e, capacity_factor)
    if ep:      # the replicated tokens and router weights meet this rank's experts
        x2d, weights = (pvary(v, mesh.get_group("model")) for v in (x2d, weights))
    y, keep, _ = _dispatch_compute_combine(
        x2d, weights, idx, lo=lo, e_local=e_local, cap=cap,
        w_in=w_in, w_out=w_out, activation=activation)
    if ep:
        # JAX's psum of bf16 y: XLA sums it in f32 and rounds once
        y = all_reduce(y.to(torch.bfloat16).float(), mesh.get_group("model"))
        y = y.to(torch.bfloat16)
        kept = all_reduce(keep.sum(), mesh.get_group("model"))
        dropped = 1.0 - _share(kept, idx.numel())
    else:
        dropped = 1.0 - _share(keep.sum(), keep.numel())
    load = _share(_counts(idx, e, torch.float32), idx.numel())
    for ax in bax:                                  # pmean over the batch axes
        packed = torch.cat([aux.reshape(1), dropped.reshape(1), load])
        packed = all_reduce(packed, mesh.get_group(ax)) / torch.tensor(
            float(mesh.shape[ax]), device=packed.device)
        aux, dropped, load = packed[0], packed[1], packed[2:]
    return y.reshape(b_loc, s_loc, d).to(x.dtype), \
        MoEMetrics(aux_loss=aux, dropped_frac=dropped, expert_load=load)


def aux_shards() -> int:
    """How many batch shards ``moe_ffn``'s aux loss is the mean of under
    ``current_mesh()``: the product of the batch axes (``pod``, ``data``)
    of size > 1, whose mean every rank then holds whole; 1 without a mesh."""
    mesh = current_mesh()
    return 1 if mesh is None else mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)


def moe_ffn(x: torch.Tensor, params: dict, *, num_experts: int, top_k: int,
            activation, capacity_factor: Optional[float] = 1.25,
            hot_expert_replicas: int = 1, metrics: bool = True,
            held_count: Optional[torch.Tensor] = None):
    """x (B,S,D) -> ((B,S,D), MoEMetrics, or None with ``metrics=False``).
    ``params``: ``router`` (D,E), ``w_in`` (E,D,2,F), ``w_out`` (E,F,D), or
    without a mesh the held experts [0, E_held) of them (``_moe_local``,
    which also takes ``held_count``). ``capacity_factor=None`` is
    lossless (each expert may take every token); ``hot_expert_replicas >
    1`` enables Advice #1's hot-expert replication (local dispatch only:
    the EP path balances by shard ownership).

    Under ``use_mesh`` with a ``model`` axis that divides E (``ep``) or a
    batch axis (``pod``, ``data``) of size > 1, the expert-parallel branch
    runs on this rank's local tensors: x is this rank's share of the batch
    split over every such batch axis (the metrics are averaged over
    them), each weight its shard or whole (``_moe_ep``). Otherwise the
    local dispatch."""
    mesh = current_mesh()
    e = num_experts
    if mesh is not None:
        msize = mesh.shape.get("model", 1)
        bax = [a for a in ("pod", "data") if mesh.shape.get(a, 1) > 1]
        ep = msize > 1 and e % msize == 0
        if ep or bax:
            return _moe_ep(x, params, mesh, num_experts=e, top_k=top_k,
                           activation=activation, capacity_factor=capacity_factor,
                           ep=ep, bax=bax)
    return _moe_local(x, params, num_experts=e, top_k=top_k,
                      activation=activation, capacity_factor=capacity_factor,
                      hot_expert_replicas=hot_expert_replicas, metrics=metrics,
                      held_count=held_count)


def moe_ffn_dense_ref(x: torch.Tensor, params: dict, *, num_experts: int,
                      top_k: int, activation) -> torch.Tensor:
    """Oracle: dense per-expert compute in f32, no capacity drops
    (``moe.py:254-270``). For tests."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    weights, idx, _ = router_topk(x2d, params["router"], top_k)
    y = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
    for ei in range(num_experts):
        h = torch.einsum("xd,dgf->xgf", x2d.float(), params["w_in"][ei].float())
        o = (activation(h[..., 0, :]) * h[..., 1, :]) @ params["w_out"][ei].float()
        wsum = torch.where(idx == ei, weights, 0.0).sum(-1)          # (T,)
        y = y + o * wsum[:, None]
    return y.reshape(b, s, d).to(x.dtype)

