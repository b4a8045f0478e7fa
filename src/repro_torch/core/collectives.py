"""Multi-path collectives, the counterpart of ``repro/core/collectives.py``.

Each JAX ``shard_map`` body here is a function of this rank's *local*
tensors that takes the axis's process group (``Mesh.get_group(axis)``)
in place of the axis name. The schedule stays explicit:

- ``ring_all_gather``: two counter-rotating rings each carrying half the
  payload (the paper's Fig 5: opposite-direction flows multiplex on a
  bidirectional link), or one ring;
- ``ring_reduce_scatter``: a one-way ring of partial sums;
- ``hierarchical_all_reduce_inner``: reduce-scatter on the fast axis,
  all-reduce of the 1/n_fast shard on the slow axis, all-gather back
  (the "offload only a small fraction onto the slow path" rule);
- ``compressed_ring_all_reduce_inner``: an int8 ring with per-hop
  requantization and a quantized all-gather (LineFS's "compress before
  the slow path" applied to gradient sync);
- ``chunked``: segment a large payload (Advice #2/#3).

The JAX primitives map as: ``axis_index`` -> ``dist.get_rank(group)``,
``axis_size`` -> ``dist.get_world_size(group)``, ``ppermute`` ->
``shift`` (``dist.batch_isend_irecv``), ``psum``/``pmax`` ->
``all_reduce``, ``all_gather(tiled=True)`` -> ``all_gather``,
``psum_scatter`` -> ``reduce_scatter``.

**Backward.** ``all_reduce`` (sum), ``all_gather``, ``pvary`` and
``shard`` differentiate as JAX transposes the same code inside a
``shard_map``, in its convention that a value replicated over a group
carries its whole cotangent on every rank: the backward of ``psum`` is
the identity, of ``all_gather(tiled=True)`` the ``psum_scatter`` of the
cotangent, of ``pvary`` (a replicated value entering work that differs
per rank) the ``psum``, and of ``shard`` (this rank's slice of a
replicated tensor) the ``all_gather`` of the slices' cotangents. A
leaf replicated over an axis whose ranks see different data (the batch
axes) thus ends with this rank's share of its grad, and the caller sums
or averages the shares, as the train step's sync does. Without grad
the forward is the one plain call: the same bytes and counters.

**Transport.** The groups are gloo's. Every tensor that crosses one goes
through ``host_staged``: a CUDA tensor is copied into pinned host
memory, the gloo op runs there and the result is copied back to the
card (``host_staged.bytes`` counts both copies); a CPU tensor goes
as it is. One card cannot hold two NCCL ranks, so SPMD ranks that share
it talk through host memory, never NVLink. ``shift.bytes`` counts what
the rings send.
"""
from __future__ import annotations

from typing import Callable, Sequence, Union

import torch
import torch.distributed as dist

# ----------------------------------------------------------------------
# transport
# ----------------------------------------------------------------------


def _pinned(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    host_staged.bytes += x.numel() * x.element_size()
    return h


def to_host(x: torch.Tensor) -> torch.Tensor:
    """``x`` in host memory (a CUDA tensor copied there, counted in
    ``host_staged.bytes``; a CPU tensor as it is): for an exchange whose
    result stays on the host. Pageable, not pinned: a one-off copy of a
    whole block would stay in the pinned cache."""
    if x.device.type == "cpu":
        return x
    host_staged.bytes += x.numel() * x.element_size()
    return x.to("cpu")


def host_back(x: torch.Tensor, device) -> torch.Tensor:
    """``to_host``'s inverse: a host tensor copied to ``device`` (counted
    in ``host_staged.bytes``), or ``x`` as it is on the CPU."""
    if torch.device(device).type == "cpu":
        return x
    host_staged.bytes += x.numel() * x.element_size()
    return x.to(device)


def host_staged(op: Callable, *xs: torch.Tensor):
    """``op(*xs)`` where ``op`` runs gloo collectives: on CPU tensors as
    they are; for CUDA tensors on pinned host copies, with the result (a
    tensor or a tuple or list of them) copied back to the first input's
    device. Counts the bytes copied each way in ``host_staged.bytes``."""
    dev = xs[0].device
    if dev.type == "cpu":
        return op(*xs)
    out = op(*(_pinned(x) for x in xs))

    def back(t):
        host_staged.bytes += t.numel() * t.element_size()
        return t.to(dev)
    if isinstance(out, (tuple, list)):
        return type(out)(back(t) for t in out)
    return back(out)


host_staged.bytes = 0


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    def run(h):
        h = h.clone() if h is x else h
        dist.all_reduce(h, op=op, group=group)
        return h
    return host_staged(run, x.contiguous())


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()

    def run(h):
        out = torch.empty((n * h.shape[0],) + tuple(h.shape[1:]), dtype=h.dtype)
        dist.all_gather_into_tensor(out, h, group=group)
        return out
    return host_staged(run, xt).movedim(0, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``psum_scatter`` over ``dim``: x (n*m, ...) -> this rank's summed
    (m, ...) block."""
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()

    def run(h):
        out = torch.empty((h.shape[0] // n,) + tuple(h.shape[1:]), dtype=h.dtype)
        dist.reduce_scatter_tensor(out, h, group=group)
        return out
    return host_staged(run, xt).movedim(0, dim)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def _own_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    k = x.shape[dim] // dist.get_world_size(group)
    return x.narrow(dim, dist.get_rank(group) * k, k)


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own_slice(x, group, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``psum`` (or ``pmax`` with ``op=MAX``) over ``group``; a new tensor.
    The sum's backward is the identity; ``pmax`` has none (JAX's has no
    transpose either)."""
    if _needs_grad(x):
        if op != dist.ReduceOp.SUM:
            raise NotImplementedError("all_reduce: only the sum has a backward")
        return _Psum.apply(x, group)
    return _all_reduce(x, group, op)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``all_gather(tiled=True)``: the group's shards concatenated along
    ``dim`` in group-rank order. Backward: the cotangent's
    ``reduce_scatter`` along ``dim``."""
    if _needs_grad(x) and dist.get_world_size(group) > 1:
        return _AllGather.apply(x, group, dim)
    return _all_gather(x, group, dim)


def pvary(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, replicated over ``group``, as the input of work that differs
    per rank: the identity, whose backward sums the ranks' cotangents
    (``jax.lax.pvary``'s transpose)."""
    return _Pvary.apply(x, group) if _needs_grad(x) else x


def shard(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's 1/n of ``x`` (replicated over ``group``) along ``dim``,
    in group-rank order; ``dim`` must divide by n. Backward: the
    ``all_gather`` of the ranks' cotangents, the whole tensor's grad."""
    return _Shard.apply(x, group, dim) if _needs_grad(x) else _own_slice(x, group, dim)


def shift(xs: Sequence[torch.Tensor], group, step: Union[int, Sequence[int]] = 1):
    """``ppermute`` of every tensor in ``xs`` round the group's ring, all
    in one batch: tensor i goes from each rank ``r`` to ``r - step_i`` (it
    receives from ``r + step_i``); ``step`` is one int for all or one per
    tensor. ``step=1`` is JAX's ``bwd`` perm ``(i+1) -> i``, ``step=-1``
    its ``fwd``. Returns the received tensors, one per input."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    steps = [step] * len(xs) if isinstance(step, int) else list(step)
    peers = [(dist.get_global_rank(group, (r - k) % n), dist.get_global_rank(group, (r + k) % n))
             for k in steps]
    shift.bytes += sum(x.numel() * x.element_size() for x in xs)

    def run(*hs):
        recv = [torch.empty_like(h) for h in hs]
        ops = []
        for tag, (h, out, (to, frm)) in enumerate(zip(hs, recv, peers)):
            ops.append(dist.P2POp(dist.isend, h, to, group, tag))
            ops.append(dist.P2POp(dist.irecv, out, frm, group, tag))
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return recv
    return host_staged(run, *(x.contiguous() for x in xs))


shift.bytes = 0


def _place(parts, order, n):
    """``zeros_like(parts).at[order].set(parts)``: part j goes to slot
    ``order[j]``."""
    out = [None] * n
    for j, p in enumerate(parts):
        out[order[j]] = p
    return out


# ----------------------------------------------------------------------
# in-shard primitives (a shard_map body's view: local tensors)
# ----------------------------------------------------------------------

def ring_all_gather(x: torch.Tensor, group, *, bidirectional: bool = True) -> torch.Tensor:
    """All-gather along the group. x: local shard (chunk, ...). Returns
    (n*chunk, ...) in group-rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    idx = dist.get_rank(group)
    if not bidirectional:
        parts, carry = [x], x
        for _ in range(n - 1):
            (carry,) = shift([carry], group, 1)          # pull from the right
            parts.append(carry)                          # rank idx+1+j
        return torch.cat(_place(parts, [(idx + j) % n for j in range(n)], n), dim=0)

    # two half-payload counter-rotating rings
    half = x.shape[0] // 2
    if half == 0 or x.shape[0] % 2:
        return ring_all_gather(x, group, bidirectional=False)
    a, b = x[:half], x[half:]
    parts_a, parts_b = [a], [b]
    for _ in range(n - 1):
        # ring direction 1 pulls from the right, direction 2 from the left
        a, b = shift([a, b], group, [1, -1])
        parts_a.append(a)                                # rank idx+j
        parts_b.append(b)                                # rank idx-j
    out_a = _place(parts_a, [(idx + j) % n for j in range(n)], n)
    out_b = _place(parts_b, [(idx - j) % n for j in range(n)], n)
    return torch.cat([t for pa, pb in zip(out_a, out_b) for t in (pa, pb)], dim=0)


def ring_reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """Reduce-scatter along the group. x: full local copy (n*chunk, ...);
    returns this rank's reduced chunk (chunk, ...)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    idx = dist.get_rank(group)
    xr = x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
    # start from the partial of chunk idx+1; after n-1 hops each rank
    # holds the sum of its own chunk but for its own term
    acc = torch.zeros_like(xr[0])
    for j in range(n - 1):
        acc = acc + xr[(idx + 1 + j) % n]
        (acc,) = shift([acc], group, 1)
    return acc + xr[idx]


def hierarchical_all_reduce_inner(x: torch.Tensor, fast_group, slow_group) -> torch.Tensor:
    """psum via RS(fast) -> AR(slow, 1/n_fast of the bytes) -> AG(fast)."""
    n = dist.get_world_size(fast_group)
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad,))])
    shard = reduce_scatter(flat, fast_group)
    shard = all_reduce(shard, slow_group)
    out = all_gather(shard, fast_group)
    if pad:
        out = out[:-pad]
    return out.reshape(x.shape)


# ----------------------------------------------------------------------
# quantized ring all-reduce (gradient compression over the slow path)
# ----------------------------------------------------------------------

def _quant_int8(x: torch.Tensor):
    """Per-tensor int8: scale = max|x| / 127 + 1e-30, q = clip(round(x /
    scale)). Both divisions are by device tensors, true divisions as
    jnp's (torch multiplies a CUDA tensor by the reciprocal of a Python
    number)."""
    scale = torch.max(torch.abs(x)) / torch.tensor(127.0, device=x.device) + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_ring_all_reduce_inner(x: torch.Tensor, group) -> torch.Tensor:
    """int8 ring all-reduce: a reduce-scatter phase that requantizes at
    every hop, then a quantized all-gather phase. The ring carries int8
    and one f32 scale a hop, ~1/4 of f32's bytes. Lossy: pair it with
    error feedback upstream."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    idx = dist.get_rank(group)
    orig_shape, orig_dtype = x.shape, x.dtype
    flat = x.reshape(-1).float()
    pad = (-flat.shape[0]) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad,))])
    xr = flat.reshape(n, -1)

    acc = torch.zeros_like(xr[0])
    for j in range(n - 1):
        acc = acc + xr[(idx + 1 + j) % n]
        q, s = _quant_int8(acc)
        q, s = shift([q, s], group, 1)
        acc = _dequant_int8(q, s)
    mine = acc + xr[idx]                     # reduced chunk for rank idx

    # all-gather phase, also quantized
    q, s = _quant_int8(mine)
    parts = [_dequant_int8(q, s)]
    for _ in range(n - 1):
        q, s = shift([q, s], group, 1)
        parts.append(_dequant_int8(q, s))
    out = torch.cat(_place(parts, [(idx + j) % n for j in range(n)], n))
    if pad:
        out = out[:-pad]
    return out.reshape(orig_shape).to(orig_dtype)


# ----------------------------------------------------------------------
# host-callable wrappers (the shard_map's in and out specs)
# ----------------------------------------------------------------------

def all_gather_bidirectional(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """x: this rank's dim-0 shard of a tensor split over ``axis`` -> the
    whole tensor, gathered by the two counter-rotating rings."""
    return ring_all_gather(x, mesh.get_group(axis), bidirectional=True)


def all_reduce_hierarchical(x: torch.Tensor, mesh, fast_axis: str,
                            slow_axis: str) -> torch.Tensor:
    """x: this rank's value -> its sum over both axes."""
    return hierarchical_all_reduce_inner(x, mesh.get_group(fast_axis),
                                         mesh.get_group(slow_axis))


def all_reduce_compressed(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """x: this rank's value -> its sum over ``axis`` through the int8 ring."""
    return compressed_ring_all_reduce_inner(x, mesh.get_group(axis))


def chunked(fn, x: torch.Tensor, chunk_bytes: int) -> torch.Tensor:
    """Apply collective ``fn`` to fixed-size segments of dim 0 (the paper's
    Advice #2/#3: segment large transfers). ``fn`` must keep the shape."""
    if chunk_bytes <= 0:
        return fn(x)
    itemsize = x.element_size()
    row = 1
    for s in x.shape[1:]:
        row *= s
    rows = max(1, chunk_bytes // max(itemsize * row, 1))
    if rows >= x.shape[0]:
        return fn(x)
    nchunks = -(-x.shape[0] // rows)
    return torch.cat([fn(x[i * rows:(i + 1) * rows]) for i in range(nchunks)], dim=0)

