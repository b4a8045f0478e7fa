"""Logical-axis sharding, the counterpart of ``repro/parallel/sharding.py``.

MaxText-style: every parameter and activation carries a tuple of
*logical* axis names; ``logical_to_spec`` resolves them against a mesh
through ``RULES``. Axes absent from the mesh degrade to replication, so
the same rules serve a one-process run, a small gloo mesh and the
16x16 / 2x16x16 production meshes (``launch/mesh.py``).

The JAX package's runtime objects map onto ``torch.distributed``:

- ``Mesh`` holds ``axis_names``, a ``shape`` mapping (name -> size, read
  as JAX's ``mesh.shape`` is), the rank's coordinates and the
  ``DeviceMesh`` whose per-axis process groups (``get_group(name)``)
  carry every collective. One process is one mesh position; the groups
  are gloo's, and a CUDA tensor crosses them only through
  ``core/collectives.host_staged``.
- ``use_mesh`` / ``current_mesh`` stand for ``jax.set_mesh`` and the
  abstract mesh that model code reads.
- A spec is a plain tuple with one entry per tensor dim, as
  ``PartitionSpec``'s: None, an axis name or a tuple of axis names.
  ``named_sharding`` turns it into DTensor placements on the mesh
  (``Shard(dim)`` or ``Replicate()`` per mesh axis).
- ``constrain`` is the identity on a plain tensor (each rank computes
  its replicated share, as JAX's partitioner would leave it) and
  redistributes a DTensor.
- A tree held in blocks (the train state on a mesh): ``tree_layout``
  gives each leaf's whole shape and spec (a ``BlockSpec``), ``place``
  cuts a whole tree into this rank's blocks, as ``jax.device_put`` with
  the tree's shardings leaves one device's ``addressable_shards``, and
  ``gather`` is its inverse. The blocks are plain tensors; the layout
  says what they are.

``logical_to_spec`` takes any object with a ``.shape`` mapping, so rule
tests run on a duck-typed mesh of any size without processes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch._device import resolve_device

Logical = Tuple[Optional[str], ...]
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# logical axis -> mesh axis (or tuple of mesh axes, in the mesh's order)
RULES = {
    # weights
    "fsdp": "data",              # weight dim sharded ZeRO-3 style
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",         # only when divisible; see below
    "mlp": "model",
    "experts": "model",
    "ssm_inner": "model",        # mamba2 heads/d_inner
    "layer_group": None,         # stacked-layer leading dim: never sharded
    "flat_shard": ("data", "model"),  # 1-D fully-sharded (int8 moments)
    "embed": None,               # d_model of activations / norm scales
    # activations
    "batch": ("pod", "data"),
    "decode_batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,              # becomes "data" under context parallelism
    "act_heads": "model",
    "act_mlp": "model",
    "act_vocab": "model",
    "act_experts": "model",
}

#: overrides for long-context decode (context parallelism): the KV cache /
#: sequence dim shards over `data`, batch stays on `pod` only.
CONTEXT_PARALLEL_OVERRIDES = {
    "kv_seq": "data",
    "batch": "pod",
    "decode_batch": "pod",
}


def mesh_axis_size(mesh, axis: Union[str, Tuple[str, ...], None]) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh_axis_size(mesh, a)
        return n
    return mesh.shape[axis] if axis in mesh.shape else 1


_RULE_OVERRIDES: dict = {}


@contextlib.contextmanager
def rule_overrides(overrides: dict):
    """Temporarily remap logical axes (e.g. inside the pod-sync step's
    per-pod region, "batch" resolves to data only)."""
    global _RULE_OVERRIDES
    prev = dict(_RULE_OVERRIDES)
    _RULE_OVERRIDES.update(overrides)
    try:
        yield
    finally:
        _RULE_OVERRIDES = prev


def logical_to_spec(logical: Sequence[Optional[str]], mesh,
                    dim_sizes: Optional[Sequence[int]] = None,
                    overrides: Optional[dict] = None) -> Spec:
    """Resolve logical axes to a spec (a tuple, one entry per dim) under
    ``mesh``.

    A mesh axis is only used if (a) it exists in the mesh with size > 1
    and (b) the tensor dim is divisible by the product of its axes' sizes
    (when ``dim_sizes`` is given); otherwise that dim replicates. This is
    e.g. the Megatron rule "replicate KV heads when kv_heads < TP"."""
    rules = dict(RULES)
    rules.update(_RULE_OVERRIDES)
    if overrides:
        rules.update(overrides)
    spec = []
    for i, name in enumerate(logical):
        axis = rules.get(name) if name else None
        if axis is None:
            spec.append(None)
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        axes = tuple(a for a in axes if a in mesh.shape and mesh.shape[a] > 1)
        if not axes:
            spec.append(None)
            continue
        if dim_sizes is not None:
            size = 1
            for a in axes:
                size *= mesh.shape[a]
            if dim_sizes[i] % size != 0:
                spec.append(None)      # not divisible -> replicate
                continue
        spec.append(axes if len(axes) > 1 else axes[0])
    return tuple(spec)


# ----------------------------------------------------------------------
# the mesh
# ----------------------------------------------------------------------

class Mesh:
    """A mesh of SPMD ranks over the initialised default process group:
    mesh position i (row-major over ``shape``) is global rank ``ranks[i]``
    (``range(n)`` by default). Every rank of the world must build the
    same meshes in the same order (each builds its process groups).

    ``device`` is where this rank computes and holds its tensors (the
    card unless the caller asks for the CPU); the groups are gloo's.
    ``device_mesh`` is the DeviceMesh of ``device``'s type that DTensors
    live on, ``host_mesh`` the CPU one whose groups carry the bytes
    (the same object on the CPU). A rank outside the mesh holds neither:
    ``member`` is False."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 device=None, ranks: Optional[Sequence[int]] = None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        n = 1
        for s in shape:
            n *= int(s)
        ranks = list(range(n)) if ranks is None else [int(r) for r in ranks]
        if len(ranks) != n:
            raise ValueError(f"a mesh of shape {tuple(shape)} takes {n} ranks, got {len(ranks)}")
        if dist.get_world_size() < max(ranks) + 1:
            raise ValueError(f"mesh ranks {ranks} exceed the world of {dist.get_world_size()}")
        self.ranks = torch.tensor(ranks).reshape(tuple(int(s) for s in shape))
        self._ranks = ranks
        self.device = resolve_device(device)
        self.host_mesh = DeviceMesh("cpu", self.ranks, mesh_dim_names=self.axis_names)
        coord = self.host_mesh.get_coordinate()
        self.member = coord is not None
        self.coord = dict(zip(self.axis_names, coord)) if self.member else None
        self.device_mesh = self.host_mesh
        if self.device.type != "cpu" and self.member:
            # the same gloo groups, for DTensors whose shards are on the card
            self.device_mesh = DeviceMesh.from_group(
                [self.host_mesh.get_group(a) for a in self.axis_names],
                self.device.type, mesh=self.ranks, mesh_dim_names=self.axis_names)

    def get_group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.host_mesh.get_group(axis)

    def rank_at(self, coord: dict) -> int:
        """The global rank at mesh coordinates ``coord`` (axis -> index)."""
        pos = 0
        for a in self.axis_names:
            pos = pos * self.shape[a] + coord[a]
        return self._ranks[pos]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``jax.lax.axis_index``);
        0 for an axis the mesh lacks."""
        return self.coord.get(axis, 0) if axis in self.shape else 0

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


_MESH: list = []


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` the one model code reads (``jax.set_mesh``)."""
    _MESH.append(mesh)
    try:
        yield mesh
    finally:
        _MESH.pop()


def current_mesh() -> Optional[Mesh]:
    """The innermost ``use_mesh`` mesh, or None (the abstract mesh)."""
    return _MESH[-1] if _MESH else None


def get_abstract_mesh() -> Optional[Mesh]:
    """JAX's name for the ambient mesh: ``current_mesh()``, or None for a
    mesh of no axes."""
    mesh = current_mesh()
    return mesh if mesh is not None and mesh.shape else None


# ----------------------------------------------------------------------
# specs as DTensor placements
# ----------------------------------------------------------------------

class NamedSharding(NamedTuple):
    """``NamedSharding(mesh, spec)`` with its DTensor placements."""
    mesh: Mesh
    spec: Spec
    placements: Tuple


def placements_for(spec: Spec, mesh: Mesh) -> Tuple:
    """DTensor placements of ``spec``: per mesh axis, ``Shard(dim)`` of
    the dim it splits, else ``Replicate()`` (a duck-typed mesh's axes are
    its ``shape`` keys, in order). DTensor splits a dim over
    several mesh axes in the mesh's axis order, the first axis outermost;
    a spec entry naming them in another order would split the rows in
    another order than JAX, so it raises."""
    names = tuple(getattr(mesh, "axis_names", mesh.shape))
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry} does not follow the mesh's axis "
                             f"order {names}")
        for p in pos:
            out[p] = Shard(dim)
    return tuple(out)


def named_sharding(logical: Sequence[Optional[str]], mesh: Mesh,
                   dim_sizes: Optional[Sequence[int]] = None,
                   overrides: Optional[dict] = None) -> NamedSharding:
    spec = logical_to_spec(logical, mesh, dim_sizes, overrides)
    return NamedSharding(mesh, spec, placements_for(spec, mesh))


def is_logical(x) -> bool:
    """A logical-axis leaf: a tuple of axis names and Nones."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def tree_map(fn, tree, *rest, is_leaf=None):
    """``jax.tree.map`` over dicts, tuples and lists; ``is_leaf`` stops the
    walk at a node of ``tree``."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in tree}
    if isinstance(tree, (tuple, list)):
        kids = (tree_map(fn, t, *(r[i] for r in rest), is_leaf=is_leaf)
                for i, t in enumerate(tree))
        return type(tree)(*kids) if hasattr(tree, "_fields") else type(tree)(kids)
    return fn(tree, *rest)


def tree_shardings(logical_tree, shape_tree, mesh: Mesh, overrides=None):
    """A tree of logical-axis tuples and the matching tree of tensors (real
    or on the ``meta`` device) -> a tree of ``NamedSharding``."""
    return tree_map(
        lambda lg, shp: named_sharding(lg, mesh, dim_sizes=shp.shape, overrides=overrides),
        logical_tree, shape_tree, is_leaf=is_logical)


# ----------------------------------------------------------------------
# moving shards
# ----------------------------------------------------------------------

def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, an axis or a tuple of axes)."""
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


def block_of(mesh: Mesh, entry, coord: Optional[dict] = None) -> Tuple[int, int]:
    """(n, i): a dim split by the spec entry ``entry`` is cut into n
    blocks and this rank (or the rank at ``coord``, axis -> index) holds
    block i, the axes taken first-outermost, as ``PartitionSpec``'s."""
    n, idx = 1, 0
    for a in spec_axes(entry):
        n *= mesh.shape[a]
        idx = idx * mesh.shape[a] + (mesh.index(a) if coord is None else coord[a])
    return n, idx


def local_shard(x: torch.Tensor, mesh: Mesh, spec: Spec) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` (held whole by every
    rank) under ``spec``, cut locally with no communication: what a
    ``shard_map`` body receives for a replicated input. A dim split over
    several axes takes them first-outermost, as ``PartitionSpec``."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = spec_axes(entry)
        n, idx = block_of(mesh, entry)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {axes}")
        step = x.shape[dim] // n
        x = x.narrow(dim, idx * step, step)
    return x


@contextlib.contextmanager
def _quiet_redistribute():
    """DTensor logs a warning each time it gathers over two mesh axes one
    after the other: the order is the one JAX's spec names, and wanted."""
    log = logging.getLogger("torch.distributed.tensor._redistribute")
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        yield
    finally:
        log.setLevel(level)


def full_tensor(x: DTensor) -> torch.Tensor:
    """The whole tensor of a DTensor on every rank of its mesh
    (``DTensor.full_tensor``), gathered over gloo through host memory:
    the local shard crosses in ``core/collectives.host_staged`` on a
    CPU DTensor built on the same groups."""
    from repro_torch.core.collectives import host_staged
    dm = x.device_mesh
    names = dm.mesh_dim_names

    def gather(local):
        host = dm if dm.device_type == "cpu" else DeviceMesh.from_group(
            [dm.get_group(a) for a in names], "cpu", mesh=dm.mesh, mesh_dim_names=names)
        with _quiet_redistribute():
            return DTensor.from_local(local, host, x.placements, run_check=False,
                                      shape=x.shape, stride=x.stride()).full_tensor()
    return host_staged(gather, x.to_local())


def distribute(x: torch.Tensor, sharding: NamedSharding) -> Optional[DTensor]:
    """A DTensor of the whole tensor ``x`` (held by every rank) on the
    sharding's mesh, each rank keeping its own block with no
    communication; None on a rank outside the mesh."""
    if not sharding.mesh.member:
        return None
    return distribute_tensor(x.to(sharding.mesh.device), sharding.mesh.device_mesh,
                             sharding.placements, src_data_rank=None)


def redistribute(x: DTensor, sharding: NamedSharding) -> Optional[DTensor]:
    """``x`` under another sharding (another mesh too): gathered whole
    (``full_tensor``) and cut again. Every rank of ``x``'s mesh calls it."""
    return distribute(full_tensor(x), sharding)


def constrain(x: torch.Tensor, *logical: Optional[str],
              overrides: Optional[dict] = None) -> torch.Tensor:
    """``with_sharding_constraint`` by logical axis names: the identity on
    a plain tensor or without a mesh; a DTensor is redistributed to the
    spec under ``current_mesh()``."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    sh = named_sharding(logical, mesh, dim_sizes=x.shape, overrides=overrides)
    if tuple(x.placements) == sh.placements and x.device_mesh is mesh.device_mesh:
        return x
    return redistribute(x, sh)


# ----------------------------------------------------------------------
# a tree held in blocks
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """Where one leaf of a tree lives on a mesh: its whole ``shape`` and
    its ``spec`` (JAX's ``NamedSharding`` of the leaf)."""
    shape: Tuple[int, ...]
    spec: Spec

    def axes(self) -> Tuple[str, ...]:
        """The mesh axes that split the leaf."""
        return tuple(a for entry in self.spec for a in spec_axes(entry))

    def is_block(self, x: torch.Tensor) -> bool:
        """``x`` is a block of the leaf (not the whole leaf)."""
        return tuple(x.shape) != self.shape


def _is_layout_leaf(x) -> bool:
    return x is None or isinstance(x, BlockSpec)


def tree_layout(logical_tree, shape_tree, mesh, overrides=None):
    """A tree of ``BlockSpec``: each leaf's whole shape (from ``shape_tree``:
    tensors, real or on the ``meta`` device) and its spec under ``mesh``,
    a dim that does not divide replicated (``logical_to_spec``'s rule, as
    ``tree_shardings``). A leaf that is not a tensor (an optimizer's step
    count) gets None: every rank holds it as it is."""
    def leaf(lg, t):
        if not isinstance(t, torch.Tensor):
            return None
        return BlockSpec(tuple(t.shape), logical_to_spec(lg, mesh, dim_sizes=t.shape,
                                                         overrides=overrides))
    return tree_map(leaf, logical_tree, shape_tree, is_leaf=is_logical)


def place(tree, layout, mesh):
    """The whole ``tree`` (held by every rank) as this rank's blocks under
    ``layout``: each split leaf cut (``local_shard``) into a copy of its
    own, so the whole tree can be freed; a replicated leaf is kept as it
    is. No communication."""
    def cut(b, x):
        if b is None or not isinstance(x, torch.Tensor) or not b.axes():
            return x
        if tuple(x.shape) != b.shape:
            raise ValueError(f"place: a leaf of {tuple(x.shape)}, want the whole {b.shape}")
        return local_shard(x, mesh, b.spec).clone(memory_format=torch.contiguous_format)
    return tree_map(cut, layout, tree, is_leaf=_is_layout_leaf)


def gather_leaf(x: torch.Tensor, b: BlockSpec, mesh) -> torch.Tensor:
    """One leaf whole: a block all-gathered over the axes that split it
    (innermost axis first, as ``local_shard`` cuts them outermost first);
    a whole leaf as it is. Every rank of those axes calls it."""
    from repro_torch.core.collectives import all_gather
    if not b.is_block(x):
        return x
    for dim, entry in enumerate(b.spec):
        for a in reversed(spec_axes(entry)):
            x = all_gather(x, mesh.get_group(a), dim)
    return x


def gather(tree, layout, mesh):
    """``place``'s inverse: every leaf of ``tree`` whole on every rank."""
    return tree_map(lambda b, x: x if b is None or not isinstance(x, torch.Tensor)
                    else gather_leaf(x, b, mesh), layout, tree, is_leaf=_is_layout_leaf)


# ----------------------------------------------------------------------
# runs of a flattened leaf (the int8 moments' layout)
# ----------------------------------------------------------------------

Box = Tuple[Tuple[int, int], ...]


def range_boxes(shape: Sequence[int], lo: int, hi: int) -> List[Box]:
    """The flat range [lo, hi) of a row-major array of ``shape`` as boxes
    (a (start, stop) per dim), in order: each box one contiguous stretch
    of the range, a partial leading row, whole rows, a partial last row,
    the partial rows cut the same way one dim in."""
    if lo >= hi:
        return []
    if not shape:
        return [()]
    inner = math.prod(shape[1:])
    first, last = -(-lo // inner), hi // inner          # the whole rows [first, last)
    rest = tuple(shape[1:])
    if first > last:                                    # inside row lo // inner
        r = lo // inner
        return [((r, r + 1),) + b for b in range_boxes(rest, lo - r * inner, hi - r * inner)]
    out = []
    if lo < first * inner:
        r = first - 1
        out += [((r, r + 1),) + b for b in range_boxes(rest, lo - r * inner, inner)]
    if first < last:
        out.append(((first, last),) + tuple((0, n) for n in rest))
    if last * inner < hi:
        out += [((last, last + 1),) + b for b in range_boxes(rest, 0, hi - last * inner)]
    return out


def _block_box(b: BlockSpec, mesh, coord: dict) -> Box:
    box = []
    for n, entry in zip(b.shape, b.spec):
        k, i = block_of(mesh, entry, coord)
        box.append((i * n // k, (i + 1) * n // k))
    return tuple(box)


def _meet(a: Box, b: Box) -> Optional[Box]:
    box = tuple((max(x0, y0), min(x1, y1)) for (x0, x1), (y0, y1) in zip(a, b))
    return box if all(x0 < x1 for x0, x1 in box) else None


def _cut(x: torch.Tensor, box: Box, origin: Sequence[int]) -> torch.Tensor:
    for dim, ((start, stop), o) in enumerate(zip(box, origin)):
        x = x.narrow(dim, start - o, stop - start)
    return x


class RunExchange:
    """Moves one leaf between its blocks (``b``, the params' layout) and
    its runs (the flattened leaf cut into equal contiguous runs over the
    axes of the spec entry ``entry``, the tail past the leaf's size read
    as zeros): each value crosses once, from the rank that holds it to
    the rank that needs it, in host memory (gloo point to point between
    the ranks that differ only on those axes and the block's). What an
    all-to-all does; ``gather`` would move every rank the whole leaf."""

    def __init__(self, b: BlockSpec, entry, mesh, run_size: int):
        n = math.prod(b.shape)
        axes = [a for a in mesh.axis_names
                if a in spec_axes(entry) or a in b.axes()]
        me = dict(mesh.coord)
        # a value held by several ranks comes from the one that matches
        # this rank on the axes that replicate it
        same_block = [a for a in axes if a not in b.axes()]
        same_run = [a for a in axes if a not in spec_axes(entry)]
        self.peers = []     # (global rank, block box, run boxes, it, block source, run source)
        for idx in itertools.product(*(range(mesh.shape[a]) for a in axes)):
            coord = dict(me, **dict(zip(axes, idx)))
            rank = mesh.rank_at(coord)
            _, r = block_of(mesh, entry, coord)
            lo = r * run_size
            runs = list(self._offsets(range_boxes(b.shape, lo, min(lo + run_size, n))))
            self.peers.append((rank, _block_box(b, mesh, coord), runs, coord == me,
                               all(coord[a] == me[a] for a in same_block),
                               all(coord[a] == me[a] for a in same_run)))
        self.mine = next(p for p in self.peers if p[3])
        self.run_size = run_size

    @staticmethod
    def _offsets(boxes):
        off = 0
        for box in boxes:
            yield box, off
            off += math.prod(stop - start for start, stop in box)

    @staticmethod
    def _seg(run: torch.Tensor, rbox: Box, off: int) -> torch.Tensor:
        """The stretch of ``run`` from ``off`` that holds the box ``rbox``,
        viewed as the box."""
        shape = tuple(e - s for s, e in rbox)
        return run[off:off + math.prod(shape)].view(shape)

    @staticmethod
    def _swap(sends, recvs):
        """Point to point: ``sends`` and ``recvs`` are (global rank,
        tensor) lists; the k-th tensor between two ranks carries tag k on
        both sides (each side lists a pair's pieces in the same order)."""
        ops, tags = [], {}
        for op, items in ((dist.isend, sends), (dist.irecv, recvs)):
            for rank, t in items:
                k = tags[(op, rank)] = tags.get((op, rank), -1) + 1
                ops.append(dist.P2POp(op, t, rank, tag=k))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()

    def to_run(self, block: torch.Tensor) -> torch.Tensor:
        """This rank's run (host memory, ``block``'s dtype) of the leaf
        whose block it holds."""
        from repro_torch.core.collectives import to_host
        block = to_host(block.detach())
        box_me, runs_me = self.mine[1:3]
        run = torch.zeros(self.run_size, dtype=block.dtype)
        sends, recvs, places = [], [], []
        for rank, box, runs, own, source, _ in self.peers:
            if not source:
                continue
            for rbox, _ in runs:                          # what `rank` needs of my block
                cut = _meet(rbox, box_me)
                if cut is not None and not own:
                    sends.append((rank, _cut(block, cut, [s for s, _ in box_me]).contiguous()))
            for rbox, off in runs_me:                     # what I need of `rank`'s block
                cut = _meet(rbox, box)
                if cut is None:
                    continue
                dst = _cut(self._seg(run, rbox, off), cut, [s for s, _ in rbox])
                if own:
                    dst.copy_(_cut(block, cut, [s for s, _ in box_me]))
                else:
                    buf = torch.empty(dst.shape, dtype=block.dtype)
                    recvs.append((rank, buf))
                    places.append((dst, buf))
        self._swap(sends, recvs)
        for dst, buf in places:
            dst.copy_(buf)
        return run

    def to_block(self, run: torch.Tensor, block: torch.Tensor) -> None:
        """Writes this rank's block (``block``, in place, on its device)
        from the ranks' runs (``run``: this rank's, as ``to_run`` made it)."""
        from repro_torch.core.collectives import host_back, to_host
        run = to_host(run.detach())
        box_me, runs_me = self.mine[1:3]
        out = torch.empty(block.shape, dtype=block.dtype)
        sends, recvs, places = [], [], []
        for rank, box, runs, own, _, source in self.peers:
            if not source:
                continue
            for rbox, off in runs_me:                     # what `rank`'s block needs of my run
                cut = _meet(rbox, box)
                if cut is None or own:
                    continue
                sends.append((rank, _cut(self._seg(run, rbox, off), cut,
                                         [s for s, _ in rbox]).contiguous()))
            for rbox, off in runs:                        # what I need of `rank`'s run
                cut = _meet(rbox, box_me)
                if cut is None:
                    continue
                dst = _cut(out, cut, [s for s, _ in box_me])
                if own:
                    dst.copy_(_cut(self._seg(run, rbox, off), cut, [s for s, _ in rbox]))
                else:
                    buf = torch.empty(dst.shape, dtype=block.dtype)
                    recvs.append((rank, buf))
                    places.append((dst, buf))
        self._swap(sends, recvs)
        for dst, buf in places:
            dst.copy_(buf)
        block.copy_(host_back(out, block.device))
