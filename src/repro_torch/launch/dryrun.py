"""The multi-pod dry-run, the counterpart of ``repro/launch/dryrun.py``:
one (arch x shape x mesh) cell's per-chip FLOPs, HBM bytes, collective
traffic and memory, and the roofline report built from them, with
nothing allocated and nothing computed on any device.

JAX lowers and compiles the step for 512 forced host devices and reads
XLA's ``cost_analysis``, ``memory_analysis`` and HLO text. The port has
no compiler to ask; it traces rank 0's step instead:

- **World.** A ``"fake"`` process group (``torch.testing._internal.
  distributed.fake_pg``) makes this process rank 0 of 256 (16x16) or
  512 (2x16x16) ranks, and ``launch/mesh.py::make_production_mesh``
  builds on it with ``device="cpu"`` (no card needed). Collectives on it
  return at once. Run the dry-run in a process of its own, as the CLI
  is: the default group it leaves behind would be the next caller's.
- **Stand-ins.** Rank 0's local shards of params, optimizer state,
  batch and cache, shaped by the port's specs (``launch/inputs.py``,
  ``parallel/sharding.py``), are ``FakeTensor``s: shapes and dtypes, no
  storage. The step functions are the port's own (``make_train_step``,
  ``models/model.py::prefill`` and ``decode_step``, with ``cp_axis`` as
  JAX's dry-run picks it). The train step takes the param and optimizer
  shards themselves, the blocks the SPMD launcher holds
  (``launch/train.py::place_state``): it gathers each weight over
  ``data`` where it uses it and computes tensor-parallel over ``model``,
  and its optimizer steps the blocks, so rank 0's counts are those of
  the launcher's step. It gets the global batch, as the launcher's ranks
  do, and cuts its share. The serve steps run on one device in the
  launchers and take whole weights here: each weight is gathered from
  its shard by ``core/collectives.all_gather`` over the axes that shard
  it; prefill and decode take rank 0's rows, decode its cache rows on
  ``cp_axis``.
- **Kernels.** Fake tensors are CPU tensors, so every kernel wrapper
  takes its plain version (``kernels.use_kernel``), and JAX's dry-run
  never reaches Pallas either: attention ``ref`` below 2048 tokens and
  ``blocked`` from 2048, ``ssd_chunked``, the plain int8 quantizer. No
  wrapper is patched. The kernels' own times are ``chip_smoke.py``'s
  kernels phase.
- **FLOPs** per chip: ``torch.utils.flop_counter.FlopCounterMode`` over
  the trace, backward and recompute included.
- **HBM bytes** per chip: each op's input and output bytes, once (views
  count nothing, an in-place op's output is its input): the eager
  port's traffic, with no fusion. This is not XLA's fused ``bytes
  accessed``, which the JAX dry-run reports.
- **Collectives.** Each ``c10d`` op of the trace with its group's global
  ranks, attributed to mesh axes by ``core/charz.attribute_axes`` and
  sized by ``core/paths.collective_bytes_per_chip``: the logical
  collective. ``core/collectives.host_staged``'s pinned copies exist only
  for CUDA tensors and never run here. A collective over a group of one
  moves nothing and is not counted (XLA drops it). ``charz.replay`` runs
  the traffic on ``paths.enumerate_paths``.
- **Memory.** ``argument_bytes``: the exact bytes of rank 0's params,
  optimizer state, batch (or tokens and cache) and step, as JAX's
  ``argument_size_in_bytes``; ``temp_bytes``: the peak bytes of the live
  tensors the trace makes (each storage counted when made, dropped when
  freed); ``output_bytes``: what the step returns, in rank 0's layout;
  ``alias_bytes``: the part of it that goes into donated arguments
  (params and optimizer state in training, the cache in decode).

``report_from`` assembles ``core/roofline.py``'s ``RooflineReport`` from
these counts with ``build_report``'s formulas. Each cell's result is
saved under ``runs/dryrun_torch/``.

    python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape decode_32k
    python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import weakref
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import SHAPES, RunConfig, get_config, list_archs
from repro_torch.configs.base import ModelConfig, ShapeConfig, shape_applicable
from repro_torch.core import hw
from repro_torch.core.charz import CollectiveOp, TrafficSummary, attribute_axes, replay
from repro_torch.core.collectives import all_gather
from repro_torch.core.compression import Quantized
from repro_torch.core.paths import collective_bytes_per_chip, enumerate_paths
from repro_torch.core.roofline import RooflineReport, model_flops_for
from repro_torch.launch.inputs import batch_specs, decode_specs, param_shardings
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models import precision
from repro_torch.models.attention import train_impl
from repro_torch.models.params import layer_period, num_groups
from repro_torch.optim.adamw import _QBLOCK, AdamWState
from repro_torch.parallel.sharding import (CONTEXT_PARALLEL_OVERRIDES, Mesh, is_logical,
                                           logical_to_spec, tree_map, use_mesh)
from repro_torch.train.train_step import make_train_step

RUNS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "runs", "dryrun_torch")


# ----------------------------------------------------------------------
# the world
# ----------------------------------------------------------------------

def fake_world(size: int) -> None:
    """Make this process rank 0 of a ``"fake"`` process group of ``size``
    ranks (a fake group of another size is replaced). Raises if a real
    group is initialised: the dry-run wants a process of its own."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialised; run the dry-run "
                               "in a process of its own")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


# ----------------------------------------------------------------------
# the trace: FLOPs are FlopCounterMode's; bytes, memory and collectives
# are counted here
# ----------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: c10d op -> charz's collective kind: the ops ``core/collectives.py``
#: issues (all_reduce, all_gather_into_tensor, reduce_scatter_tensor,
#: batch_isend_irecv)
_C10D_KINDS = {"allreduce_": "all-reduce", "_allgather_base_": "all-gather",
               "_reduce_scatter_base_": "reduce-scatter", "send": "collective-permute"}
#: c10d ops that move nothing of their own: a recv is its peer's send
_C10D_SILENT = ("recv_", "barrier")
_NO_TRAFFIC = ("empty", "empty_strided", "empty_like")


def _payload(name: str, args) -> Tuple[int, int]:
    """(payload bytes as ``paths.collective_bytes_per_chip`` takes them,
    result bytes as ``charz`` reads them) of a c10d op's arguments."""
    if name in ("allreduce_", "send"):
        n = sum(_nbytes(t) for t in args[0])
        return n, n
    if name == "_allgather_base_":
        return _nbytes(args[0]), _nbytes(args[0])
    return _nbytes(args[1]), _nbytes(args[0])          # _reduce_scatter_base_


class Trace(TorchDispatchMode):
    """Counts, over the ops it sees: HBM bytes (``hbm_bytes``), the live
    bytes of the storages made inside it and their peak (``peak``;
    storages ``hold`` registers are not counted), the ops (``ops``) and
    the collectives (``collectives``, charz ``CollectiveOp``s)."""

    def __init__(self, mesh_axes: Sequence[Tuple[str, int]]):
        super().__init__()
        self.mesh_axes = list(mesh_axes)
        self.known: Dict[int, int] = {}
        self.live = self.peak = self.hbm_bytes = self.ops = 0
        self.collectives: List[CollectiveOp] = []
        self._ranks: Dict[int, List[int]] = {}

    def hold(self, tensors) -> None:
        """Storages that exist before the trace (the arguments)."""
        for t in tensors:
            self._track(t, 0)

    def _track(self, t: torch.Tensor, count: int = 1) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.known:
            return
        n = st.nbytes() * count
        self.known[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self.known.pop(key, 0)

    def _group_ranks(self, args) -> List[int]:
        pg_type = torch._C._distributed_c10d.ProcessGroup
        for a in args:
            if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(a._type()):
                pg = pg_type.unbox(a)
                if id(pg) not in self._ranks:
                    self._ranks[id(pg)] = dist.get_process_group_ranks(pg)
                return self._ranks[id(pg)]
        raise RuntimeError("a c10d op without a process group")

    def _collective(self, name: str, args) -> None:
        if name in _C10D_SILENT:
            return
        if name not in _C10D_KINDS:
            raise NotImplementedError(f"the dry-run does not count c10d.{name}")
        ranks = self._group_ranks(args)
        if len(ranks) <= 1:
            return
        kind = _C10D_KINDS[name]
        payload, result = _payload(name, args)
        n = 2 if kind == "collective-permute" else len(ranks)
        self.collectives.append(CollectiveOp(
            op=kind, result_bytes=result, group_size=n,
            axes=attribute_axes(ranks, self.mesh_axes),
            traffic_per_chip=collective_bytes_per_chip(kind, payload, n),
            line=f"c10d.{name} over global ranks {ranks[:4]}..."))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        c10d = func.namespace == "c10d"
        if c10d:
            self._collective(func._opname, args)
        ins = {id(t): t for t in _tensors(args)}
        ins.update((id(t), t) for t in _tensors(kwargs.values()))
        out = func(*args, **kwargs)
        outs = list(_tensors((out,)))
        if not (c10d or func.is_view or func._opname in _NO_TRAFFIC):
            self.hbm_bytes += sum(_nbytes(t) for t in ins.values()) + \
                sum(_nbytes(t) for t in outs if id(t) not in ins)
        for t in outs:
            self._track(t)
        return out


def _tensors(xs):
    """The tensors among ``xs`` and in its lists and tuples."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


# ----------------------------------------------------------------------
# the report
# ----------------------------------------------------------------------

def summarize_ops(ops: Sequence[CollectiveOp], mesh_axes,
                  fabric=None) -> TrafficSummary:
    """``charz.summarize_traffic``'s attribution of each collective to its
    (slowest) path, on recorded ops instead of HLO text."""
    if fabric is None:
        fabric = enumerate_paths(dict(mesh_axes))
    by_axis = {p.axis: p.name for p in fabric.values() if p.axis}
    per_path: Dict[str, float] = defaultdict(float)
    per_op: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    for op in ops:
        if "pod" in op.axes:
            path = by_axis.get("pod", "dcn:pod")
        elif op.axes:
            axis = op.axes[-1]
            path = by_axis.get(axis, f"ici:{axis}")
        else:
            path = "ici:?"
        per_path[path] += op.traffic_per_chip
        per_op[op.op] += op.traffic_per_chip
        counts[op.op] += 1
    return TrafficSummary(per_path=dict(per_path), per_op=dict(per_op),
                          op_counts=dict(counts), ops=list(ops))


def report_from(*, arch: str, shape: str, mesh_name: str, mesh_axes, flops: float,
                hbm_bytes: float, traffic: TrafficSummary, model_flops: float,
                chips: int, memory_bytes_per_chip: Optional[float] = None,
                note: str = "") -> RooflineReport:
    """``roofline.build_report`` on counted FLOPs and bytes and a
    ``TrafficSummary``, where JAX's takes XLA's cost analysis and HLO
    text: the same formulas."""
    flops, hbm_bytes = float(flops), float(hbm_bytes)
    paths = enumerate_paths(dict(mesh_axes))
    compute_s = flops / hw.PEAK_FLOPS_BF16
    memory_s = hbm_bytes / hw.HBM_BW
    coll_per_path_s: Dict[str, float] = {}
    for pname, nbytes in traffic.per_path.items():
        bw = paths[pname].bw if pname in paths else hw.ICI_BW_PER_LINK
        coll_per_path_s[pname] = nbytes / bw
    collective_s = sum(coll_per_path_s.values())
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    step = max(terms.values())
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name,
        flops_per_chip=flops, hbm_bytes_per_chip=hbm_bytes,
        collective_bytes_per_path=dict(traffic.per_path),
        compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, collective_s_per_path=coll_per_path_s,
        dominant=dominant, model_flops=model_flops,
        useful_flops_ratio=model_flops / max(flops * chips, 1.0),
        step_time_s=step, roofline_frac=compute_s / step if step > 0 else 0.0,
        memory_bytes_per_chip=memory_bytes_per_chip, note=note)


# ----------------------------------------------------------------------
# stand-ins
# ----------------------------------------------------------------------

def _axes(entry) -> Tuple[str, ...]:
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


class _Leaf:
    """One argument: rank 0's shard (a fake tensor) and its spec."""

    def __init__(self, shape, dtype, logical, mesh: Mesh, overrides=None):
        self.spec = logical_to_spec(logical, mesh, dim_sizes=shape, overrides=overrides)
        local = list(shape)
        for dim, entry in enumerate(self.spec):
            for a in _axes(entry):
                local[dim] //= mesh.shape[a]
        self.tensor = torch.empty(local, dtype=dtype)
        self.shape = tuple(shape)

    def whole(self, mesh: Mesh, keep: Sequence[int] = ()) -> torch.Tensor:
        """The tensor gathered over every axis that shards it, but for
        the dims in ``keep`` (innermost axis first, as ``local_shard``
        cuts them outermost first)."""
        x = self.tensor
        for dim, entry in enumerate(self.spec):
            if dim in keep:
                continue
            for a in reversed(_axes(entry)):
                x = all_gather(x, mesh.get_group(a), dim)
        return x


def _leaves(logical_tree, meta_tree, mesh: Mesh, overrides=None):
    """A tree of ``_Leaf`` (logical axes against meta tensors)."""
    return tree_map(lambda lg, t: _Leaf(t.shape, t.dtype, lg, mesh, overrides),
                    logical_tree, meta_tree, is_leaf=is_logical)


def _moment_leaves(logical_tree, meta_tree, mesh: Mesh, int8: bool):
    """One AdamW moment tree: f32 leaves as the params shard, or the
    ``Quantized`` int8 blocks and scales sharded flat over (data, model)
    (JAX's ``_opt_logical``)."""
    def leaf(lg, t):
        if not int8:
            return _Leaf(t.shape, torch.float32, lg, mesh)
        nblk = -(-t.numel() // _QBLOCK)
        return Quantized(q=_Leaf((nblk, _QBLOCK), torch.int8, ("flat_shard", None), mesh),
                         scale=_Leaf((nblk,), torch.float32, ("flat_shard",), mesh))
    return tree_map(leaf, logical_tree, meta_tree, is_leaf=is_logical)


def _flat(tree) -> List[_Leaf]:
    if isinstance(tree, _Leaf):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _flat(v)]
    return []


def _map(fn, tree):
    """``fn`` of each ``_Leaf`` of a tree of dicts, tuples and ``Quantized``."""
    if isinstance(tree, _Leaf):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, Quantized):
        return Quantized(*(_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _local_bytes(leaves: Sequence[_Leaf]) -> int:
    return sum(_nbytes(x.tensor) for x in leaves)


SCALAR_BYTES = 4                 # an int32 step or position, as JAX passes it


# ----------------------------------------------------------------------
# one cell
# ----------------------------------------------------------------------

def _mesh_for(multi_pod: bool, mesh_shape) -> Tuple[Mesh, str]:
    if mesh_shape is None:
        fake_world(512 if multi_pod else 256)
        return make_production_mesh(multi_pod=multi_pod, device="cpu"), \
            "2x16x16" if multi_pod else "16x16"
    names, sizes = zip(*mesh_shape)
    n = 1
    for s in sizes:
        n *= s
    fake_world(n)
    return Mesh(sizes, names, device="cpu"), "x".join(str(s) for s in sizes)


def _decode_overrides(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh):
    """(cp_axis, sharding overrides) of a decode cell: JAX's
    ``dryrun.py:115-121`` and ``launch/inputs.py::decode_shardings``."""
    if shape.name == "long_500k":
        return "data", dict(CONTEXT_PARALLEL_OVERRIDES)
    if cfg.num_kv_heads and cfg.num_kv_heads % mesh.shape.get("model", 1):
        return "model", {"kv_seq": "model"}
    return None, {}


def _stand_ins(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, run: RunConfig,
               opt_list: Sequence[str] = ()):
    """Rank 0's arguments of the cell's step as ``_Leaf`` trees (call it in
    a ``FakeTensorMode``), and their sizes: ``argument_bytes``,
    ``alias_bytes`` and ``returned_bytes``
    (what the step returns in rank 0's layout, but for the tensors the
    trace makes: metrics and logits)."""
    params_meta, logical, _ = param_shardings(cfg, mesh)
    args, scalars = {"params": _leaves(logical, params_meta, mesh)}, 0
    returned, donated, extra, cp_axis = [], [], SCALAR_BYTES, None

    def batch(specs, names=None, overrides=None):
        return {k: _Leaf(v.shape, v.dtype, ("batch",) + (None,) * (v.dim() - 1), mesh,
                         overrides) for k, v in specs.items() if names is None or k in names}
    if shape.kind == "train":
        int8 = run.moments_int8
        args["opt_state"] = AdamWState(
            step=0, m=_moment_leaves(logical, params_meta, mesh, int8),
            v=_moment_leaves(logical, params_meta, mesh, int8))
        args["batch"] = batch(batch_specs(cfg, shape))
        scalars = 2 * SCALAR_BYTES               # the optimizer's step and the step
        returned = _flat(args["params"]) + _flat(args["opt_state"])
        donated = [] if "nodonate" in opt_list else returned
    elif shape.kind == "prefill":
        args["batch"] = batch(batch_specs(cfg, shape), ("tokens", "frontend_embeds"))
        # the cache it returns, in decode_32k's layout (JAX's out_shardings)
        _, overrides = _decode_overrides(cfg, shape, mesh)
        returned = _flat(_leaves(M.init_cache_logical(cfg),
                                 M.abstract_cache(cfg, shape.global_batch, shape.seq_len)[0],
                                 mesh, overrides or None))
    else:
        cp_axis, overrides = _decode_overrides(cfg, shape, mesh)
        tok_specs, cache_meta, _ = decode_specs(cfg, shape)
        args["batch"] = batch(tok_specs, overrides=overrides or None)
        args["cache"] = _leaves(M.init_cache_logical(cfg), cache_meta, mesh, overrides or None)
        args["pos"] = _Leaf((), torch.int32, (), mesh)
        returned = donated = _flat(args["cache"])
        extra = 0
    held = _flat(args)
    sizes = {"argument_bytes": _local_bytes(held) + scalars,
             "alias_bytes": _local_bytes(donated),
             "returned_bytes": _local_bytes(returned) + extra}
    return args, sizes, cp_axis


def _sizes(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, run: RunConfig,
           opt_list: Sequence[str] = ()) -> dict:
    """``_stand_ins``'s sizes alone, with nothing traced."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return _stand_ins(cfg, shape, mesh, run, opt_list)[1]


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, run: RunConfig, *,
               opt_list: Sequence[str] = ()) -> dict:
    """Trace rank 0's step of one cell on fake tensors, every layer of it.
    Returns the counts: ``flops``, ``hbm_bytes``, ``collectives``, ``ops``,
    ``temp_bytes``, ``made_output_bytes`` (the metrics or logits the step
    returns) and ``_stand_ins``'s sizes (module docstring)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    stack = contextlib.ExitStack()
    if "bf16" in opt_list:
        stack.enter_context(precision.bf16_collectives())
    with FakeTensorMode(), stack:
        args, sizes, cp_axis = _stand_ins(cfg, shape, mesh, run, opt_list)
        trace = Trace([(n, int(s)) for n, s in mesh.shape.items()])
        train = shape.kind == "train"
        if train:                   # the global batch, as every rank is given it
            batch = {k: torch.zeros(x.shape, dtype=x.tensor.dtype)
                     for k, x in args["batch"].items()}
            trace.hold(batch.values())
        trace.hold(x.tensor for x in _flat(args) if not (train and x in _flat(args["batch"])))
        flop_counter = FlopCounterMode(display=False)
        with use_mesh(mesh), flop_counter, trace:
            if train:
                local = lambda x: x.tensor  # noqa: E731
                step_fn = make_train_step(
                    cfg, run, impl="auto", mesh=mesh,
                    capacity_factor=1.0 if "cf1" in opt_list else 1.25,
                    loss_chunk=2048 if "losschunk2048" in opt_list else 512)
                made = step_fn(_map(local, args["params"]),
                               AdamWState(step=0, m=_map(local, args["opt_state"].m),
                                          v=_map(local, args["opt_state"].v)), batch, 0)[2]
                del batch
            elif shape.kind == "prefill":
                whole = _map(lambda x: x.whole(mesh), args["params"])
                b = {k: x.tensor for k, x in args["batch"].items()}
                made = M.prefill(cfg, whole, b["tokens"], shape.seq_len,
                                 frontend_embeds=b.get("frontend_embeds"),
                                 impl=train_impl(shape.seq_len))[0]
            else:
                whole = _map(lambda x: x.whole(mesh), args["params"])
                # rank 0's batch rows of the cache, and its sequence rows
                # on cp_axis; the port's step takes every head
                cache = tuple({name: x.whole(mesh, keep=(1, 2) if cp_axis and name in "kv"
                                             else (1,)) for name, x in slot.items()}
                              for slot in args["cache"])
                made = M.decode_step(cfg, whole, args["batch"]["tokens"].tensor, cache,
                                     args["pos"].tensor, cp_axis=cp_axis, mesh=mesh,
                                     impl="auto")[0]
            made_bytes = sum(_nbytes(t) for t in pytree.tree_leaves(made)
                             if isinstance(t, torch.Tensor))
            del made
    return dict(sizes, flops=flop_counter.get_total_flops(), hbm_bytes=trace.hbm_bytes,
                collectives=trace.collectives, ops=trace.ops, temp_bytes=trace.peak,
                made_output_bytes=made_bytes)


#: counts fitted over the depth by a quadratic: FLOPs and collectives are
#: linear in it, and the HBM bytes and op counts quadratic (each layer's
#: gradient is added into its stacked leaf, whose size is the depth's)
FITTED = ("flops", "hbm_bytes", "ops", "made_output_bytes")
FIT_GROUPS = (2, 3, 4)


def _fit(xs: Sequence, g: int):
    """The quadratic through (2, xs[0]), (3, xs[1]), (4, xs[2]) at g:
    integers stay integers (each Lagrange weight's product of consecutive
    integers is even)."""
    a, b, c = xs
    twice = a * (g - 3) * (g - 4) - 2 * b * (g - 2) * (g - 4) + c * (g - 2) * (g - 3)
    return twice // 2 if isinstance(twice, int) else twice / 2


def trace_depth(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, run: RunConfig, *,
                opt_list: Sequence[str] = (), extrapolate: bool = True) -> dict:
    """``trace_cell``'s counts at ``cfg``'s depth, with ``traffic`` (a
    ``TrafficSummary``), ``output_bytes`` and ``groups_traced``.

    Every period group of layers runs the same ops on the same shapes, so
    with ``extrapolate`` and G > 4 groups the cell is traced at 2, 3 and
    4 groups. Each count in ``FITTED``, and each path's, kind's and
    count's collective figure, is the quadratic through the three at G:
    the whole trace's. The peak of the live bytes is not a polynomial of
    G (it moves within the step as the saved activations grow); it is
    taken on the line through 3 and 4 groups, an estimate (at full-width
    internlm2-1.8b, 8 x 4096 tokens in training, the slope grows from
    1.12 GB a group to 1.38 from 4 groups on, and the line reads 5.4%
    under the whole trace's). The sizes of the arguments are the whole
    depth's. ``tests/test_torch_dryrun.py`` holds the fit to the whole
    trace."""
    mesh_axes = [(n, int(s)) for n, s in mesh.shape.items()]
    g = num_groups(cfg)
    if not extrapolate or g <= FIT_GROUPS[-1]:
        counts = trace_cell(cfg, shape, mesh, run, opt_list=opt_list)
        counts["traffic"] = summarize_ops(counts["collectives"], mesh_axes)
        counts["groups_traced"] = [g]
    else:
        period = layer_period(cfg)
        traced = [trace_cell(dataclasses.replace(cfg, num_layers=period * k), shape, mesh,
                             run, opt_list=opt_list) for k in FIT_GROUPS]
        sums = [summarize_ops(c["collectives"], mesh_axes) for c in traced]

        def fit(dicts) -> dict:
            keys = sorted({k for d in dicts for k in d})
            return {k: _fit([d.get(k, 0) for d in dicts], g) for k in keys}
        counts = fit([{k: c[k] for k in FITTED} for c in traced])
        t3, t4 = traced[1]["temp_bytes"], traced[2]["temp_bytes"]
        counts["temp_bytes"] = t4 + (g - FIT_GROUPS[-1]) * (t4 - t3)
        counts["traffic"] = TrafficSummary(
            per_path=fit([t.per_path for t in sums]), per_op=fit([t.per_op for t in sums]),
            op_counts=fit([t.op_counts for t in sums]), ops=sums[-1].ops)
        counts.update(_sizes(cfg, shape, mesh, run, opt_list))
        counts["groups_traced"] = list(FIT_GROUPS)
    counts["output_bytes"] = counts["returned_bytes"] + counts["made_output_bytes"]
    return counts


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               run: Optional[RunConfig] = None, verbose: bool = True,
               save: bool = True, tag: str = "", opts: str = "",
               cfg: Optional[ModelConfig] = None, shape: Optional[ShapeConfig] = None,
               mesh_shape: Optional[Sequence[Tuple[str, int]]] = None,
               extrapolate: bool = True) -> dict:
    """JAX's ``lower_cell``: the cell's result dict (JAX's keys, and
    ``memory["peak_bytes"]``, ``collective_axes``, ``ops``, ``groups_traced``), printed and saved as
    JAX's; ``compile_s`` is the trace's seconds. ``cfg``, ``shape`` and
    ``mesh_shape`` ((name, size) pairs) stand in for ``get_config(arch)``,
    ``SHAPES[shape_name]`` and the production mesh; ``extrapolate=False``
    traces every layer (``trace_depth``)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": reason}

    t0 = time.monotonic()
    mesh, mesh_name = _mesh_for(multi_pod, mesh_shape)
    chips = int(mesh.ranks.numel())
    big = cfg.param_count() > 100e9
    opt_list = opts.split(",") if opts else []
    remat = "none" if "remat_none" in opt_list else (
        "full" if "remat_full" in opt_list else "minimal")
    run = run or RunConfig(
        remat_policy=remat, moments_int8=big,
        microbatch=4 if "microbatch" in opt_list else 0,
        pod_sync="compressed" if "podint8" in opt_list else "auto")
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    mf = model_flops_for(cfg.active_param_count(), tokens,
                         "train" if shape.kind == "train" else "serve")
    t_lower = time.monotonic() - t0
    counts = trace_depth(cfg, shape, mesh, run, opt_list=opt_list, extrapolate=extrapolate)
    t_trace = time.monotonic() - t0 - t_lower

    mesh_axes = [(n, int(s)) for n, s in mesh.shape.items()]
    traffic = counts["traffic"]
    report = report_from(
        arch=arch, shape=shape_name, mesh_name=mesh_name, mesh_axes=mesh_axes,
        flops=counts["flops"], hbm_bytes=counts["hbm_bytes"], traffic=traffic,
        model_flops=mf, chips=chips,
        memory_bytes_per_chip=counts["argument_bytes"] + counts["temp_bytes"])
    replay_collective_s = replay(traffic, enumerate_paths(dict(mesh.shape)))
    memory = {k: counts[k] for k in ("argument_bytes", "output_bytes", "temp_bytes",
                                     "alias_bytes")}
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "chips": chips,
        "kind": shape.kind,
        "params_b": cfg.param_count() / 1e9,
        "active_params_b": cfg.active_param_count() / 1e9,
        "flops_per_chip": report.flops_per_chip,
        "hbm_bytes_per_chip": report.hbm_bytes_per_chip,
        "collective_bytes_per_path": report.collective_bytes_per_path,
        "collective_op_counts": traffic.op_counts,
        "compute_s": report.compute_s,
        "memory_s": report.memory_s,
        "collective_s": report.collective_s,
        "collective_s_per_path": report.collective_s_per_path,
        "replay_collective_s": replay_collective_s,
        "dominant": report.dominant,
        "model_flops": mf,
        "useful_flops_ratio": report.useful_flops_ratio,
        "roofline_frac": report.roofline_frac,
        "step_time_s": report.step_time_s,
        "memory": dict(memory, peak_bytes=report.memory_bytes_per_chip),
        "collective_axes": sorted({"+".join(op.axes) for op in traffic.ops}),
        "ops": counts["ops"], "groups_traced": counts["groups_traced"],
        "lower_s": t_lower, "compile_s": t_trace,
        "opts": opts,
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
              f"trace={t_trace:.1f}s dominant={report.dominant} "
              f"compute={report.compute_s*1e3:.1f}ms "
              f"memory={report.memory_s*1e3:.1f}ms "
              f"collective={report.collective_s*1e3:.1f}ms "
              f"replay={replay_collective_s*1e3:.1f}ms "
              f"useful={report.useful_flops_ratio:.2f} "
              f"frac={report.roofline_frac:.2f}")
        print(f"  memory_analysis: args={memory['argument_bytes']/2**30:.2f}GiB "
              f"temp={memory['temp_bytes']/2**30:.2f}GiB "
              f"out={memory['output_bytes']/2**30:.2f}GiB "
              f"alias={memory['alias_bytes']/2**30:.2f}GiB")
        print(f"  collectives: {traffic.op_counts} per-path-bytes="
              f"{ {k: f'{v/2**20:.1f}MiB' for k, v in traffic.per_path.items()} }")
    if save:
        os.makedirs(RUNS_DIR, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        fname = os.path.join(RUNS_DIR, f"{arch}_{shape_name}_{mesh_name}{suffix}.json")
        with open(fname, "w") as f:
            json.dump(result, f, indent=1)
    return result


def main():
    ap = argparse.ArgumentParser(description="multi-pod dry-run (fake process group)")
    ap.add_argument("--arch", default=None, choices=list_archs())
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="every (arch x shape) cell")
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--opts", default="", help="comma list: bf16")
    args = ap.parse_args()

    cells = []
    if args.all:
        for arch in list_archs():
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all required"
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]
    failures = []
    for arch, shape in cells:
        for mp in meshes:
            if args.skip_existing:
                mesh_name = "2x16x16" if mp else "16x16"
                suffix = f"_{args.tag}" if args.tag else ""
                fname = os.path.join(RUNS_DIR, f"{arch}_{shape}_{mesh_name}{suffix}.json")
                if os.path.exists(fname):
                    print(f"[dryrun] skip existing {arch} x {shape} x {mesh_name}")
                    continue
            try:
                r = lower_cell(arch, shape, multi_pod=mp, tag=args.tag, opts=args.opts)
                if "skipped" in r:
                    print(f"[dryrun] SKIP {arch} x {shape}: {r['skipped']}")
            except Exception as e:  # noqa: BLE001 — report every failing cell
                failures.append((arch, shape, mp, repr(e)))
                print(f"[dryrun] FAIL {arch} x {shape} multi_pod={mp}: {e!r}")
    if failures:
        raise SystemExit(f"{len(failures)} dry-run cells failed: "
                         + "; ".join(f"{a}/{s}/mp={m}" for a, s, m, _ in failures))
    print("[dryrun] all requested cells traced OK")


if __name__ == "__main__":
    main()
