"""Simulated training cluster on the event-driven FabricRuntime: the
port of ``repro/train/cluster.py``, driving the torch train step.

``TrainCluster`` runs N trainer nodes as runtime ``Process``es. Each
global step is, per node:

  compute phase       a simulated delay (roofline estimate, scaled by
                      the node's inherent speed and its mitigation-
                      adjusted work share);
  gradient allreduce  concurrent Transfers on the node's host<->client
                      path (device->host OUT, host->device IN) plus a
                      ring exchange on the shared ``net`` path, closed
                      by a ``runtime.barrier()`` — the data-parallel
                      synchronization point. With
                      ``ClusterTimeModel.buckets = K > 1`` the gradient
                      is split into K per-layer-group buckets
                      (``bucket_plan``) and each bucket's allreduce is
                      issued *as soon as its slice of backward
                      completes* — classic bucketed-DDP overlap: late
                      buckets compute while early buckets communicate,
                      each bucket closed by its own cyclic barrier, and
                      the overlap win (or its absence on an idle-fast
                      network) emerges from the ledger's scheduling,
                      never from a constant;
  checkpoint staging  on checkpoint steps, the node's checkpoint shard
                      is staged over its SoC *or* host path *in the
                      same ledger* as the gradient traffic, so
                      checkpoint-vs-gradient contention and the §6.1
                      host-load crossover (offload wins when the host
                      direction is busy, loses when it is idle) emerge
                      from scheduling instead of constants.

The numeric side is optional and exact: when ``step_fn``/``params`` are
given, the barrier release runs one *real* torch update per global step
(data parallelism replicates state, so one numeric stream is the truth
for every node; the step index goes in as a Python ``int``) and
``CheckpointManager`` persists real bytes — which is what makes the
post-failure loss curve bit-identical to an uninterrupted run. Without a
``step_fn`` the cluster is a timing-only dry run (``launch/train.py
--simulate``). Only that numeric stream touches torch: the simulated
timeline is host arithmetic, statement for statement the JAX module's,
so its events, clock and ledger equal the JAX package's under the same
constants.

Every default bandwidth, latency and peak is read from ``core/hw.py``
(the H100 figures) when it is used, not when this module is imported.

Fault tolerance is event-driven end to end: every node heartbeats via a
periodic runtime process into a ``FaultToleranceManager`` attached to
the same runtime; a silent node's watchdog fires a failure Signal in
simulated time; the cluster then kills the survivor processes
(cancelling their in-flight transfers — the ledger conserves), picks a
survivor mesh with ``ft.elastic.best_mesh_for``, restores the newest
committed checkpoint, and resumes the step loop with the smaller
membership — fail -> detect -> resize -> resume, all on the SimClock.

Tenancy: the cluster can run as the *throughput tenant* of a
shared runtime — every transfer carries ``tenant=`` for the QoS
weighted fair-share, ``begin``/``done``/``finish`` let a harness
(tenancy/colocation.py) drive the clock, and
``pause_transfers``/``resume_transfers`` implement admission-control
deferral: in-flight allreduce/checkpoint transfers are canceled (their
reservations return to the ledger), node processes park on a resume
signal, and the canceled remainders are re-issued — deferral, never
loss. ``ckpt_path="auto"`` additionally picks each save's staging path
from live ledger occupancy (CheckpointManager.choose_staging) instead
of a startup constant.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core import hw
from repro_torch.core.fabric import Fabric, FabricError, OUT, IN, Path
from repro_torch.core.runtime import Barrier, FabricRuntime, Process, Transfer
from repro_torch.ckpt.checkpoint import CheckpointManager, StagingOption
from repro_torch.ft.elastic import best_mesh_for
from repro_torch.ft.manager import FaultToleranceManager
from repro_torch.ft.straggler import StragglerDetector
from repro_torch.obs.trace import PHASE, Span, Tracer
from repro_torch.offload.compression import CKPT_RATIO
from repro_torch.offload.device import node_compute_paths
from repro_torch.offload.program import OffloadStats

SOC, HOST = "soc", "host"
AUTO = "auto"     # ckpt staging: pick per save from live ledger occupancy
#: compress-then-stage modes (offload tier): run the codec where the
#: cycles live — the NIC's DCA engine or the host socket — then stage
#: only the compressed bytes over that side's wire
SOC_COMPRESS, HOST_COMPRESS = "soc-compress", "host-compress"
_COMPRESS_MODES = (SOC_COMPRESS, HOST_COMPRESS)
_CKPT_MODES = (SOC, HOST, AUTO) + _COMPRESS_MODES


def train_fabric(nodes: int, *, host_bw: Optional[float] = None,
                 soc_frac: float = 0.7,
                 net_bw_per_node: Optional[float] = None,
                 concurrency_discount: float = 0.1,
                 compute_tier: bool = True) -> Fabric:
    """The cluster fabric: per node a ``host:i`` path (the direct PCIe
    host path, the paper's P) and a weaker ``soc:i`` offload path (the
    SoC DMA engine, §3.3's ~0.7 P) sharing one interference group, plus
    one switch-aggregated ``net`` path all ring traffic crosses.

    With ``compute_tier`` (default), each node also carries its compute
    resources as ops/s paths — ``cpu:host:i``, ``cpu:soc:i`` and
    ``dca:i`` (offload/device rooflines) — so codec cycles and staging
    bytes are budgeted in one ledger and the host-vs-SoC compression
    crossover can emerge from scheduling. ``host_bw`` defaults to
    ``hw.PCIE_BW`` and ``net_bw_per_node`` to ``hw.DCN_BW_PER_CHIP``."""
    host_bw = hw.PCIE_BW if host_bw is None else host_bw
    net_bw_per_node = hw.DCN_BW_PER_CHIP if net_bw_per_node is None \
        else net_bw_per_node
    paths = []
    for i in range(nodes):
        paths.append(Path(f"host:{i}", host_bw, latency=hw.PCIE_LAT,
                          kind="pcie", shared_group=f"pcie:{i}"))
        paths.append(Path(f"soc:{i}", soc_frac * host_bw, latency=hw.PCIE_LAT,
                          kind="pcie", shared_group=f"pcie:{i}"))
        if compute_tier:
            paths.extend(node_compute_paths(i))
    paths.append(Path("net", net_bw_per_node * nodes, latency=hw.DCN_LAT,
                      kind="dcn", shared_group="net"))
    return Fabric(paths, concurrency_discount=concurrency_discount)


#: named fabrics for ``launch/train.py --simulate``: the H100 default
#: (``core/hw.py``), a weaker SoC DMA engine, a fatter network, and the
#: LineFS §5.1 testbed bandwidths (200 Gb net / 256 Gb internal).
TRAIN_FABRICS: Dict[str, Callable[[int], Fabric]] = {
    "h100": lambda n: train_fabric(n),
    "weak-soc": lambda n: train_fabric(n, soc_frac=0.4),
    "fast-net": lambda n: train_fabric(
        n, net_bw_per_node=4 * hw.DCN_BW_PER_CHIP),
    "linefs": lambda n: train_fabric(
        n, host_bw=256e9 / 8, net_bw_per_node=200e9 / 8),
}


@dataclass(frozen=True)
class BucketSlice:
    """One layer-group's slice of the per-step cost: the compute time
    of its backward segment and the gradient bytes it produces."""
    compute_s: float
    grad_bytes: float


def _exact_split(total: float, weights: List[float],
                 total_w: float) -> List[float]:
    """Split ``total`` into ``len(weights)`` non-negative float parts,
    proportional to ``weights``, whose left-to-right float sum is
    *exactly* ``total``: the split is taken on the integer grid of
    ``total``'s 53-bit significand, so every partial sum is an integer
    multiple of one scale below 2**53 — exactly representable, hence
    summation never rounds. Bucketing changes *when* cost is paid,
    never how much."""
    k = len(weights)
    if total == 0.0:
        return [0.0] * k
    m, e = math.frexp(total)
    scale = math.ldexp(1.0, e - 53)
    units = int(math.ldexp(m, 53))        # total == units * scale, exact
    parts: List[float] = []
    acc, cum = 0, 0.0
    for w in weights[:-1]:
        cum += w
        edge = int(round(units * (cum / total_w)))
        edge = min(max(edge, acc), units)
        parts.append((edge - acc) * scale)
        acc = edge
    parts.append((units - acc) * scale)
    return parts


def layer_group_weights(cfg, k: int) -> List[float]:
    """Per-bucket gradient-size weights from the *real* parameter tree:
    the model's tensors (configs.base._param_tree_sizes) are grouped
    into ``k`` contiguous layer groups — layer ``i`` lands in group
    ``i * k // num_layers`` — with the embedding riding the first group
    and the head/final norm the last (they produce their gradients at
    the edges of backward). The weights are plain parameter counts, so
    a ``bucket_plan(weights=...)`` split reflects where the bytes
    actually are: an embedding-heavy small model front-loads bucket 0,
    a deep uniform model degenerates to the uniform split."""
    from repro_torch.configs.base import _param_tree_sizes
    num_layers = cfg.num_layers
    if not 1 <= k <= num_layers:
        raise ValueError(f"need 1 <= buckets <= num_layers ({num_layers}), "
                         f"got {k}")
    weights = [0.0] * k
    for name, size in _param_tree_sizes(cfg).items():
        if name.startswith("layer"):
            layer = int(name.split(".", 1)[0][len("layer"):])
            group = layer * k // num_layers
        elif name == "embed.table":
            group = 0
        else:                       # lm_head, final_norm, ...
            group = k - 1
        weights[group] += float(size)
    return weights


@dataclass(frozen=True)
class ClusterTimeModel:
    """Per-step cost model for one simulated node."""
    compute_s: float                 # roofline compute time per step
    grad_bytes: float                # gradient bytes staged host<->device
    ckpt_bytes: float = 0.0          # per-node checkpoint shard bytes
    ckpt_path: str = SOC             # staging mode, one of _CKPT_MODES
    tokens_per_step: int = 0         # global tokens, for tokens/s
    ckpt_ratio: float = CKPT_RATIO   # compressed fraction (compress modes)
    ckpt_codec_ops: float = 1.0      # modeled codec ops per raw byte —
    #                                  fixed here so the simulation does
    #                                  not depend on which codec wheel
    #                                  happens to be installed
    chunk_bytes: Optional[float] = None   # split tenant transfers into
    #                                  chunks of at most this size (the
    #                                  simulate_replication pipeline idea
    #                                  on the step path): an admission
    #                                  pause then takes effect at the
    #                                  next chunk boundary without
    #                                  cancel/re-issue (drain mode)
    buckets: int = 1                 # per-layer-group gradient buckets:
    #                                  K > 1 issues each bucket's
    #                                  allreduce as soon as its slice of
    #                                  backward completes (classic DDP
    #                                  overlap); 1 = single-shot
    bucket_weights: Optional[Tuple[float, ...]] = None
    #                                  per-bucket cost weights (one per
    #                                  bucket, e.g. layer_group_weights
    #                                  from the real param tree); None =
    #                                  uniform

    def __post_init__(self):
        if self.ckpt_path not in _CKPT_MODES:
            raise ValueError(f"ckpt_path must be one of {_CKPT_MODES}, "
                             f"got {self.ckpt_path!r}")
        if not 0.0 < self.ckpt_ratio <= 1.0:
            raise ValueError(f"ckpt_ratio must be in (0, 1], "
                             f"got {self.ckpt_ratio}")
        if self.ckpt_codec_ops < 0:
            raise ValueError(f"ckpt_codec_ops must be >= 0, "
                             f"got {self.ckpt_codec_ops}")
        if self.chunk_bytes is not None and not self.chunk_bytes > 0:
            raise ValueError(f"chunk_bytes must be > 0, "
                             f"got {self.chunk_bytes}")
        if self.buckets < 1 or self.buckets != int(self.buckets):
            raise ValueError(f"buckets must be a positive int, "
                             f"got {self.buckets}")
        if self.bucket_weights is not None:
            object.__setattr__(self, "bucket_weights",
                               tuple(self.bucket_weights))
            if len(self.bucket_weights) != self.buckets \
                    or any(w <= 0 for w in self.bucket_weights):
                raise ValueError(
                    f"bucket_weights needs {self.buckets} positive entries, "
                    f"got {self.bucket_weights}")

    def bucket_plan(self, k: Optional[int] = None, *,
                    weights: Optional[List[float]] = None
                    ) -> List[BucketSlice]:
        """The per-layer-group cost breakdown: ``k`` slices of
        (compute_s, grad_bytes) whose plain left-to-right sums equal
        *exactly* the step totals (see ``_exact_split`` — bucketing
        changes *when* bytes move, never how many). ``weights`` skews
        the split toward heavier layer groups (e.g. an
        embedding-dominated first group); defaults to the model's
        ``bucket_weights`` when they match ``k``, else uniform."""
        k = self.buckets if k is None else k
        if k < 1:
            raise ValueError(f"bucket_plan needs k >= 1, got {k}")
        if weights is None:
            weights = list(self.bucket_weights) \
                if self.bucket_weights is not None \
                and len(self.bucket_weights) == k else [1.0] * k
        if len(weights) != k or any(w <= 0 for w in weights):
            raise ValueError(f"need {k} positive weights, got {weights}")
        total_w = math.fsum(weights)
        cs = _exact_split(self.compute_s, weights, total_w)
        gs = _exact_split(self.grad_bytes, weights, total_w)
        return [BucketSlice(c, g) for c, g in zip(cs, gs)]

    @classmethod
    def from_config(cls, cfg, shape, *, nodes: int, devices_per_node: int = 8,
                    ckpt_path: str = SOC, grad_dtype_bytes: int = 2,
                    state_bytes_per_param: int = 10,
                    buckets: int = 1,
                    weighted_buckets: bool = False) -> "ClusterTimeModel":
        """Roofline estimate from a model config + batch shape: compute
        is 6*N*D over the cluster's peak FLOP/s (``hw.PEAK_FLOPS_BF16``
        per device); gradient staging is the
        bf16 gradient buffer; the checkpoint shard is params + AdamW
        moments split over the nodes. ``weighted_buckets`` sizes each
        gradient bucket from the model's *real* per-layer-group
        parameter counts (layer_group_weights) instead of splitting
        uniformly."""
        from repro_torch.core.roofline import model_flops_for
        tokens = shape.global_batch * shape.seq_len
        flops = model_flops_for(cfg.active_param_count(), tokens, "train")
        peak = hw.PEAK_FLOPS_BF16 * nodes * devices_per_node
        n_params = cfg.param_count()
        return cls(
            compute_s=flops / peak,
            grad_bytes=grad_dtype_bytes * n_params / nodes,
            ckpt_bytes=state_bytes_per_param * n_params / nodes,
            ckpt_path=ckpt_path,
            tokens_per_step=tokens,
            buckets=buckets,
            bucket_weights=tuple(layer_group_weights(cfg, buckets))
            if weighted_buckets and buckets > 1 else None,
        )


@dataclass
class ClusterNode:
    name: str
    index: int
    devices: int = 8
    alive: bool = True
    compute_scale: float = 1.0       # inherent speed (a slow node > 1)
    share_scale: float = 1.0         # mitigation-adjusted work share
    proc: Optional[Process] = None
    hb_proc: Optional[Process] = None
    inflight: List[Transfer] = field(default_factory=list)
    subprocs: List[Process] = field(default_factory=list)  # bucket procs


class TrainCluster:
    """N simulated trainer nodes stepping in lockstep on one runtime.

    ``step_fn(params, opt_state, batch, step) -> (params, opt_state,
    metrics)`` + ``batch_at(step)`` drive the optional numeric stream;
    ``ckpt`` persists it (real checkpoints, real restore after a
    simulated failure). ``fail_at=(node_name, step)`` silences a node
    at the start of that step; detection, elastic resize and resume
    then happen in simulated time.
    """

    def __init__(self, nodes: int, time_model: ClusterTimeModel, *,
                 fabric: Optional[Fabric] = None,
                 runtime: Optional[FabricRuntime] = None,
                 step_fn: Optional[Callable] = None,
                 params: Any = None, opt_state: Any = None,
                 batch_at: Optional[Callable[[int], Any]] = None,
                 ckpt: Optional[CheckpointManager] = None,
                 ckpt_every: Optional[int] = None,
                 devices_per_node: int = 8,
                 model_axis: int = 1,
                 heartbeat_every: float = 0.5,
                 heartbeat_timeout: float = 2.0,
                 node_compute_scale: Optional[Dict[str, float]] = None,
                 host_load: Optional[Dict[str, float]] = None,
                 mitigate_stragglers: bool = False,
                 skew_batches: bool = False,
                 microbatches_per_node: int = 8,
                 fail_at: Optional[Tuple[str, int]] = None,
                 tenant: Optional[str] = None,
                 topology: Any = None,
                 tracer=None):
        if nodes < 1:
            raise ValueError("cluster needs at least one node")
        self.tm = time_model
        self.topology = topology         # PodTopology (train/pods.py) or None
        if topology is not None and topology.total_nodes != nodes:
            raise ValueError(
                f"topology is {topology.pods} pods x "
                f"{topology.nodes_per_pod} nodes = {topology.total_nodes}, "
                f"but the cluster has {nodes} nodes")
        if fabric is None:
            if topology is not None:
                from repro_torch.train.pods import pod_fabric
                fabric = pod_fabric(topology.pods, topology.nodes_per_pod)
            else:
                fabric = train_fabric(nodes)
        self.fabric = fabric
        # a cluster that owns its runtime traces by default (bucket
        # phase spans back the bucket_timeline accessor); a cluster on
        # a *shared* runtime inherits that runtime's tracer instead
        if runtime is not None:
            if tracer is not None:
                raise ValueError("pass the tracer to the shared runtime, "
                                 "not to the cluster")
            self.runtime = runtime
        else:
            self.runtime = FabricRuntime(
                self.fabric, tracer=tracer if tracer is not None else Tracer())
        self.step_fn = step_fn
        self.params, self.opt_state = params, opt_state
        self.batch_at = batch_at
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every if ckpt_every is not None \
            else (ckpt.every if ckpt is not None else 0)
        self.model_axis = model_axis
        self.heartbeat_every = heartbeat_every
        self.heartbeat_timeout = heartbeat_timeout
        self.mitigate_stragglers = mitigate_stragglers
        self.skew_batches = skew_batches   # route straggler shares into
        #                                    real per-node microbatch
        #                                    counts (train_step
        #                                    node_shares) — the numeric
        #                                    twin of share_scale
        if microbatches_per_node < 1:
            raise ValueError(f"microbatches_per_node must be >= 1, "
                             f"got {microbatches_per_node}")
        self.microbatches_per_node = microbatches_per_node
        self.fail_at = fail_at
        self.tenant = tenant             # QoS tag on every fabric transfer
        self.offload = OffloadStats()    # host-cycles-saved accounting
        if time_model.ckpt_path in _COMPRESS_MODES \
                and time_model.ckpt_bytes > 0:
            kind = "dca" if time_model.ckpt_path == SOC_COMPRESS \
                else "cpu:host"
            missing = [self._node_path(i, kind) for i in range(nodes)
                       if self._node_path(i, kind) not in self.fabric]
            if missing:
                raise FabricError(
                    f"ckpt_path={time_model.ckpt_path!r} needs compute "
                    f"paths {missing} — build the fabric with "
                    "train_fabric(compute_tier=True)")
        self._paused = False             # admission-control throttle state
        self._resume = self.runtime.signal()
        self.straggler = StragglerDetector()
        self.ft = FaultToleranceManager(ckpt, timeout=heartbeat_timeout,
                                        runtime=self.runtime)
        self.nodes: List[ClusterNode] = [
            ClusterNode(f"node{i}", i, devices=devices_per_node)
            for i in range(nodes)]
        names = {n.name: n for n in self.nodes}
        for bad in set(node_compute_scale or ()) | set(host_load or ()):
            if bad not in names:
                raise ValueError(f"unknown node {bad!r} "
                                 f"(cluster has {sorted(names)})")
        if fail_at is not None and fail_at[0] not in names:
            raise ValueError(f"fail_at names unknown node {fail_at[0]!r} "
                             f"(cluster has {sorted(names)})")
        for n in self.nodes:
            n.compute_scale = (node_compute_scale or {}).get(n.name, 1.0)
        for name, frac in (host_load or {}).items():
            # a load at/above the discounted capacity stalls the node's
            # gradient flow at rate 0 forever: the clock never drains
            limit = 1.0 - self.fabric.concurrency_discount
            if not 0.0 <= frac < limit:
                raise ValueError(
                    f"host_load[{name!r}]={frac} must be in [0, {limit}) — "
                    "at or above 1 - concurrency_discount the node's own "
                    "traffic would stall forever")
            i = names[name].index
            hp = self._node_path(i, HOST)
            cap = self.fabric[hp].capacity
            self.runtime.ledger.reserve(hp, out=frac * cap,
                                        in_=frac * cap,
                                        flow=f"hostload:{name}")
        self.start_step = 0
        self.history: List[dict] = []
        self.events: List[dict] = []
        self.mesh_shape: Tuple[int, ...] = ()
        self._barrier: Optional[Barrier] = None
        self._bucket_barriers: List[Barrier] = []
        # open bucket phase spans keyed (step, bucket): opened by the
        # first node to issue the bucket's allreduce, closed at the
        # bucket barrier's release — the overlap timeline now lives in
        # the tracer (see the bucket_timeline accessor)
        self._bucket_spans: Dict[Tuple[int, int], Optional[Span]] = {}
        self._step = 0
        self._end = 0
        self._step_start = 0.0
        if ckpt is not None and step_fn is not None \
                and ckpt.latest_step() is not None:
            (self.params, self.opt_state), k = ckpt.restore(
                (self.params, self.opt_state))
            self.start_step = k + 1

    # -- path naming (pod-aware) -----------------------------------------
    def _node_path(self, index: int, kind: str) -> str:
        """The fabric name of global node ``index``'s per-node path of
        ``kind`` (``host``, ``soc``, ``dca``, ``cpu:host``, ...):
        ``pod{p}/<kind>:<local>`` under a PodTopology, ``<kind>:<index>``
        single-pod."""
        if self.topology is not None:
            return self.topology.node_path(index, kind)
        return f"{kind}:{index}"

    def _net_path(self, index: int) -> str:
        """The ring-allreduce path node ``index`` uses: its pod's
        ``pod{p}/net`` under a PodTopology, the shared ``net`` else."""
        if self.topology is not None:
            return self.topology.net_path(index)
        return "net"

    # -- membership ------------------------------------------------------
    def _live(self) -> List[ClusterNode]:
        return [n for n in self.nodes if n.alive]

    def _ring_peers(self, node: ClusterNode) -> int:
        """How many live nodes share ``node``'s intra-pod ring (all live
        nodes single-pod; the pod's live membership under a topology)."""
        live = self._live()
        if self.topology is None:
            return len(live)
        p = self.topology.pod_of(node.index)
        return sum(1 for n in live if self.topology.pod_of(n.index) == p)

    def _ckpt_step(self, step: int) -> bool:
        return (self.tm.ckpt_bytes > 0 and self.ckpt_every > 0
                and step % self.ckpt_every == 0)

    def _staging_mode(self, node: ClusterNode) -> str:
        """This save's staging strategy. ``auto`` costs the node's raw
        wires *and* — when the fabric carries the compute tier — the
        compress-then-stage strategies against live wire+compute
        occupancy (CheckpointManager.choose_staging with
        StagingOptions); a static config keeps the fixed §6.1 choice."""
        if self.tm.ckpt_path != AUTO:
            return self.tm.ckpt_path
        i, tm = node.index, self.tm
        host_p, soc_p = self._node_path(i, HOST), self._node_path(i, SOC)
        dca_p = self._node_path(i, "dca")
        cpu_p = self._node_path(i, "cpu:host")
        cands = [StagingOption(HOST, host_p),
                 StagingOption(SOC, soc_p)]
        ops_per_byte = tm.ckpt_codec_ops
        if dca_p in self.fabric:
            cands.append(StagingOption(SOC_COMPRESS, soc_p,
                                       wire_scale=tm.ckpt_ratio,
                                       compute=dca_p,
                                       ops_scale=ops_per_byte))
        if cpu_p in self.fabric:
            cands.append(StagingOption(HOST_COMPRESS, host_p,
                                       wire_scale=tm.ckpt_ratio,
                                       compute=cpu_p,
                                       ops_scale=ops_per_byte))
        return CheckpointManager.choose_staging(
            cands, ledger=self.runtime.ledger, direction=OUT)

    # -- admission-control throttling ------------------------------------
    def pause_transfers(self, cancel: bool = True) -> None:
        """Defer the train tenant's fabric traffic: cancel every
        in-flight transfer (the reservations go straight back to the
        ledger) and hold new ones until ``resume_transfers``. Node
        processes park on the resume signal and re-issue the canceled
        remainders — progress is deferred, never lost.

        ``cancel=False`` is drain mode: in-flight work finishes and the
        pause takes effect when each node reaches its next transfer —
        with a chunked time model (``ClusterTimeModel.chunk_bytes``)
        that is at most one chunk away, so the pause is still prompt
        but without any cancel/re-issue churn."""
        if self._paused:
            return
        self._paused = True
        self._resume = self.runtime.signal()
        self.events.append({"t": self.runtime.clock.now,
                            "event": "transfers_paused", "step": self._step,
                            "mode": "cancel" if cancel else "drain"})
        if not cancel:
            return
        for n in self.nodes:
            for t in n.inflight:
                if not t.done:
                    self.runtime.cancel(t)

    def resume_transfers(self) -> None:
        if not self._paused:
            return
        self._paused = False
        self.events.append({"t": self.runtime.clock.now,
                            "event": "transfers_resumed", "step": self._step})
        self._resume.fire()

    @property
    def paused(self) -> bool:
        return self._paused

    def _tenant_xfer(self, node: ClusterNode, path: str, amount: float,
                     direction: str, flow: str):
        """Move ``amount`` over ``path`` respecting throttle pauses: a
        transfer the admission controller cancels is re-issued with its
        remaining amount after resume (cancel + re-issue is the pause
        mechanism — the ledger conserves across every transition).

        With ``chunk_bytes`` set, the amount moves as a pipeline of
        chunks, so a drain-mode pause (``pause_transfers(cancel=False)``)
        takes effect at the next chunk boundary — preemptible transfers
        without cancel/re-issue."""
        chunk = self.tm.chunk_bytes
        remaining = amount
        while remaining > 1e-9:
            while self._paused:
                yield self._resume
            issue = remaining if chunk is None else min(remaining, chunk)
            t = self.runtime.transfer(path, issue, direction=direction,
                                      flow=flow, tenant=self.tenant)
            node.inflight.append(t)
            yield t
            remaining -= issue - t.remaining if t.canceled else issue

    def _tenant_compute(self, node: ClusterNode, resource: str, ops: float,
                        flow: str):
        """``_tenant_xfer`` for compute work: execute ``ops`` on an
        ops/s resource respecting throttle pauses — a canceled Compute
        is re-issued with its remaining ops after resume, and the
        reservation conserves across every transition."""
        remaining = ops
        while remaining > 1e-9:
            while self._paused:
                yield self._resume
            c = self.runtime.compute(resource, remaining, flow=flow,
                                     tenant=self.tenant)
            node.inflight.append(c)
            yield c
            if not c.canceled:
                return
            remaining = c.remaining

    def _ckpt_offload(self, node: ClusterNode, mode: str):
        """One compress-then-stage save (the offload tier on the step
        path): run the codec ops where the mode places them — the NIC's
        DCA engine or the host socket — then stage only the compressed
        bytes over that side's wire. Both stages are pause-safe; the SoC
        placement credits the codec ops as host cycles saved."""
        tm, i = self.tm, node.index
        ops = tm.ckpt_codec_ops * tm.ckpt_bytes
        wire_bytes = tm.ckpt_ratio * tm.ckpt_bytes
        if mode == SOC_COMPRESS:
            compute, wire = self._node_path(i, "dca"), self._node_path(i, SOC)
        else:
            compute = self._node_path(i, "cpu:host")
            wire = self._node_path(i, HOST)
        yield from self._tenant_compute(node, compute, ops,
                                        f"ckptcomp:{node.name}")
        yield from self._tenant_xfer(node, wire, wire_bytes, OUT,
                                     f"ckpt:{node.name}")
        self.offload.record_compression(
            int(tm.ckpt_bytes), int(wire_bytes), ops=ops,
            offloaded=(mode == SOC_COMPRESS))

    def _pod_sync(self, node: ClusterNode, grad_bytes: float, tag: str):
        """Inter-pod sync of one gradient slice over the shared DCN
        trunk (see train/pods.py). Only the pod *leader* — the
        lowest-indexed live node of the pod, so leadership survives
        pod-local failures — touches the trunk: a P_live-way ring
        exchange of the slice's pod-aggregate bytes,
        ``2 (P-1)/P * grad_bytes * nodes`` wire bytes per leader, all
        leaders contending on one trunk budget. Under
        ``sync="compressed"`` the leader first spends the codec ops on
        its pod-local host socket, then moves ``compress_ratio`` of the
        bytes — the simulated twin of RunConfig.pod_sync="compressed".
        Non-leaders skip straight to the closing barrier, which is what
        makes the trunk time part of every node's step. Bucketed runs
        call this once per bucket (``grad_bytes`` = the slice, ``tag``
        carries the bucket suffix), so several leader-rings are in
        flight on the trunk at once — the hierarchical pipeline that
        keeps trunk and pod-local paths concurrently busy. Pause-safe
        via _tenant_compute/_tenant_xfer like all tenant traffic."""
        topo = self.topology
        live = [n.index for n in self._live()]
        if topo.leader_of(topo.pod_of(node.index), live) != node.index:
            return
        live_pods = len({topo.pod_of(i) for i in live})
        if live_pods < 2:
            return
        g_full = grad_bytes * len(self.nodes)
        wire = 2.0 * (live_pods - 1) / live_pods * g_full
        if wire <= 0:
            return
        if topo.sync == "compressed":
            ops = topo.codec_ops_per_byte * g_full
            if ops > 0:
                yield from self._tenant_compute(
                    node, topo.node_path(node.index, "cpu:host"), ops,
                    f"podcodec:{tag}")
            wire *= topo.compress_ratio
        yield from self._tenant_xfer(node, topo.trunk, wire, OUT,
                                     f"podsync:{tag}")

    # -- the per-node step loop -----------------------------------------
    def _grad_bucket(self, node: ClusterNode, grad_bytes: float, tag: str):
        """One gradient slice's allreduce, hierarchical: device->host
        staging (host OUT), the pod-local ring on the node's net path,
        the leader's inter-pod trunk ring under a topology, then
        host->device (host IN). ``tag`` names the flows (per-bucket tags
        keep concurrent buckets *distinct* flows, so the §4.1 discount
        emerges across in-flight buckets exactly as it does across
        tenants). Single-shot steps run this inline with
        ``tag=node.name`` — byte- and flow-identical to the pre-bucket
        schedule."""
        host_p = self._node_path(node.index, HOST)
        yield from self._tenant_xfer(node, host_p, grad_bytes, OUT,
                                     f"grad:{tag}")
        live = max(self._ring_peers(node), 1)
        ring = 2.0 * (live - 1) / live * grad_bytes
        if ring > 0:
            yield from self._tenant_xfer(node, self._net_path(node.index),
                                         ring, OUT, f"ring:{tag}")
        if self.topology is not None:
            yield from self._pod_sync(node, grad_bytes, tag)
        yield from self._tenant_xfer(node, host_p, grad_bytes, IN,
                                     f"grad:{tag}")

    def _bucket_proc(self, node: ClusterNode, k: int, grad_bytes: float,
                     own_done: Dict[str, float]):
        """One in-flight bucket: the slice's allreduce closed by the
        bucket's own cyclic barrier. Records the node's *own* completion
        time before the rendezvous (straggler timing must not be
        flattened by the barrier) and stamps the timeline at release."""
        yield from self._grad_bucket(node, grad_bytes,
                                     f"{node.name}:b{k}")
        own_done["t"] = max(own_done["t"], self.runtime.clock.now)
        yield self._bucket_barriers[k].arrive()

    def _on_bucket_done(self, k: int, _generation: int) -> None:
        span = self._bucket_spans.pop((self._step, k), None)
        self.runtime.tracer.end_phase(span)

    @property
    def bucket_timeline(self) -> List[dict]:
        """Per-(step, bucket) overlap records derived from the tracer's
        bucket phase spans: ``t_issue`` (first node issued the bucket's
        allreduce) -> ``t_done`` (the bucket's barrier released), in
        close order. Empty for single-shot (k=1) runs — and for a
        cluster sharing an untraced runtime, where no spans exist."""
        return [{"step": s.meta["step"], "bucket": s.meta["bucket"],
                 "t_issue": s.t_start, "t_done": s.t_end}
                for s in self.runtime.tracer.spans
                if s.kind == PHASE and s.name == "bucket"
                and not s.meta.get("aborted")]

    def _node_proc(self, node: ClusterNode):
        rt, tm = self.runtime, self.tm
        plan = tm.bucket_plan()
        bucketed = len(plan) > 1 and tm.grad_bytes > 0
        while node.alive and self._step < self._end:
            step = self._step
            if self.fail_at is not None and node.name == self.fail_at[0] \
                    and step >= self.fail_at[1]:
                node.alive = False            # goes silent: no barrier, no
                if node.hb_proc is not None:  # heartbeat -> watchdog fires
                    node.hb_proc.kill()
                self.events.append({"t": rt.clock.now, "event": "node_silent",
                                    "node": node.name, "step": step})
                return
            t0 = rt.clock.now
            node.inflight = [t for t in node.inflight if not t.done]
            node.subprocs = []
            ck = None
            ck_mode: Optional[str] = None
            if self._ckpt_step(step) and not self._paused:
                ck_mode = self._staging_mode(node)
                if ck_mode not in _COMPRESS_MODES:
                    # raw staging early-starts and overlaps the step
                    ck = rt.transfer(self._node_path(node.index, ck_mode),
                                     tm.ckpt_bytes, direction=OUT,
                                     flow=f"ckpt:{node.name}",
                                     tenant=self.tenant)
                    node.inflight.append(ck)
            own_done = {"t": t0}
            if bucketed:
                # staggered DDP pipeline: run each layer group's slice
                # of backward, then immediately put its bucket's
                # allreduce in flight — late buckets compute while
                # early buckets communicate, and the step's comm time
                # hides behind the remaining compute
                self.straggler.observe_ledger(
                    node.name, rt.ledger, self._node_path(node.index, HOST))
                for k, sl in enumerate(plan):
                    yield sl.compute_s * node.compute_scale \
                        * node.share_scale
                    if (step, k) not in self._bucket_spans:
                        self._bucket_spans[(step, k)] = \
                            rt.tracer.begin_phase("bucket",
                                                  tenant=self.tenant,
                                                  step=step, bucket=k)
                    node.subprocs.append(rt.process(
                        self._bucket_proc(node, k, sl.grad_bytes, own_done),
                        name=f"bucket:{node.name}:{k}"))
                for bp in node.subprocs:
                    yield bp                  # join: every bucket closed
            else:
                yield tm.compute_s * node.compute_scale * node.share_scale
                if tm.grad_bytes > 0:
                    # sample external host-direction occupancy *before*
                    # our own gradient flow joins the path (detector
                    # input)
                    self.straggler.observe_ledger(
                        node.name, rt.ledger,
                        self._node_path(node.index, HOST))
                    yield from self._grad_bucket(node, tm.grad_bytes,
                                                 node.name)
                    own_done["t"] = rt.clock.now
            if ck is not None:
                yield ck                      # staging is on the step path
                if ck.canceled and ck.remaining > 1e-9:
                    # throttled mid-save: defer the rest, same path
                    yield from self._tenant_xfer(node, ck.path, ck.remaining,
                                                 OUT, f"ckpt:{node.name}")
            elif self._ckpt_step(step):
                # a compress-then-stage save, or a save whose start was
                # deferred by a pause (re-choose the mode at resume)
                mode = ck_mode if ck_mode is not None \
                    else self._staging_mode(node)
                if mode in _COMPRESS_MODES:
                    yield from self._ckpt_offload(node, mode)
                else:
                    yield from self._tenant_xfer(
                        node, self._node_path(node.index, mode),
                        tm.ckpt_bytes, OUT, f"ckpt:{node.name}")
            if bucketed:
                # the node's own finish line: its last bucket's
                # completion (pre-barrier) or its checkpoint wait —
                # not the globally-synchronized join time
                own_t = own_done["t"]
                if self._ckpt_step(step):
                    own_t = max(own_t, rt.clock.now)
                self.straggler.observe(node.name, own_t - t0)
            else:
                self.straggler.observe(node.name, rt.clock.now - t0)
            yield self._barrier.arrive()

    def _heartbeat(self, node: ClusterNode) -> None:
        if node.alive:
            self.ft.heartbeat(node.name)

    # -- global-step bookkeeping (barrier release) -----------------------
    def _on_step_complete(self, _generation: int) -> None:
        step = self._step
        now = self.runtime.clock.now
        rec = {"step": step, "sim_t": now,
               "sim_seconds": now - self._step_start,
               "nodes": len(self._live())}
        if self.tm.tokens_per_step and rec["sim_seconds"] > 0:
            rec["tokens_per_s"] = self.tm.tokens_per_step / rec["sim_seconds"]
        if self.step_fn is not None:
            batch = self.batch_at(step)
            if self.skew_batches:
                # close the straggler loop into real data: the
                # detector's rebalanced split becomes per-node
                # microbatch counts for the step (equal shares take the
                # uniform, bit-identical path inside train_step)
                shares = self.straggler.microbatch_shares(
                    [n.name for n in self._live()],
                    self.microbatches_per_node)
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch, step,
                    node_shares=shares)
                rec["microbatch_shares"] = list(shares)
            else:
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch, step)
            rec.update({k: float(v) for k, v in metrics.items()})
            if self.ckpt is not None and self._ckpt_step(step):
                self.ckpt.save(step, (self.params, self.opt_state),
                               blocking=True)
        if self.mitigate_stragglers and self.straggler.stragglers():
            live = self._live()
            per = self.microbatches_per_node
            shares = self.straggler.rebalanced_shares(per * len(live))
            for n in live:
                n.share_scale = shares.get(n.name, per) / per
        self.history.append(rec)
        self._step = step + 1
        self._step_start = now
        # stamp completion at the last barrier release, so a colocated
        # run's summary is not diluted by other tenants' tail time
        self._done_at = now if self._step >= self._end else None

    # -- failure handling ------------------------------------------------
    def _failure_watch(self):
        while True:
            yield self.ft.failed
            # drain the queue, not just the fired value: two watchdogs
            # expiring at the same instant fire the Signal twice, but
            # only the first fire finds a registered waiter
            while self.ft.pending_failures:
                self._handle_failure(self.ft.pending_failures.pop(0))

    def _handle_failure(self, name: str) -> None:
        now = self.runtime.clock.now
        self.events.append({"t": now, "event": "failure_detected",
                            "node": name, "step": self._step})
        # quiesce: kill every step process (and its in-flight bucket
        # subprocesses) and cancel in-flight transfers
        for n in self.nodes:
            if n.proc is not None:
                n.proc.kill()
            for bp in n.subprocs:
                bp.kill()
            n.subprocs = []
            for t in n.inflight:
                if not t.done:
                    self.runtime.cancel(t)
            n.inflight = []
            if n.name == name:
                n.alive = False
                if n.hb_proc is not None:
                    n.hb_proc.kill()
        survivors = self._live()
        if not survivors:
            raise RuntimeError("no survivors after failure of " + name)
        shape, axes = best_mesh_for(sum(n.devices for n in survivors),
                                    model=self.model_axis)
        self.mesh_shape = shape
        resume = self._step
        if self.ckpt is not None and self.step_fn is not None:
            (self.params, self.opt_state), k = self.ckpt.restore(
                (self.params, self.opt_state))
            resume = k + 1
            self.history = [h for h in self.history if h["step"] < resume]
        self.events.append({"t": now, "event": "elastic_resize",
                            "nodes": len(survivors), "mesh": shape,
                            "axes": axes, "resume_step": resume})
        self._step = resume
        self._step_start = now
        # the aborted step's open bucket spans: close them marked
        # aborted so the timeline accessor skips them (the re-run step
        # opens fresh spans)
        for span in self._bucket_spans.values():
            self.runtime.tracer.end_phase(span, aborted=True)
        self._bucket_spans.clear()
        self._spawn(survivors)

    # -- lifecycle -------------------------------------------------------
    def _spawn(self, members: List[ClusterNode]) -> None:
        self._barrier = self.runtime.barrier(
            len(members), on_release=self._on_step_complete, name="allreduce")
        if self.tm.buckets > 1 and self.tm.grad_bytes > 0:
            # one cyclic barrier per bucket: bucket k of a step closes
            # when every member's bucket-k allreduce lands, independent
            # of the other buckets — the per-bucket rendezvous that
            # makes the overlap pipeline safe for the numeric stream
            self._bucket_barriers = self.runtime.barrier_pool(
                self.tm.buckets, len(members), name="bucket",
                on_release=self._on_bucket_done)
        else:
            self._bucket_barriers = []
        for n in members:
            n.proc = self.runtime.process(self._node_proc(n),
                                          name=f"step:{n.name}")

    def begin(self, num_steps: int) -> None:
        """Arm heartbeats/FT and spawn the step processes *without*
        driving the clock — for running this cluster as one tenant on a
        shared timeline (the tenancy Colocation harness owns the clock).
        Pair with ``done`` (poll) and ``finish()`` (teardown+summary);
        plain single-tenant callers just use ``run()``."""
        rt = self.runtime
        self._run_t0 = rt.clock.now
        self._num_steps = num_steps
        self._done_at: Optional[float] = None
        self._step = self.start_step
        self._end = self.start_step + num_steps
        self._step_start = self._run_t0
        for n in self._live():
            if n.name not in self.ft.nodes:
                self.ft.register(n.name, devices=n.devices)
            if n.hb_proc is None or n.hb_proc.done:
                n.hb_proc = rt.every(self.heartbeat_every,
                                     lambda n=n: self._heartbeat(n),
                                     name=f"hb:{n.name}", start_delay=0.0)
        self._watch = rt.process(self._failure_watch(), name="failure-watch")
        self._spawn(self._live())

    @property
    def done(self) -> bool:
        """True when every live node's step process has returned."""
        return all(n.proc is None or n.proc.done for n in self._live())

    def finish(self) -> dict:
        """Tear down the periodic machinery (so the heap can drain) and
        summarize the steps since ``begin``."""
        rt = self.runtime
        self._watch.kill()
        for n in self.nodes:
            if n.hb_proc is not None:
                n.hb_proc.kill()
                n.hb_proc = None
        self.ft.disarm()
        num_steps = self._num_steps
        first = self._end - num_steps
        self.start_step = self._step
        end_t = self._done_at if self._done_at is not None else rt.clock.now
        elapsed = end_t - self._run_t0
        summary = {
            "steps": self._step - first,    # completed by *this* call
            "sim_seconds": elapsed,
            "nodes": len(self._live()),
            "mesh": self.mesh_shape,
            "buckets": self.tm.buckets,
            "events": list(self.events),
        }
        if self.tm.tokens_per_step and elapsed > 0:
            summary["tokens_per_s"] = \
                self.tm.tokens_per_step * num_steps / elapsed
        if self.history and "loss" in self.history[-1]:
            summary["loss"] = self.history[-1]["loss"]
        return summary

    def run(self, num_steps: int) -> dict:
        """Advance ``num_steps`` global steps in simulated time. Returns
        a summary (simulated seconds, tokens/s, events)."""
        self.begin(num_steps)
        self.runtime.clock.run(stop=lambda: self.done)
        return self.finish()
