"""Multi-pod hierarchical fabrics: P pods of N nodes over a DCN trunk.

The single-pod ``train_fabric`` models one pod's host/soc/net paths.
Planet-scale training composes many such pods: each pod's fabric is
namespaced (``Fabric.namespaced("pod{p}")`` — every path and explicit
interference group gets the pod prefix, so structurally identical pods
coexist without colliding) and the copies are merged with
``merge_fabrics`` over one *shared* inter-pod trunk path, ``dcn:pod``.
The trunk is deliberately un-namespaced: every pod references the same
path name, so the merge folds it into a single budget all pods contend
on — and a conflicting trunk redefinition (two pods claiming different
trunk capacities) is a merge error, not a silent override.

``PodTopology`` is the runtime-side description ``TrainCluster``
consumes: node-index → pod mapping, path-name prefixing, and the
inter-pod gradient sync policy. Per global step each pod runs its
intra-pod ring allreduce on its own ``pod{p}/net``, then the pod
*leader* (the lowest-indexed live node — leadership survives pod-local
failures) exchanges the full gradient with the other pods over the
trunk: a P-way ring, ``2 (P_live - 1) / P_live * full_grad_bytes`` per
leader. ``sync="compressed"`` is the simulated twin of
``RunConfig.pod_sync="compressed"`` (train/train_step.py's int8 ring):
wire bytes shrink by ``compress_ratio`` but the leader first spends
``codec_ops_per_byte`` per raw byte on its pod-local host socket
(``pod{p}/cpu:host:<local>``). Whether that trade wins is emergent: a
thin trunk makes the halved wire bytes dominate (compressed wins), a
fat trunk makes the codec the bottleneck (raw wins) — asserted in
tests/test_pods.py across trunk bandwidths.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core import hw
from repro_torch.core.fabric import Fabric, Path, merge_fabrics
from repro_torch.train.cluster import train_fabric

#: the shared inter-pod DCN trunk path name (un-namespaced on purpose:
#: merging pods folds every reference into one budget)
TRUNK = "dcn:pod"

#: pod_sync modes (mirrors train/train_step.py RunConfig.pod_sync)
RAW, COMPRESSED = "auto", "compressed"
_SYNC_MODES = (RAW, COMPRESSED)


def trunk_path(trunk_bw: float, *, latency: float = hw.DCN_LAT) -> Path:
    """The inter-pod DCN trunk as a fabric Path (switch-aggregated:
    ``trunk_bw`` is the total cross-pod bandwidth all leaders share)."""
    return Path(TRUNK, trunk_bw, latency=latency, kind="dcn",
                shared_group=TRUNK)


@dataclass(frozen=True)
class PodTopology:
    """Node-index → pod mapping + inter-pod sync policy for
    ``TrainCluster``. Global node index ``i`` lives in pod
    ``i // nodes_per_pod`` with pod-local index ``i % nodes_per_pod``;
    its fabric paths carry the ``pod{p}<sep>`` prefix."""
    pods: int
    nodes_per_pod: int
    sync: str = RAW                    # RunConfig.pod_sync
    compress_ratio: float = 0.5        # int8 over bf16 wire bytes
    codec_ops_per_byte: float = 1.0    # leader encode+decode ops per raw byte
    sep: str = "/"
    trunk: str = TRUNK                 # shared inter-pod trunk path name

    def __post_init__(self):
        if self.pods < 1 or self.nodes_per_pod < 1:
            raise ValueError("PodTopology needs >= 1 pod of >= 1 node")
        if self.sync not in _SYNC_MODES:
            raise ValueError(f"sync must be one of {_SYNC_MODES}, "
                             f"got {self.sync!r}")
        if not 0.0 < self.compress_ratio <= 1.0:
            raise ValueError(f"compress_ratio must be in (0, 1], "
                             f"got {self.compress_ratio}")
        if self.codec_ops_per_byte < 0:
            raise ValueError("codec_ops_per_byte must be >= 0")

    @property
    def total_nodes(self) -> int:
        return self.pods * self.nodes_per_pod

    def pod_of(self, index: int) -> int:
        return index // self.nodes_per_pod

    def local_of(self, index: int) -> int:
        return index % self.nodes_per_pod

    def prefix(self, pod: int) -> str:
        return f"pod{pod}"

    def path(self, index: int, base: str) -> str:
        """The merged-fabric name of node ``index``'s pod-local path
        ``base`` — e.g. ``path(9, "host:1") == "pod2/host:1"`` at 4
        nodes/pod. ``base`` uses the *pod-local* node index."""
        return f"{self.prefix(self.pod_of(index))}{self.sep}{base}"

    def node_path(self, index: int, kind: str) -> str:
        """Pod-prefixed per-node path of ``kind`` (``host``, ``soc``,
        ``dca``, ``cpu:host``, ``cpu:soc``) for global node ``index``."""
        return self.path(index, f"{kind}:{self.local_of(index)}")

    def net_path(self, index: int) -> str:
        """The intra-pod ring path of global node ``index``'s pod."""
        return self.path(index, "net")

    def leader_of(self, pod: int, live: List[int]) -> Optional[int]:
        """The pod's trunk leader: its lowest-indexed *live* node (so
        leadership survives pod-local failures), or None when the pod
        has no survivors. ``live`` is the global indices of live
        nodes."""
        members = [i for i in live if self.pod_of(i) == pod]
        return min(members) if members else None


def pod_fabric(pods: int, nodes_per_pod: int, *,
               trunk_bw: Optional[float] = None,
               pod_fabric_fn=None, sep: str = "/",
               **train_fabric_kw) -> Fabric:
    """P structurally identical pod fabrics + the shared DCN trunk, as
    one merged Fabric. Each pod is ``train_fabric(nodes_per_pod)`` (or
    ``pod_fabric_fn(nodes_per_pod)``) namespaced ``pod{p}``; the trunk
    defaults to ``pods * DCN_BW_PER_CHIP`` aggregate bandwidth. The
    merged concurrency discount is the max over the inputs
    (merge_fabrics semantics)."""
    if pods < 1 or nodes_per_pod < 1:
        raise ValueError("pod_fabric needs >= 1 pod of >= 1 node")
    build = pod_fabric_fn if pod_fabric_fn is not None \
        else (lambda n: train_fabric(n, **train_fabric_kw))
    bw = trunk_bw if trunk_bw is not None else pods * hw.DCN_BW_PER_CHIP
    pod_fabs = [build(nodes_per_pod).namespaced(f"pod{p}", sep=sep)
                for p in range(pods)]
    trunk = Fabric.of(trunk_path(bw),
                      concurrency_discount=pod_fabs[0].concurrency_discount)
    return merge_fabrics(*pod_fabs, trunk)


def pod_cluster(pods: int, nodes_per_pod: int, time_model, *,
                sync: str = RAW, trunk_bw: Optional[float] = None,
                compress_ratio: float = 0.5, codec_ops_per_byte: float = 1.0,
                **cluster_kw):
    """Convenience builder: a ``TrainCluster`` over ``pod_fabric`` with
    the matching ``PodTopology`` attached."""
    from repro_torch.train.cluster import TrainCluster
    topo = PodTopology(pods, nodes_per_pod, sync=sync,
                       compress_ratio=compress_ratio,
                       codec_ops_per_byte=codec_ops_per_byte)
    fab = pod_fabric(pods, nodes_per_pod, trunk_bw=trunk_bw)
    return TrainCluster(topo.total_nodes, time_model, fabric=fab,
                        topology=topo, **cluster_kw)
