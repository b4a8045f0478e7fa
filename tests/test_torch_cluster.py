"""The port's simulated training cluster, pods, fault tolerance, trainer
and launcher against the JAX package's, on the CPU.

Timing scenarios are functions of a module set, run once through
``repro.*`` and once through the ``repro_torch`` copies and ports, with
the port's ``core/hw.py`` set to the JAX package's constants (the
``jax_constants`` fixture): events, ``sim_t``, history, straggler state,
offload counters and every ledger reservation must be equal with ``==``.
The scenarios are those of ``tests/test_cluster.py``,
``tests/test_pods.py``, ``tests/test_overlap.py``,
``tests/test_offload.py:359-470``, ``tests/test_ckpt_ft.py:60-170`` and
``tests/test_obs.py:186,327``.

The numeric stream is the torch train step on reduced internlm2 (4 x
32 tokens, bridged from the JAX params): its losses are held to the JAX
cluster's within rel 1e-3 (the loss tolerance of
``tests/test_torch_train.py``'s trainer test), and a failed-then-resumed
run's losses and final params and moments to the uninterrupted port
run's bit for bit (``tests/test_cluster.py:220``)."""
import contextlib
import dataclasses
import io
import json
import shutil
import types

import jax
import numpy as np
import pytest
import torch

import repro.ckpt.checkpoint as j_ckpt
import repro.ckpt.replication as j_repl
import repro.core.fabric as j_fabric
import repro.core.hw as j_hw
import repro.core.runtime as j_runtime
import repro.ft.elastic as j_elastic
import repro.ft.manager as j_manager
import repro.ft.straggler as j_straggler
import repro.launch.train as j_launch
import repro.obs.metrics as j_metrics
import repro.obs.trace as j_trace
import repro.offload.program as j_program
import repro.train.cluster as j_cluster
import repro.train.pods as j_pods
import repro.train.trainer as j_trainer
import repro_torch.ckpt.checkpoint as t_ckpt
import repro_torch.ckpt.replication as t_repl
import repro_torch.core.fabric as t_fabric
import repro_torch.core.hw as t_hw
import repro_torch.core.runtime as t_runtime
import repro_torch.ft.elastic as t_elastic
import repro_torch.ft.manager as t_manager
import repro_torch.ft.straggler as t_straggler
import repro_torch.launch.train as t_launch
import repro_torch.obs.metrics as t_metrics
import repro_torch.obs.trace as t_trace
import repro_torch.offload.program as t_program
import repro_torch.train.cluster as t_cluster
import repro_torch.train.pods as t_pods
import repro_torch.train.trainer as t_trainer
from repro.configs import RunConfig as JRunConfig
from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models.params import init_params as jax_init_params
from repro.optim import adamw as JO
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import RunConfig, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.compression import Quantized
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.optim.adamw import adamw_init, tree_leaves
from repro_torch.train.train_step import make_train_step

JAX = types.SimpleNamespace(cluster=j_cluster, pods=j_pods, fabric=j_fabric,
                            runtime=j_runtime, ckpt=j_ckpt, repl=j_repl, manager=j_manager,
                            straggler=j_straggler, elastic=j_elastic, trace=j_trace,
                            metrics=j_metrics, program=j_program, default_fabric="v5e")
PORT = types.SimpleNamespace(cluster=t_cluster, pods=t_pods, fabric=t_fabric,
                             runtime=t_runtime, ckpt=t_ckpt, repl=t_repl, manager=t_manager,
                             straggler=t_straggler, elastic=t_elastic, trace=t_trace,
                             metrics=t_metrics, program=t_program, default_fabric="h100")
HW_NAMES = ("PEAK_FLOPS_BF16", "HBM_BW", "HBM_BYTES", "PCIE_BW", "PCIE_LAT",
            "DCN_BW_PER_CHIP", "DCN_LAT")
LOSS_REL = 1e-3


@pytest.fixture
def jax_constants(monkeypatch):
    """The port's ``core/hw.py`` set to the JAX package's constants, and
    the two keyword defaults that the copies bound from it at import."""
    for name in HW_NAMES:
        monkeypatch.setattr(t_hw, name, getattr(j_hw, name))
    monkeypatch.setitem(t_pods.trunk_path.__kwdefaults__, "latency", j_hw.DCN_LAT)
    for fn in (t_repl.plan_replication, t_repl.simulate_replication):
        monkeypatch.setitem(fn.__kwdefaults__, "net_bw", j_hw.DCN_BW_PER_CHIP)
        monkeypatch.setitem(fn.__kwdefaults__, "staging_bw", j_hw.PCIE_BW)


def _ledger(rt):
    return sorted(rt.ledger._by_flow.items())


def _cluster_state(c, summary):
    return (summary, c.history, c.events, _ledger(c.runtime), dict(c.straggler.ema),
            dict(c.straggler.occupancy), c.offload.get_performance_stats())


# -- tests/test_cluster.py ----------------------------------------------

def staging_crossover(m):                                      # :130
    def step_time(grad_bytes, ckpt_path, ckpt_bytes=8e9, steps=6):
        tm = m.cluster.ClusterTimeModel(compute_s=0.05, grad_bytes=grad_bytes,
                                        ckpt_bytes=ckpt_bytes, ckpt_path=ckpt_path)
        return m.cluster.TrainCluster(2, tm, ckpt_every=2).run(steps)["sim_seconds"] / steps
    return [step_time(g, p, **kw) for g in (8e9, 1e6) for p in ("soc", "host")
            for kw in ({}, {"ckpt_bytes": 0.0})]


def host_load_straggler(m):                                    # :159
    tm = m.cluster.ClusterTimeModel(compute_s=0.05, grad_bytes=2e9)
    c = m.cluster.TrainCluster(3, tm, host_load={"node1": 0.7})
    return _cluster_state(c, c.run(4)) + (c.straggler.stragglers(),)


def named_fabrics(m):                                          # :171
    cfg = (jax_get_config if m is JAX else get_config)("internlm2-1.8b").reduced()
    shape = (JShapeConfig if m is JAX else ShapeConfig)("t", 128, 8, "train")
    out = {}
    for name, build in m.cluster.TRAIN_FABRICS.items():
        fab = build(2)
        out[m.default_fabric == name and "default" or name] = \
            [dataclasses.astuple(fab[p]) for p in fab] + [fab.concurrency_discount]
    for kw in ({}, {"buckets": 2, "weighted_buckets": True}, {"ckpt_path": "auto"}):
        out[str(kw)] = dataclasses.astuple(
            m.cluster.ClusterTimeModel.from_config(cfg, shape, nodes=2, **kw))
    out["weights"] = m.cluster.layer_group_weights(cfg, 2)
    return out


def barrier_steps(m):                                          # :282
    tm = m.cluster.ClusterTimeModel(compute_s=0.01, grad_bytes=4e9, ckpt_bytes=4e9)
    c = m.cluster.TrainCluster(3, tm, ckpt_every=2)
    return _cluster_state(c, c.run(6))


def failure_and_cancel(m):                                     # :289
    tm = m.cluster.ClusterTimeModel(compute_s=0.05, grad_bytes=4e9, ckpt_bytes=4e9)
    c = m.cluster.TrainCluster(3, tm, ckpt_every=2, host_load={"node0": 0.3},
                               heartbeat_every=0.2, heartbeat_timeout=1.0,
                               fail_at=("node2", 3), mitigate_stragglers=True)
    return _cluster_state(c, c.run(6)) + (c.mesh_shape, [n.share_scale for n in c.nodes])


def chainable(m):                                              # :304
    c = m.cluster.TrainCluster(2, m.cluster.ClusterTimeModel(compute_s=0.01, grad_bytes=1e9))
    s1 = c.run(3)
    return s1, c.start_step, c.run(2), _cluster_state(c, {})


def _raises(fn):
    try:
        fn()
    except Exception as e:          # the exception's type and text are the result
        return type(e).__name__, str(e)
    return None


def validation(m):                                             # :317
    C = m.cluster
    tm = C.ClusterTimeModel(compute_s=0.01, grad_bytes=1e9)
    return [_raises(f) for f in (
        lambda: C.TrainCluster(2, tm, host_load={"node0": 0.95}),
        lambda: C.TrainCluster(2, tm, host_load={"node7": 0.5}),
        lambda: C.TrainCluster(2, tm, fail_at=("node9", 3)),
        lambda: C.TrainCluster(2, tm, node_compute_scale={"nodeX": 2.0}),
        lambda: C.TrainCluster(0, tm),
        lambda: C.ClusterTimeModel(compute_s=1.0, grad_bytes=0.0, ckpt_path="nvme"),
        lambda: C.ClusterTimeModel(compute_s=0.01, grad_bytes=0.0, ckpt_ratio=0.0),
        lambda: C.TrainCluster(1, C.ClusterTimeModel(compute_s=0.01, grad_bytes=0.0,
                                                     ckpt_bytes=1e9,
                                                     ckpt_path="soc-compress"),
                               fabric=C.train_fabric(1, compute_tier=False)),
        lambda: C.TrainCluster(3, C.ClusterTimeModel(compute_s=0.01, grad_bytes=0.0),
                               topology=m.pods.PodTopology(2, 2)),
        lambda: m.pods.PodTopology(0, 4), lambda: m.pods.PodTopology(2, 2, sync="bogus"),
        lambda: m.pods.PodTopology(2, 2, compress_ratio=0.0),
        lambda: m.fabric.merge_fabrics(m.fabric.Fabric.of(m.pods.trunk_path(25e9)),
                                       m.fabric.Fabric.of(m.pods.trunk_path(50e9))),
    )]


# -- tests/test_pods.py ---------------------------------------------------

def pod_topology(m):                                           # :17
    topo = m.pods.PodTopology(3, 4)
    fab = m.pods.pod_fabric(3, 2)
    return (topo.total_nodes, topo.pod_of(11), topo.local_of(9), topo.node_path(9, "host"),
            topo.node_path(5, "cpu:host"), topo.net_path(7), topo.trunk,
            topo.leader_of(1, [4, 6, 7]), topo.leader_of(2, [0]),
            [dataclasses.astuple(fab[p]) for p in fab])


def pod_sync_crossover(m):                                     # :78
    out = []
    for sync in ("compressed", "auto"):
        for trunk in (25e9, 400e9):
            tm = m.cluster.ClusterTimeModel(compute_s=0.05, grad_bytes=1e9,
                                            tokens_per_step=4096)
            c = m.pods.pod_cluster(4, 2, tm, sync=sync, trunk_bw=trunk)
            out.append(_cluster_state(c, c.run(4)))
    return out


def single_pod_vs_plain(m):                                    # :84
    tm = m.cluster.ClusterTimeModel(compute_s=0.05, grad_bytes=1e9, tokens_per_step=4096)
    return m.cluster.TrainCluster(2, tm).run(4), m.pods.pod_cluster(1, 2, tm).run(4)


# -- tests/test_overlap.py -------------------------------------------------

def bucket_plans(m):                                           # :45
    C = m.cluster
    tm = C.ClusterTimeModel(compute_s=0.7310391, grad_bytes=3.7e9 / 7)
    out = [tm.bucket_plan(k) for k in (1, 2, 3, 5, 8, 16)]
    out.append(C.ClusterTimeModel(compute_s=1.0, grad_bytes=1e10)
               .bucket_plan(3, weights=[4.0, 1.0, 1.0]))
    out.append(C.ClusterTimeModel(compute_s=0.4, grad_bytes=8e9, buckets=4).bucket_plan())
    out += [_raises(f) for f in (lambda: tm.bucket_plan(0),
                                 lambda: tm.bucket_plan(2, weights=[1.0]),
                                 lambda: tm.bucket_plan(2, weights=[1.0, -1.0]),
                                 lambda: C.ClusterTimeModel(compute_s=0.4, grad_bytes=8e9,
                                                            buckets=0))]
    return [[dataclasses.astuple(s) for s in p] if isinstance(p, list) else p for p in out]


HEADLINE = dict(compute_s=0.6, grad_bytes=2e9)


def _bucket_cluster(m, buckets, steps=4, nodes=2, fabric_kw=None, tm_kw=None, **kw):
    tm = m.cluster.ClusterTimeModel(buckets=buckets, **{**HEADLINE, **(tm_kw or {})})
    c = m.cluster.TrainCluster(nodes, tm, fabric=m.cluster.train_fabric(nodes, **(fabric_kw or {})),
                               **kw)
    return c, c.run(steps)


def bucket_overlap(m):                                         # :99-146
    out = []
    for k in (1, 2, 4):
        c, s = _bucket_cluster(m, k, steps=3)
        out.append((_cluster_state(c, s), c.bucket_timeline))
    for k in (1, 4):
        c, s = _bucket_cluster(m, k, fabric_kw=dict(host_bw=400e9, net_bw_per_node=400e9))
        out.append(s)
    c, s = _bucket_cluster(m, 4, steps=5, nodes=3, tm_kw=dict(ckpt_bytes=4e9), ckpt_every=2)
    out.append(_cluster_state(c, s))
    return out


def bucket_pauses(m):                                          # :152-190
    out = []
    for mode in ("drain", "cancel", None):
        tm = m.cluster.ClusterTimeModel(buckets=4, chunk_bytes=2.5e8 if mode == "drain"
                                        else None, **HEADLINE)
        c = m.cluster.TrainCluster(2, tm, fabric=m.cluster.train_fabric(2))
        rt = c.runtime
        if mode is not None:
            rt.clock.schedule(0.9 if mode == "drain" else 0.8,
                              lambda: c.pause_transfers(cancel=mode == "cancel"))
            rt.clock.schedule(1.9 if mode == "drain" else 1.8, c.resume_transfers)
        c.begin(3)
        rt.clock.run(stop=lambda: c.done)
        out.append(_cluster_state(c, c.finish()))
    return out


def pod_leader_bucketed(m):                                    # :193
    out = []
    for k in (1, 4):
        tm = m.cluster.ClusterTimeModel(compute_s=0.6, grad_bytes=5e8, buckets=k)
        c = m.pods.pod_cluster(2, 2, tm, sync="compressed", trunk_bw=25e9)
        out.append(_cluster_state(c, c.run(4)))
    return out


# -- tests/test_offload.py: compress-then-stage on the step path -----------

def compress_staging(m):                                       # :359-470
    C = m.cluster
    out = []
    for mode in (C.HOST_COMPRESS, C.SOC_COMPRESS, "auto", "soc", "host"):
        for load in (None, {"node0": 0.7, "node1": 0.7}):
            tm = C.ClusterTimeModel(compute_s=0.05, grad_bytes=1e6, ckpt_bytes=8e9,
                                    ckpt_path=mode, tokens_per_step=1000)
            c = C.TrainCluster(2, tm, ckpt_every=2, host_load=load)
            out.append(_cluster_state(c, c.run(2)))
    tm = C.ClusterTimeModel(compute_s=0.01, grad_bytes=0.0, ckpt_bytes=8e9,
                            ckpt_path=C.SOC_COMPRESS)
    c = C.TrainCluster(1, tm, ckpt_every=1)
    c.runtime.clock.schedule(0.3, c.pause_transfers)
    c.runtime.clock.schedule(0.6, c.resume_transfers)
    out.append(_cluster_state(c, c.run(1)))
    tm = C.ClusterTimeModel(compute_s=0.01, grad_bytes=0.0, ckpt_bytes=4e9, ckpt_path="auto")
    c = C.TrainCluster(1, tm, ckpt_every=1)
    c.runtime.ledger.reserve("host:0", out=0.95 * c.fabric["host:0"].capacity, flow="xh")
    c.runtime.ledger.reserve("soc:0", out=0.6 * c.fabric["soc:0"].capacity, flow="xs")
    out.append(_cluster_state(c, c.run(1)))
    return out


# -- tests/test_ckpt_ft.py: failure detection, stragglers, replication -----

def ft_wall_clock(m, tmp):                                     # :60
    clock = {"t": 0.0}
    mgr = m.ckpt.CheckpointManager(str(tmp), every=1)
    ft = m.manager.FaultToleranceManager(mgr, timeout=5.0, clock=lambda: clock["t"])
    for n in ("host0", "host1", "host2"):
        ft.register(n, devices=8)
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "c": np.int32(3)}
    mgr.save(42, tree, blocking=True)
    clock["t"] = 3.0
    ft.heartbeat("host0")
    ft.heartbeat("host1")
    clock["t"] = 7.0
    failed = ft.check()
    back, resume = ft.recover(tree)
    return failed, ft.alive_devices(), resume, ft.events, np.asarray(back["a"]).tolist()


def ft_event_driven(m):                                        # :87, :110
    rt = m.runtime.FabricRuntime(m.fabric.Fabric.of(m.fabric.Path("p", 1.0)))
    ft = m.manager.FaultToleranceManager(None, timeout=1.0, runtime=rt)
    ft.register("steady", devices=4)
    ft.register("silent", devices=4)
    fired = []
    ft.failed.wait(lambda name: fired.append((name, rt.clock.now)))
    hb = rt.every(0.4, lambda: ft.heartbeat("steady"), start_delay=0.0)
    rt.clock.run(until=3.0)
    hb.kill()
    ft.disarm()
    rt2 = m.runtime.FabricRuntime(m.fabric.Fabric.of(m.fabric.Path("p", 1.0)))
    ft2 = m.manager.FaultToleranceManager(None, timeout=1.0, runtime=rt2)
    ft2.register("a", devices=2)
    ft2.register("b", devices=2)
    rt2.clock.run(until=2.0)
    return fired, ft.events, ft.alive_devices(), sorted(ft2.pending_failures), ft2.events


def stragglers(m):                                             # :136, test_overlap :287
    det = m.straggler.StragglerDetector(threshold=1.5)
    for _ in range(5):
        det.observe("n0", 1.0)
        det.observe("n1", 1.1)
        det.observe("n2", 1.0)
        det.observe("slow", 2.5)
    out = [det.stragglers(), det.rebalanced_shares(32)]
    det = m.straggler.StragglerDetector()
    det.observe("node0", 1.0)
    det.observe("node1", 1.05)
    out.append(det.microbatch_shares(["node0", "node1"], 2))
    for _ in range(6):
        det.observe("node0", 1.0)
        det.observe("node1", 4.0)
    det.observe("node2", 0.1)
    out += [det.stragglers(), det.microbatch_shares(["node0", "node1"], 2), dict(det.ema)]
    return out


def replication(m):                                            # :164
    out = []
    for kw in (dict(ratio=0.3), dict(ratio=0.95, soc_rate=2e9), dict(ratio=0.5)):
        plan = m.repl.plan_replication(**kw)
        out.append((plan.ranked, [dataclasses.astuple(a) for a in plan.allocations],
                    plan.total_rate, plan.use_compression, plan.notes))
    for pipelined in (True, False):
        t = m.repl.simulate_replication(8e9, 0.5, chunks=6, pipelined=pipelined)
        out.append((dataclasses.astuple(t), t.percentile(50), t.percentile(99)))
    return out


def elastic(m):                                                # :92-119
    return [m.elastic.best_mesh_for(d, model=mod, prefer_pods=pp)
            for d in (1, 2, 3, 5, 6, 7, 9, 11, 12, 16, 24, 100, 248, 256, 512)
            for mod in (1, 4, 8, 16) for pp in (1, 2)]


# -- tests/test_obs.py: metrics --------------------------------------------

def metrics(m):                                                # :186, :327
    M = m.metrics
    c, g, h = M.Counter("n"), M.Gauge("depth"), M.Histogram("lat")
    c.inc()
    c.inc(2)
    g.set(4.5)
    for v in (1.0, 2.0, 3.0, 4.0, 5.0):
        h.observe(v)
    reg = M.MetricsRegistry()
    reg.counter("x").inc(5)
    reg.gauge("y").set(1.0)
    st = m.program.OffloadStats()
    st.record_program(100.0)
    st.record_compression(1000.0, 300.0)
    st.record_filter(100, 20)
    tracer = m.trace.Tracer()
    rt = m.runtime.FabricRuntime(m.fabric.Fabric.of(m.fabric.Path("link", 100.0),
                                                    concurrency_discount=0.125),
                                 tracer=tracer)
    sampler = M.OccupancyTimeSeries(rt, every=0.01)
    rng = np.random.default_rng(3)
    for i in range(12):
        rt.clock.schedule(0.2 * i, lambda i=i: rt.transfer(
            "link", float(rng.uniform(5, 40)), flow=f"f{i}", tenant=f"t{i % 3}"))
    rt.clock.run(until=5.0)
    return (c.value, g.value, h.count, h.mean, [h.percentile(q) for q in (0, 50, 100)],
            reg.counter("x") is reg.counter("x"), reg.snapshot(), dict(st.counters),
            st.get_performance_stats(), sampler.averages(m.fabric.OUT),
            sorted(tracer.busy_fraction().items()))


SCENARIOS = [staging_crossover, host_load_straggler, named_fabrics, barrier_steps,
             failure_and_cancel, chainable, validation, pod_topology, pod_sync_crossover,
             single_pod_vs_plain, bucket_plans, bucket_overlap, bucket_pauses,
             pod_leader_bucketed, compress_staging, ft_event_driven, stragglers,
             replication, elastic, metrics]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_port_equals_jax(scenario, jax_constants):
    port = scenario(PORT)
    assert port == scenario(JAX)


def test_ft_wall_clock_equals_jax(tmp_path):
    port = ft_wall_clock(PORT, tmp_path / "port")
    assert port == ft_wall_clock(JAX, tmp_path / "jax")
    assert port[:3] == (["host2"], 16, 43)


def test_h100_constants_are_the_default():
    """Without the fixture the fabric is the H100's: PCIe Gen5 x16 per
    direction, one 400 Gb/s NIC per GPU, 989 TFLOP/s bf16 per device."""
    fab = t_cluster.TRAIN_FABRICS["h100"](2)
    assert fab["host:0"].capacity == 64e9 and fab["soc:1"].capacity == 0.7 * 64e9
    assert fab["net"].capacity == 2 * 50e9 and fab["host:0"].latency == t_hw.PCIE_LAT
    assert "v5e" not in t_cluster.TRAIN_FABRICS
    cfg = get_config("internlm2-1.8b")
    tm = t_cluster.ClusterTimeModel.from_config(cfg, ShapeConfig("t", 4096, 8, "train"),
                                                nodes=1, devices_per_node=1)
    assert tm.compute_s == 6.0 * cfg.active_param_count() * 4096 * 8 / 989e12
    assert t_pods.pod_fabric(2, 1)[t_pods.TRUNK].capacity == 2 * 50e9
    for name in HW_NAMES:
        assert getattr(t_hw, name) != getattr(j_hw, name), name


# ----------------------------------------------------------------------
# the numeric stream: the torch step inside the cluster
# ----------------------------------------------------------------------

SHAPE = dict(seq_len=32, global_batch=4)


@pytest.fixture(scope="module")
def pieces():
    """The JAX step (jitted once) and params, and the port's step on the
    bridged params, for reduced internlm2 at 4 x 32 tokens."""
    jcfg = jax_get_config("internlm2-1.8b").reduced()
    cfg = get_config("internlm2-1.8b").reduced()
    kw = dict(learning_rate=3e-3, warmup_steps=2, total_steps=12)
    jparams = jax.jit(lambda k: jax_init_params(jcfg, k)[0])(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    jstep = jax.jit(j_make_train_step(jcfg, JRunConfig(**kw), impl="ref"),
                    static_argnames=("node_shares",))
    steps = {m: make_train_step(cfg, RunConfig(**kw, moments_int8=m == "int8"))
             for m in ("f32", "int8")}
    return types.SimpleNamespace(
        run_kw=kw, jcfg=jcfg, cfg=cfg, jparams=jparams, np_params=np_params, jstep=jstep, steps=steps,
        jpipe=JTokenPipeline(jcfg, JShapeConfig("tiny", kind="train", **SHAPE), seed=0),
        tpipe=TokenPipeline(cfg, ShapeConfig("tiny", kind="train", **SHAPE), seed=0))


def _numeric(m, pc, ckpt_dir=None, fail_at=None, *, pods=False, buckets=1, nodes=3,
             moments="f32", **kw):
    C = m.cluster
    tm = C.ClusterTimeModel(compute_s=0.05, grad_bytes=1e8,
                            ckpt_bytes=1e8 if ckpt_dir else 0.0,
                            tokens_per_step=4 * 32, buckets=buckets)
    if m is JAX:
        params = pc.jparams
        state = dict(step_fn=pc.jstep, params=params, opt_state=JO.adamw_init(params),
                     batch_at=pc.jpipe.batch_at)
    else:
        params = params_from_numpy(pc.np_params, device="cpu")
        state = dict(step_fn=pc.steps[moments], params=params,
                     opt_state=adamw_init(params, moments=moments),
                     batch_at=lambda s: {k: torch.from_numpy(v)
                                         for k, v in pc.tpipe.batch_at(s).items()})
    ckpt = m.ckpt.CheckpointManager(str(ckpt_dir), every=4, keep=3) if ckpt_dir else None
    common = dict(ckpt=ckpt, heartbeat_every=0.2, heartbeat_timeout=1.0, fail_at=fail_at,
                  **state, **kw)
    if pods:
        return m.pods.pod_cluster(2, 2, tm, **common)
    return C.TrainCluster(nodes, tm, ckpt_every=4 if ckpt_dir else 0, **common)


TIMING_KEYS = ("step", "sim_t", "sim_seconds", "nodes", "tokens_per_s", "microbatch_shares")
CASES = {                 # (cluster kwargs, fail_at, the uninterrupted run's kwargs)
    "cluster": (dict(), ("node2", 6), dict()),
    "pods": (dict(pods=True), ("node2", 6), dict(pods=True)),
    "buckets": (dict(buckets=4, nodes=2), ("node1", 6), dict(nodes=2)),
}


@pytest.fixture(scope="module")
def numeric_runs(pieces, tmp_path_factory):
    """Per case: the port's uninterrupted and failed runs and JAX's failed
    run (10 steps each), under the JAX package's constants."""
    mp = pytest.MonkeyPatch()
    try:
        for name in HW_NAMES:
            mp.setattr(t_hw, name, getattr(j_hw, name))
        mp.setitem(t_pods.trunk_path.__kwdefaults__, "latency", j_hw.DCN_LAT)
        out = {}
        for case, (kw, fail, ref_kw) in CASES.items():
            d = tmp_path_factory.mktemp(case)
            ref = _numeric(PORT, pieces, d / "ref", None, **ref_kw)
            ref.run(10)
            fl = _numeric(PORT, pieces, d / "fl", fail, **kw)
            s_fl = fl.run(10)
            jfl = _numeric(JAX, pieces, d / "jfl", fail, **kw)
            s_jfl = jfl.run(10)
            out[case] = ref, fl, s_fl, jfl, s_jfl
        return out
    finally:
        mp.undo()


def _losses(cluster):
    return {h["step"]: h["loss"] for h in cluster.history}


@pytest.mark.parametrize("case", CASES)
def test_numeric_timeline_equals_jax(numeric_runs, case):
    """Events, clock and history of the failed run equal JAX's; its losses
    are JAX's within rel 1e-3."""
    _, fl, s_fl, jfl, s_jfl = numeric_runs[case]
    assert s_fl == {**s_jfl, "loss": s_fl["loss"]}
    assert [{k: h[k] for k in TIMING_KEYS if k in h} for h in fl.history] == \
        [{k: h[k] for k in TIMING_KEYS if k in h} for h in jfl.history]
    assert _ledger(fl.runtime) == _ledger(jfl.runtime)
    for (step, loss), (jstep, jloss) in zip(sorted(_losses(fl).items()),
                                            sorted(_losses(jfl).items())):
        assert step == jstep and abs(loss - jloss) <= LOSS_REL * abs(jloss), step


def _state_leaves(cluster):
    return [x for leaf in tree_leaves((cluster.params, cluster.opt_state.m,
                                       cluster.opt_state.v))
            for x in (leaf if isinstance(leaf, Quantized) else [leaf])]


@pytest.mark.parametrize("case", CASES)
def test_failure_detect_resize_resume_bit_identical(numeric_runs, case):
    """``tests/test_cluster.py:220``'s assertions on the port: detection
    one timeout after the last heartbeat, the survivor mesh, resume at
    the step after the last checkpoint, and losses and final state equal
    to the uninterrupted run bit for bit."""
    ref, fl, summary, _, _ = numeric_runs[case]
    kinds = [e["event"] for e in summary["events"]]
    assert kinds == ["node_silent", "failure_detected", "elastic_resize"]
    silent, detect, resize = summary["events"]
    assert silent["t"] + 1.0 - 0.2 - 1e-6 <= detect["t"] <= silent["t"] + 1.0 + 1e-6
    assert resize["resume_step"] == 5
    assert resize["nodes"] == summary["nodes"] == {"cluster": 2, "pods": 3, "buckets": 1}[case]
    if case == "cluster":
        assert resize["mesh"] == (2, 8, 1)
    ref_losses, fl_losses = _losses(ref), _losses(fl)
    assert sorted(fl_losses) == sorted(ref_losses) == list(range(10))
    assert fl_losses == ref_losses
    assert fl.opt_state.step == ref.opt_state.step == 10
    for a, b in zip(_state_leaves(fl), _state_leaves(ref)):
        assert torch.equal(a, b)
    assert summary["sim_seconds"] > ref.runtime.clock.now
    assert not [f for (f, _), (o, i) in fl.runtime.ledger._by_flow.items() if o or i]


def test_int8_moments_resume_bit_identical(pieces, tmp_path):
    """The same with int8 moments: every moment's q and scale survive the
    checkpoint, and the re-run steps give the same bits."""
    ref = _numeric(PORT, pieces, tmp_path / "ref", moments="int8")
    ref.run(7)
    fl = _numeric(PORT, pieces, tmp_path / "fl", ("node1", 6), moments="int8")
    s = fl.run(7)
    assert s["events"][2]["resume_step"] == 5
    assert _losses(fl) == _losses(ref)
    assert isinstance(tree_leaves(fl.opt_state.m)[0], Quantized)
    for a, b in zip(_state_leaves(fl), _state_leaves(ref)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_simulated_tokens_per_s_accounts_for_lost_work(numeric_runs):
    ref, _, s_fl, _, _ = numeric_runs["cluster"]
    assert s_fl["tokens_per_s"] < 4 * 32 * 10 / ref.runtime.clock.now


def test_losses_bit_identical_across_bucket_counts(pieces):
    losses = {}
    for k in (1, 2, 4):
        c = _numeric(PORT, pieces, buckets=k, nodes=2)
        c.run(4)
        losses[k] = [h["loss"] for h in c.history]
    assert losses[2] == losses[1] and losses[4] == losses[1]


def test_skewed_shares_route_into_the_step(pieces, jax_constants):
    """``skew_batches``: the detector's shares become per-node microbatch
    counts of the torch step, as in JAX (shares equal, losses within rel
    1e-3); an equal fleet stays bit-identical to the plain path."""
    kw = dict(buckets=4, nodes=2, skew_batches=True, microbatches_per_node=2,
              node_compute_scale={"node1": 6.0})
    port, jaxc = _numeric(PORT, pieces, **kw), _numeric(JAX, pieces, **kw)
    port.run(4)
    jaxc.run(4)
    shares = [h["microbatch_shares"] for h in port.history]
    assert shares == [h["microbatch_shares"] for h in jaxc.history]
    assert any(s[0] > s[1] for s in shares) and all(sum(s) == 4 for s in shares)
    for h, j in zip(port.history, jaxc.history):
        assert abs(h["loss"] - j["loss"]) <= LOSS_REL * abs(j["loss"])
    plain = _numeric(PORT, pieces, buckets=2, nodes=2)
    plain.run(3)
    skew = _numeric(PORT, pieces, buckets=2, nodes=2, skew_batches=True,
                    microbatches_per_node=2)
    skew.run(3)
    assert all(h["microbatch_shares"] == [2, 2] for h in skew.history)
    assert [h["loss"] for h in skew.history] == [h["loss"] for h in plain.history]


# ----------------------------------------------------------------------
# the Trainer (tests/test_train.py:19,46,77,177,202)
# ----------------------------------------------------------------------

def _trainer(m, pc, **kw):
    if m is JAX:
        return j_trainer.Trainer(pc.jcfg, JRunConfig(**pc.run_kw),
                                 JShapeConfig("tiny", kind="train", **SHAPE),
                                 step_fn=pc.jstep, params=pc.jparams,
                                 opt_state=JO.adamw_init(pc.jparams), **kw)
    params = params_from_numpy(pc.np_params, device="cpu")
    return t_trainer.Trainer(pc.cfg, RunConfig(**pc.run_kw),
                             ShapeConfig("tiny", kind="train", **SHAPE),
                             step_fn=pc.steps["f32"],
                             params=params, opt_state=adamw_init(params), **kw)


def test_trainer_restart_is_bit_identical(pieces, tmp_path):
    """Checkpoints every 4 steps (one chain replica); a cold restart
    resumes after the last and replays the original's next steps bit for
    bit; every loss is JAX's Trainer's within rel 1e-3."""
    ckpt = t_ckpt.CheckpointManager(str(tmp_path / "t"), every=4, keep=2, replicas=1)
    tr = _trainer(PORT, pieces, ckpt=ckpt)
    tr.run_steps(9)
    assert t_ckpt.CheckpointManager(str(tmp_path / "t"), every=4).latest_step() == 8
    tr2 = _trainer(PORT, pieces, ckpt=ckpt)
    assert tr2.start_step == 9 and tr2.opt_state.step == 9
    tr2.run_steps(3)
    tr.run_steps(3)
    assert [h["loss"] for h in tr2.history] == [h["loss"] for h in tr.history[-3:]]
    jtr = _trainer(JAX, pieces)
    jtr.run_steps(12)
    for h, j in zip(tr.history, jtr.history):
        assert abs(h["loss"] - j["loss"]) <= LOSS_REL * abs(j["loss"]), h["step"]


def test_trainer_failure_detects_event_driven_then_recovers(pieces, tmp_path):
    ckpt = t_ckpt.CheckpointManager(str(tmp_path / "t"), every=5, keep=3)
    tr = _trainer(PORT, pieces, ckpt=ckpt, ft_timeout=1.0)
    with pytest.raises(t_manager.NodeFailure, match="failure detected"):
        tr.run_steps(20, fail_at=12)
    jtr = _trainer(JAX, pieces, ckpt=j_ckpt.CheckpointManager(str(tmp_path / "j"), every=5),
                   ft_timeout=1.0)
    with pytest.raises(j_manager.NodeFailure, match="failure detected"):
        jtr.run_steps(20, fail_at=12)
    assert tr.ft.events == jtr.ft.events
    assert [e["event"] for e in tr.ft.events] == ["node_failed"]
    assert tr.runtime.clock.now == jtr.runtime.clock.now
    assert tr.runtime.clock.now == pytest.approx(tr.ft.nodes["self"].last_heartbeat + 1.0,
                                                 rel=1e-6)
    tr2 = _trainer(PORT, pieces, ckpt=ckpt)
    assert tr2.start_step == 11
    tr2.run_steps(1)
    assert tr2.history[0]["loss"] == tr.history[11]["loss"]


def test_trainer_long_simulated_step_no_false_positive(pieces):
    kw = dict(ft_timeout=1.0)
    tr = _trainer(PORT, pieces, time_model=t_cluster.ClusterTimeModel(
        compute_s=3.0, grad_bytes=0.0, tokens_per_step=128), **kw)
    jtr = _trainer(JAX, pieces, time_model=j_cluster.ClusterTimeModel(
        compute_s=3.0, grad_bytes=0.0, tokens_per_step=128), **kw)
    for t, exc in ((tr, t_manager.NodeFailure), (jtr, j_manager.NodeFailure)):
        with pytest.raises(exc, match="failure detected"):
            t.run_steps(5, fail_at=3)
    assert tr.runtime.clock.now == jtr.runtime.clock.now > 9.0
    assert [h["sim_seconds"] for h in tr.history] == [h["sim_seconds"] for h in jtr.history]


@pytest.mark.parametrize("ckpt_every", [0, 2])
def test_trainer_runtime_mode_sim_seconds_equal_jax(pieces, jax_constants, tmp_path,
                                                    ckpt_every):
    """``sim_seconds`` and ``tokens_per_s`` equal JAX's (``==``), also on
    checkpoint steps; wall-clock seconds stay; the straggler series is
    keyed by the node name."""
    recs = []
    for m, mod in ((PORT, t_cluster), (JAX, j_cluster)):
        tm = mod.ClusterTimeModel(compute_s=0.01, grad_bytes=1e9, ckpt_bytes=4e9,
                                  ckpt_path="auto")
        ckpt = m.ckpt.CheckpointManager(str(tmp_path / m.default_fabric), every=ckpt_every) \
            if ckpt_every else None
        tr = _trainer(m, pieces, node_name="host3", time_model=tm, ckpt=ckpt)
        tr.run_steps(3)
        assert list(tr.straggler.ema) == ["host3"]
        assert all(h["seconds"] > 0 for h in tr.history)
        recs.append([(h["step"], h["sim_seconds"], h["tokens_per_s"]) for h in tr.history])
    assert recs[0] == recs[1]
    if not ckpt_every:
        assert recs[0][0][1] == pytest.approx(0.01 + 2 * (1e9 / 16e9 + 3e-6), rel=1e-3)


def test_trainer_runtime_mode_on_h100_constants(pieces):
    tr = _trainer(PORT, pieces, time_model=t_cluster.ClusterTimeModel(
        compute_s=0.01, grad_bytes=1e9))
    tr.run_steps(1)
    assert tr.history[0]["sim_seconds"] == pytest.approx(
        0.01 + 2 * (1e9 / t_hw.PCIE_BW + t_hw.PCIE_LAT), rel=1e-3)


def test_trainer_wall_clock_mode_unchanged(pieces):
    tr = _trainer(PORT, pieces)
    tr.run_steps(2)
    assert "sim_seconds" not in tr.history[-1] and tr.runtime is None
    assert list(tr.straggler.ema) == ["self"]


# ----------------------------------------------------------------------
# the launcher
# ----------------------------------------------------------------------

SIMULATE_ARGV = {
    "linefs": ["--reduced", "--steps", "12", "--simulate", "4", "--fabric", "linefs",
               "--ckpt-staging", "auto", "--ckpt-every", "4", "--host-load", "node0:0.85",
               "--fail", "node1:8"],
    "buckets": ["--steps", "3", "--simulate", "2", "--buckets", "4", "--weighted-buckets",
                "--ckpt-every", "0"],
    "pods": ["--reduced", "--steps", "3", "--simulate", "8", "--pods", "4", "--pod-sync",
             "compressed", "--ckpt-every", "0", "--trunk-bw", "25e9"],
    "soc-compress": ["--steps", "6", "--simulate", "3", "--ckpt-staging", "soc-compress",
                     "--ckpt-every", "2", "--batch", "16", "--seq", "2048"],
}


@pytest.mark.parametrize("case", SIMULATE_ARGV)
def test_launcher_simulate_prints_jax_numbers(case, jax_constants, tmp_path):
    """``--simulate`` under the JAX package's constants prints the JAX
    launcher's lines (the default fabric's name aside), and its Chrome
    trace is the JAX launcher's."""
    outs, traces = [], []
    for m, main in ((JAX, j_launch.main), (PORT, t_launch.main)):
        trace = tmp_path / f"{m.default_fabric}.json"
        argv = ["--arch", "internlm2-1.8b", *SIMULATE_ARGV[case], "--trace", str(trace)]
        if "--fabric" not in argv:
            argv += ["--fabric", m.default_fabric]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        outs.append(buf.getvalue().replace("fabric=v5e", "fabric=h100")
                    .replace(str(trace), "TRACE"))
        traces.append(json.loads(trace.read_text()))
    assert outs[1] == outs[0]
    assert traces[1] == traces[0]
    assert "[simulate]" in outs[1] and "tokens/s" in outs[1]


def test_launcher_simulate_does_no_torch_work(monkeypatch, capsys):
    def refuse(*a, **k):
        raise AssertionError("--simulate built a model")
    monkeypatch.setattr(t_launch, "init_params", refuse)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cluster = t_launch.main(["--arch", "internlm2-1.8b", "--reduced", "--steps", "3",
                             "--simulate", "8", "--pods", "4", "--ckpt-every", "0"])
    out = capsys.readouterr().out
    assert "fabric=h100" in out and "pods=4x8 pod_sync=auto" in out
    assert "reserved after run = 0" in out and cluster.topology.total_nodes == 32


def test_launcher_checkpoints_and_resumes(tmp_path, capsys):
    """Local mode with ``--ckpt-dir``: 5 steps checkpointed every 2 (steps
    2 and 4 kept); with step 4's checkpoint gone, a second launch resumes
    after step 2 and gives the first launch's losses of steps 3 and 4 bit
    for bit; ``--log`` holds every record of the second launch."""
    ckpt_dir = tmp_path / "ck"
    base = ["--arch", "internlm2-1.8b", "--reduced", "--device", "cpu", "--batch", "4",
            "--seq", "32", "--steps", "5", "--ckpt-every", "2", "--moments-int8",
            "--ckpt-dir", str(ckpt_dir)]
    whole = t_launch.main(base)
    assert sorted(p.name for p in ckpt_dir.iterdir()) == ["step_00000002",
                                                          "step_00000004"]
    shutil.rmtree(ckpt_dir / "step_00000004")
    capsys.readouterr()
    log = tmp_path / "log.jsonl"
    again = t_launch.main(base + ["--log", str(log)])
    out = capsys.readouterr().out
    assert "resumed from the checkpoint of step 2" in out and out.count("[train] step") == 2
    assert again.start_step == 5 and [h["step"] for h in again.history] == [3, 4]
    assert [h["loss"] for h in again.history] == [h["loss"] for h in whole.history[3:]]
    assert [json.loads(line)["step"] for line in log.read_text().splitlines()] == [3, 4]
    done = t_launch.main(base)
    assert done.history == [] and "nothing to do" in capsys.readouterr().out


def test_launcher_refuses_multi_device_options(tmp_path):
    """The multi-device options are ported: ``--multi-pod`` refuses only a
    world of no ranks, and ``--pod-sync compressed`` without a pod axis
    (one process) is the plain step, as in JAX."""
    base = ["--arch", "internlm2-1.8b", "--reduced", "--device", "cpu", "--steps", "1"]
    with pytest.raises(ValueError, match="--ranks"):
        t_launch.main(base + ["--multi-pod", "--ranks", "0"])
    assert t_launch.main(base + ["--pod-sync", "compressed"]).history[0]["loss"] == \
        t_launch.main(base).history[0]["loss"]
