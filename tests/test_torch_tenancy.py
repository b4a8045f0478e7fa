"""The port's serve+train colocation (QoS weights, the SLO admission
controller, occupancy attribution) against the JAX package's, on the CPU.

The scenarios are those of ``tests/test_tenancy.py``: solo serve, solo
train, unmanaged (equal shares), managed (QoS 16:1 + SLO = 1.2 x solo
p99 TTFT), the occupancy-limit controller on ``host:0``, and the
launcher's headline (both). Each runs once through ``repro.tenancy``
with a JAX engine (``impl="ref"``) and once through ``repro_torch.tenancy``
with the port's engine (``impl="auto"`` on CPU tensors: the plain
versions) on params bridged from the JAX ones, with the port's
``core/hw.py`` set to the JAX package's constants (``jax_constants``).
Simulated time depends on prompt lengths and token counts only, so
every ``InterferenceReport`` must equal JAX's with ``==``. Tokens follow
``tests/test_torch_staged.py::_tokens_agree`` against JAX's and must be
identical to the port's solo run.

The numeric train tenant is the torch step on reduced internlm2 (4 x 32
tokens, ``tests/test_torch_cluster.py``'s pieces): colocated losses and
final params and moments equal the solo run's bit for bit across every
throttle and resume, and the losses are JAX's within ``LOSS_REL``.
Last, the check ``chip_smoke.py``'s colocate phase makes on the card,
here at reduced size: each real-compute run's report equals its
``compute="sim"`` twin's."""
import contextlib
import dataclasses
import io
import json
import types

import numpy as np
import pytest
import torch

import repro.core.fabric as j_fabric
import repro.core.hw as j_hw
import repro.core.runtime as j_runtime
import repro.launch.colocate as j_launch
import repro.serve.disagg as j_disagg
import repro.serve.engine as j_engine
import repro.tenancy as j_tenancy
import repro.train.cluster as j_cluster
import repro_torch.core.fabric as t_fabric
import repro_torch.core.hw as t_hw
import repro_torch.core.runtime as t_runtime
import repro_torch.launch.colocate as t_launch
import repro_torch.serve.disagg as t_disagg
import repro_torch.serve.engine as t_engine
import repro_torch.tenancy as t_tenancy
import repro_torch.tenancy.colocation as t_colocation
import repro_torch.train.cluster as t_cluster
from repro.optim import adamw as JO
from repro_torch.bridge import params_from_numpy
from repro_torch.optim.adamw import adamw_init, tree_leaves
from test_torch_cluster import HW_NAMES, LOSS_REL, _state_leaves, pieces  # noqa: F401
from test_torch_staged import _tokens_agree

JAX = types.SimpleNamespace(tenancy=j_tenancy, engine=j_engine, cluster=j_cluster,
                            runtime=j_runtime, fabric=j_fabric, disagg=j_disagg, name="jax")
PORT = types.SimpleNamespace(tenancy=t_tenancy, engine=t_engine, cluster=t_cluster,
                             runtime=t_runtime, fabric=t_fabric, disagg=t_disagg, name="port")
TRAIN_STEPS, N_REQS = 4, 8
OUT, IN = "out", "in"


def _patch_jax_constants(mp):
    """The port's ``core/hw.py`` set to the JAX package's constants, and
    the keyword defaults ``colocation_fabric`` bound from it at import."""
    for name in HW_NAMES:
        mp.setattr(t_hw, name, getattr(j_hw, name))
    mp.setitem(t_colocation.colocation_fabric.__kwdefaults__, "host_bw", j_hw.PCIE_BW)
    mp.setitem(t_colocation.colocation_fabric.__kwdefaults__, "net_bw_per_node",
               j_hw.DCN_BW_PER_CHIP)


@pytest.fixture
def jax_constants(monkeypatch):
    _patch_jax_constants(monkeypatch)


@contextlib.contextmanager
def jax_constants_for_module():
    mp = pytest.MonkeyPatch()
    try:
        _patch_jax_constants(mp)
        yield
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def lm(pieces):  # noqa: F811
    """(cfg, JAX cfg, JAX params, bridged params) of reduced internlm2."""
    return (pieces.cfg, pieces.jcfg, pieces.jparams,
            params_from_numpy(pieces.np_params, device="cpu"))


# tests/test_tenancy.py:290-320: the fabric, the time models, the requests
def _fabric(m):
    return m.tenancy.colocation_fabric(2, host_bw=16.0, soc_frac=0.7, net_bw_per_node=100.0,
                                       decode_bw=64.0, concurrency_discount=0.1)


def _cluster_tm(m):
    return m.cluster.ClusterTimeModel(compute_s=0.3, grad_bytes=16.0, ckpt_bytes=8.0,
                                      ckpt_path="soc", tokens_per_step=1024)


def _make_engine(m, lm, compute="torch"):
    cfg, jcfg, jparams, tparams = lm
    tm = m.tenancy.colocation_time_model(0, prefill_units_per_token=0.25,
                                         decode_units_per_slot=0.25)

    def make(rt):
        if compute == "sim":
            return m.engine.StagedServeEngine(None, None, compute="sim", slots=2, max_len=64,
                                              runtime=rt, time_model=tm,
                                              tenant=m.tenancy.SERVE)
        if m is JAX:
            return m.engine.StagedServeEngine(jcfg, jparams, slots=2, max_len=64, impl="ref",
                                              runtime=rt, time_model=tm,
                                              tenant=m.tenancy.SERVE)
        return m.engine.StagedServeEngine(cfg, tparams, slots=2, max_len=64, impl="auto",
                                          runtime=rt, time_model=tm, tenant=m.tenancy.SERVE,
                                          device="cpu")
    return make


def _make_cluster(m, numeric=None, built=None):
    def make(rt):
        kw = numeric() if numeric is not None else {}
        c = m.cluster.TrainCluster(2, _cluster_tm(m), fabric=rt.fabric, runtime=rt,
                                   ckpt_every=2, tenant=m.tenancy.TRAIN, **kw)
        if built is not None:
            built.append(c)
        return c
    return make


def _requests(m, cfg, spacing=0.3):
    rng = np.random.default_rng(7)
    return [m.engine.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                             max_new_tokens=4, arrival=spacing * i)
            for i in range(N_REQS)]


def _harness(m, run, make_engine, make_cluster, solo_p99):
    T = m.tenancy
    kw = {"unmanaged": {},
          "managed": dict(qos=T.QoSPolicy.serve_train(16.0, 1.0),
                          admission=T.AdmissionConfig(slo_ttft=1.2 * solo_p99)),
          "occupancy_limit": dict(admission=T.AdmissionConfig(
              slo_ttft=1.2 * solo_p99, occupancy_limit=0.4, watch_paths=("host:0",))),
          "headline": dict(qos=T.QoSPolicy.serve_train(16.0, 1.0),
                           admission=T.AdmissionConfig(
                               slo_ttft=1.2 * solo_p99, occupancy_limit=0.4,
                               watch_paths=("host:0",)))}[run]
    return T.Colocation(fabric=_fabric(m), make_engine=make_engine,
                        make_cluster=make_cluster, **kw)


COLOCATED = ("unmanaged", "managed", "occupancy_limit", "headline")


def _sweep(m, lm, *, compute="torch", numeric=None):
    """Solo serve, solo train and the four colocated runs of one package."""
    cfg = lm[0]
    make_engine = _make_engine(m, lm, compute)
    built = []
    make_cluster = _make_cluster(m, numeric, built)
    out = {"requests": {}, "harness": {}}
    solo_reqs = _requests(m, cfg)
    out["solo_serve"] = m.tenancy.solo_serve(_fabric(m), make_engine, solo_reqs)
    out["requests"]["solo"] = solo_reqs
    out["solo_train"] = m.tenancy.solo_train(_fabric(m), make_cluster, TRAIN_STEPS)
    out["solo_cluster"] = built[-1]
    for run in COLOCATED:
        h = _harness(m, run, make_engine, make_cluster, out["solo_serve"]["p99_ttft"])
        reqs = _requests(m, cfg)
        out[run] = h.run(reqs, TRAIN_STEPS)
        out["requests"][run], out["harness"][run] = reqs, h
    return out


@pytest.fixture(scope="module")
def runs(lm):
    """Both packages' sweeps with real compute and a timing-only train
    tenant, under the JAX package's constants."""
    with jax_constants_for_module():
        return {"jax": _sweep(JAX, lm), "port": _sweep(PORT, lm)}


def _report(rep):
    return rep if isinstance(rep, dict) else rep.to_dict()


@pytest.mark.parametrize("run", ("solo_serve", "solo_train") + COLOCATED)
def test_report_equals_jax(runs, run):
    """Every simulated figure of the run: TTFTs, tokens/s, the train
    summary, the occupancy attribution, events and throttles."""
    want, got = _report(runs["jax"][run]), _report(runs["port"][run])
    assert got == want
    assert repr(got) == repr(want)          # bit for bit, not only by value


@pytest.mark.parametrize("run", COLOCATED)
def test_placement_ledger_equals_jax(runs, run, jax_constants):
    """``InterferenceReport.placement_ledger``: the other tenants' measured
    occupancy as reservations on the colocation fabric, and the tenant-
    aware decode placement it feeds on the §5.2 fabric."""
    got = []
    for m in (JAX, PORT):
        rep = runs[m.name][run]
        led = rep.placement_ledger(_fabric(m), tenant=m.tenancy.SERVE)
        plan = m.disagg.plan_decode_placement(m.disagg.kv_fabric(), occupancy={
            "soc_read": rep.occupancy["host:0"]}, tenant=m.tenancy.SERVE)
        got.append((sorted(led._by_flow.items()), plan.location, plan.rate,
                    [dataclasses.astuple(a) for a in plan.allocations]))
    assert got[1] == got[0]


@pytest.mark.parametrize("run", COLOCATED)
def test_colocated_tokens_equal_solo_and_agree_with_jax(runs, run, lm):
    """Contention moves TTFT, never the sampled token: the port's
    colocated tokens are its solo tokens, and JAX's by the rule."""
    port, jax_ = runs["port"]["requests"], runs["jax"]["requests"]
    solo = {r.rid: r.out_tokens for r in port["solo"]}
    for r in port[run]:
        assert r.done and r.out_tokens == solo[r.rid], r.rid
    _tokens_agree(lm, jax_[run], port[run])


def test_unmanaged_blows_p99_managed_holds_slo(runs):
    """tests/test_tenancy.py:330's crossover, on the port."""
    r = runs["port"]
    solo_p99 = r["solo_serve"]["p99_ttft"]
    assert r["unmanaged"].serve["p99_ttft"] > 2.0 * solo_p99
    assert r["managed"].serve["p99_ttft"] <= 1.2 * solo_p99
    assert r["managed"].train["tokens_per_s"] >= 0.8 * r["solo_train"]["tokens_per_s"]
    for key in COLOCATED:
        assert r[key].serve["requests"] == N_REQS
        assert r[key].train["steps"] == TRAIN_STEPS


def test_occupancy_attribution_sees_both_tenants(runs):
    occ = runs["port"]["managed"].occupancy
    assert "serve" in occ["host:0"] and "train" in occ["host:0"]
    assert occ["host:0"]["train"] > occ["host:0"]["serve"] > 0.0
    assert set(occ["serve:decode"]) == {"serve"}
    assert "train" in occ["net"] and "serve" not in occ["net"]


def _clean_ledger(runtime):
    led = runtime.ledger
    for name in runtime.fabric:
        for direction in (OUT, IN):
            assert led.reserved(name, direction) == pytest.approx(0.0, abs=1e-6), \
                (name, direction)
    assert not {flow for (flow, _), (o, i) in led._by_flow.items() if o > 0 or i > 0}


@pytest.mark.parametrize("run", ("occupancy_limit", "headline"))
def test_admission_throttles_and_leaves_a_clean_ledger(runs, run):
    """tests/test_tenancy.py:461 on the port: pause/resume cycles happen,
    every deferred transfer is re-issued, the serve tail beats unmanaged,
    and every (path, direction) of the shared ledger is back at zero."""
    r = runs["port"]
    report = r[run]
    assert report.throttles > 0
    kinds = [e["event"] for e in report.events]
    assert "throttle" in kinds and "resume" in kinds
    assert "transfers_paused" in kinds and "transfers_resumed" in kinds
    assert report.train["steps"] == TRAIN_STEPS
    assert report.serve["p99_ttft"] <= 1.3 * r["solo_serve"]["p99_ttft"]
    _clean_ledger(r["harness"][run].runtime)


# ----------------------------------------------------------------------
# the numeric train tenant, and the real-compute run against its sim twin
# ----------------------------------------------------------------------

def _numeric(m, pc, moments="f32"):
    """A fresh numeric stream per cluster (the port's step updates params
    and moments in place)."""
    def make():
        if m is JAX:
            return dict(step_fn=pc.jstep, params=pc.jparams,
                        opt_state=JO.adamw_init(pc.jparams), batch_at=pc.jpipe.batch_at)
        params = params_from_numpy(pc.np_params, device="cpu")
        return dict(step_fn=pc.steps[moments], params=params,
                    opt_state=adamw_init(params, moments=moments),
                    batch_at=lambda s: {k: torch.from_numpy(v)
                                        for k, v in pc.tpipe.batch_at(s).items()})
    return make


@pytest.fixture(scope="module")
def numeric_runs(lm, pieces):  # noqa: F811
    """The port's sweep with the numeric train tenant (f32 and int8
    moments) and real serve compute, its sim twin (``compute="sim"``
    engine, timing-only cluster), and JAX's numeric solo train run."""
    with jax_constants_for_module():
        out = {moments: _sweep(PORT, lm, numeric=_numeric(PORT, pieces, moments))
               for moments in ("f32", "int8")}
        out["sim"] = _sweep(PORT, lm, compute="sim")
        cluster = _make_cluster(JAX, _numeric(JAX, pieces))(
            j_runtime.FabricRuntime(_fabric(JAX)))
        cluster.run(TRAIN_STEPS)
        out["jax_losses"] = {h["step"]: h["loss"] for h in cluster.history}
    return out


def _losses(cluster):
    return {h["step"]: h["loss"] for h in cluster.history}


@pytest.mark.parametrize("moments", ("f32", "int8"))
def test_colocated_losses_bit_identical_to_solo(numeric_runs, moments):
    """Colocation moves *when* a step's transfers happen, never *what*
    the step computes: losses, params, moments and scales bit-equal to
    the solo run's, across the managed runs' throttles and resumes."""
    r = numeric_runs[moments]
    solo = r["solo_cluster"]
    assert sorted(_losses(solo)) == list(range(TRAIN_STEPS))
    for run in COLOCATED:
        cluster = r["harness"][run].cluster
        assert _losses(cluster) == _losses(solo), run
        assert cluster.opt_state.step == solo.opt_state.step == TRAIN_STEPS
        for a, b in zip(_state_leaves(cluster), _state_leaves(solo)):
            assert a.dtype == b.dtype and torch.equal(a, b), run
    assert r["occupancy_limit"].throttles > 0 and r["headline"].throttles > 0
    if moments == "f32":
        for step, loss in _losses(solo).items():
            jloss = numeric_runs["jax_losses"][step]
            assert abs(loss - jloss) <= LOSS_REL * abs(jloss), step
    else:
        assert all(leaf.q.dtype == torch.int8 for leaf in tree_leaves(solo.opt_state.m))


def _without_losses(rep):
    rep = _report(rep)
    if "train" in rep:
        return {**rep, "train": {k: v for k, v in rep["train"].items() if k != "loss"}}
    return {k: v for k, v in rep.items() if k != "loss"}


@pytest.mark.parametrize("run", ("solo_serve", "solo_train") + COLOCATED)
def test_real_compute_report_equals_sim_twin(numeric_runs, runs, run):
    """``chip_smoke.py``'s colocate check 1 at reduced size: compute moves
    nothing on the simulated clock (no EOS; the cluster's timing is the
    time model's), so the real-compute report equals the sim twin's and
    the timing-only JAX run's; the serve tokens equal the solo run's."""
    want = _without_losses(numeric_runs["sim"][run])
    for moments in ("f32", "int8"):
        assert _without_losses(numeric_runs[moments][run]) == want, moments
    assert _without_losses(runs["jax"][run]) == want
    if run in COLOCATED:
        solo = {q.rid: q.out_tokens for q in numeric_runs["int8"]["requests"]["solo"]}
        assert {q.rid: q.out_tokens for q in numeric_runs["int8"]["requests"][run]} == solo


# ----------------------------------------------------------------------
# weighted fair sharing and QoS (tests/test_tenancy.py:38-170)
# ----------------------------------------------------------------------

def _rt(m, cap=100.0, disc=0.0, qos=None):
    return m.runtime.FabricRuntime(m.fabric.Fabric.of(m.fabric.Path("link", cap),
                                                      concurrency_discount=disc), qos=qos)


def weighted_shares(m):                                        # :38
    qos = m.tenancy.QoSPolicy([m.tenancy.Tenant("hi", weight=3.0),
                               m.tenancy.Tenant("lo", weight=1.0)])
    rt = _rt(m, 100.0, 0.1, qos)
    t1 = rt.transfer("link", 90.0, tenant="hi")
    t2 = rt.transfer("link", 90.0, tenant="lo")
    seen = {}
    rt.clock.schedule(0.1, lambda: seen.update(hi=t1.rate, lo=t2.rate))
    rt.clock.run()
    assert seen["hi"] == pytest.approx(3 * seen["lo"])
    return sorted(seen.items()), t1.finished_at, t2.finished_at, rt.ledger.reserved("link", OUT)


def rebalance_on_cancel(m):                                    # :71
    qos = m.tenancy.QoSPolicy([m.tenancy.Tenant("hi", weight=4.0),
                               m.tenancy.Tenant("lo", weight=1.0)])
    rt = _rt(m, 100.0, 0.0, qos)
    t_hi = rt.transfer("link", 100.0, tenant="hi")
    t_lo = rt.transfer("link", 100.0, tenant="lo")
    rt.clock.schedule(0.5, lambda: rt.cancel(t_hi))
    rt.clock.run()
    assert t_lo.finished_at == pytest.approx(0.5 + 90.0 / 100.0)
    return t_hi.canceled, t_hi.remaining, t_lo.finished_at, rt.ledger.reserved("link", OUT)


def max_rate_surplus(m):                                       # :87
    qos = m.tenancy.QoSPolicy([m.tenancy.Tenant("hi", weight=9.0),
                               m.tenancy.Tenant("lo", weight=1.0)])
    rt = _rt(m, 100.0, 0.0, qos)
    hi = rt.transfer("link", 10.0, tenant="hi", max_rate=10.0)
    lo = rt.transfer("link", 90.0, tenant="lo")
    box = {}
    rt.clock.schedule(0.1, lambda: box.update(hi=hi.rate, lo=lo.rate))
    rt.clock.run()
    assert box["lo"] == pytest.approx(90.0)
    return sorted(box.items()), hi.finished_at, lo.finished_at


def conserve_sweep(m):                                         # :135
    out = []
    for weights, amounts, disc in [((1.0, 1.0, 1.0), (30.0, 20.0, 10.0), 0.0),
                                   ((5.0, 1.0), (100.0, 100.0), 0.125),
                                   ((2.0, 3.0, 7.0, 0.5), (10.0, 40.0, 25.0, 5.0), 0.2),
                                   ((8.0,), (50.0,), 0.3)]:
        qos = m.tenancy.QoSPolicy([m.tenancy.Tenant(f"t{i}", weight=w)
                                   for i, w in enumerate(weights)])
        rt = _rt(m, 100.0, disc, qos)
        ts = [rt.transfer("link", a, tenant=f"t{i}") for i, a in enumerate(amounts)]
        probes = []
        rt.clock.schedule(1e-3, lambda: probes.append(
            (sum(t.rate for t in ts if not t.done), rt.ledger.reserved("link", OUT))))
        rt.clock.run()
        assert probes[0][0] == pytest.approx(probes[0][1])
        out.append((probes, [t.finished_at for t in ts], rt.ledger.reserved("link", OUT)))
    return out


def qos_policy(m):                                             # :157
    T = m.tenancy
    errs = []
    for fn in (lambda: T.Tenant("x", weight=0.0), lambda: T.Tenant("x", tenant_class="batch"),
               lambda: T.QoSPolicy([T.Tenant("a"), T.Tenant("a")])):
        try:
            fn()
        except ValueError as e:
            errs.append(str(e))
    pol = T.QoSPolicy.serve_train(8.0, 2.0)
    assert len(errs) == 3 and pol.weight(T.SERVE) == 8.0
    return (errs, pol.weight(T.SERVE), pol.weight(T.TRAIN), pol.weight("stranger"),
            pol.weight(None), pol.tenant_class(T.SERVE), T.LATENCY, T.THROUGHPUT,
            [dataclasses.astuple(t) for t in T.QoSPolicy.serve_train_offload()],
            repr(T.QoSPolicy.serve_train()))


def admission_config(m):                                       # admission.py's own checks
    T = m.tenancy
    cfg = T.AdmissionConfig(slo_ttft=0.5, occupancy_limit=0.4, watch_paths=("host:0",))
    return (dataclasses.astuple(cfg), T.percentile([0.3, 0.1, 0.2, 0.5], 50),
            T.percentile([0.3, 0.1, 0.2, 0.5], 99), T.percentile([1.0], 99))


QOS_SCENARIOS = [weighted_shares, rebalance_on_cancel, max_rate_surplus, conserve_sweep,
                 qos_policy, admission_config]


@pytest.mark.parametrize("scenario", QOS_SCENARIOS, ids=lambda f: f.__name__)
def test_qos_port_equals_jax(scenario):
    want, got = scenario(JAX), scenario(PORT)
    assert got == want
    assert repr(got) == repr(want)


# ----------------------------------------------------------------------
# the launcher
# ----------------------------------------------------------------------

LAUNCH_ARGV = {
    "headline": ["--requests", "8", "--train-steps", "4", "--serve-weight", "16",
                 "--slo-factor", "1.2", "--occupancy-limit", "0.4"],
    "defaults": [],
    "unmanaged-trace": ["--mode", "unmanaged", "--requests", "6", "--train-steps", "3",
                        "--trace", "TRACE"],
}


@pytest.mark.parametrize("case", LAUNCH_ARGV)
def test_colocate_launcher_prints_jax_lines(case, jax_constants, tmp_path):
    """``launch/colocate --reduced --device cpu`` prints the JAX launcher's
    lines (and writes its Chrome trace) under the JAX package's
    constants."""
    outs, traces = [], []
    for name, main, extra in (("jax", j_launch.main, []),
                              ("port", t_launch.main, ["--device", "cpu"])):
        trace = tmp_path / f"{name}.json"
        argv = ["--reduced", *[str(trace) if a == "TRACE" else a
                               for a in LAUNCH_ARGV[case]], *extra]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        outs.append(buf.getvalue().replace(str(trace), "TRACE"))
        if trace.exists():
            traces.append(json.loads(trace.read_text()))
    assert outs[1] == outs[0]
    assert traces[1:] == traces[:1]
    assert "[solo]" in outs[1] and "throttles=" in outs[1]


def test_colocate_launcher_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_launch.main(["--reduced", "--mode", "solo"])
