"""The port's SLO fleet, decode autoscaler and K-tenant admission
arbitration against the JAX package's, on the CPU.

Every scenario is a function of a module set: it runs once through
``repro.scale`` / ``repro.tenancy`` and once through their
``repro_torch`` copies, keeps the assertions of the JAX test it comes
from (``tests/test_scale.py:186-391``), and returns what it measured:
fleet reports, scale and admission events, served token streams, ledger
reservations and placement plans. The two results must be equal with
``==``. The fleet engines are ``compute="sim"`` in both packages, so
there is no model here; the launcher ``launch/fleet.py`` must print the
JAX launcher's lines. The fleet fabric's latencies are ``core/hw.py``'s,
so the port runs under the JAX package's constants here
(``jax_constants``)."""
import contextlib
import dataclasses
import io
import types

import pytest

import repro.core.fabric as j_fabric
import repro.core.runtime as j_runtime
import repro.launch.fleet as j_launch
import repro.scale as j_scale
import repro.serve.disagg as j_disagg
import repro.serve.engine as j_engine
import repro.tenancy as j_tenancy
import repro_torch.core.fabric as t_fabric
import repro_torch.core.runtime as t_runtime
import repro_torch.launch.fleet as t_launch
import repro_torch.scale as t_scale
import repro_torch.serve.disagg as t_disagg
import repro_torch.serve.engine as t_engine
import repro_torch.tenancy as t_tenancy
from test_torch_tenancy import jax_constants  # noqa: F401

JAX = types.SimpleNamespace(fabric=j_fabric, runtime=j_runtime, scale=j_scale,
                            disagg=j_disagg, engine=j_engine, tenancy=j_tenancy)
PORT = types.SimpleNamespace(fabric=t_fabric, runtime=t_runtime, scale=t_scale,
                             disagg=t_disagg, engine=t_engine, tenancy=t_tenancy)
OUT, IN = "out", "in"


def _raises(fn):
    try:
        fn()
    except Exception as e:          # the exception's type and text are the result
        return type(e).__name__, str(e)
    return None


def _served(fleet):
    return {name: [(r.rid, r.arrival, r.first_token_time, r.finish_time,
                    list(r.out_tokens)) for r in reqs]
            for name, reqs in sorted(fleet.served.items())}


def _drained(fleet):
    return all(fleet.runtime.ledger.reserved(p, d) == pytest.approx(0.0, abs=1e-6)
               for p in fleet.runtime.fabric for d in (OUT, IN))


# -- tests/test_scale.py:186-391 -----------------------------------------

def replica_pool_inventory(m):                                 # :186
    pool = m.scale.ReplicaPool(["a", "b"])
    seen = [pool.capacity, pool.free, pool.acquire(), pool.acquire(), pool.acquire()]
    assert seen == [2, 2, "a", "b", None]
    pool.release("a")
    seen.append(_raises(lambda: pool.release("a")))
    assert seen[-1][0] == "ValueError"
    seen.append(pool.acquire())
    return seen


def autoscale_config_validation(m):                            # :197
    S = m.scale
    seen = [_raises(lambda: S.AutoscaleConfig(target_attainment=0.0)),
            _raises(lambda: S.AutoscaleConfig(window_s=0.0)),
            _raises(lambda: S.AutoscaleConfig(max_replicas=0)),
            S.ttft_attainment([], 0.5), S.ttft_attainment([0.1, 0.9], 0.5),
            dataclasses.astuple(S.AutoscaleConfig())]
    assert all(r[0] == "ValueError" for r in seen[:3]) and seen[3:5] == [1.0, 0.5]
    return seen


def no_flapping_on_steady_load(m):                             # :209
    spec = m.scale.FleetTenantSpec(
        name="steady",
        trace=m.scale.TraceSpec(name="flat", base_rate=2.0, duration=40.0,
                                diurnal_amplitude=0.1, diurnal_period=40.0),
        slo_ttft=0.5, weight=4.0, seed=2)
    fleet = m.scale.ServeFleet([spec], host_bw=1400.0)
    rep = fleet.run(autoscale=True, max_sim_seconds=500.0)
    tr = rep.tenants["steady"]
    assert tr.scale_events == [] and tr.autoscaler_events == []
    assert tr.attainment == 1.0
    return rep.to_dict(), _served(fleet)


def scales_out_then_back_in(m):                                # :223
    fleet = m.scale.headline_fleet()
    rep = fleet.run(autoscale=True, max_sim_seconds=2000.0)
    ev = rep.tenants["premium"].scale_events
    outs = [e for e in ev if e["event"] == "scale_out"]
    ins = [e for e in ev if e["event"] == "scale_in"]
    assert len(outs) >= 1 and len(ins) >= 1 and len(ev) <= 20
    assert rep.tenants["premium"].peak_replicas >= 2
    assert fleet.pool.free == fleet.pool.capacity
    return rep.to_dict(), _served(fleet)


def headline_static_vs_autoscaled(m):                          # :239
    runs = {}
    for mode in (False, True):
        fleet = m.scale.headline_fleet()
        runs[mode] = (fleet, fleet.run(autoscale=mode, max_sim_seconds=2000.0))
    static, auto = runs[False][1], runs[True][1]
    assert static.attainment("premium") < 0.70
    assert auto.attainment("premium") >= 0.95
    for name in ("premium", "standard"):
        a = {r.rid: list(r.out_tokens) for r in runs[False][0].served[name]}
        b = {r.rid: list(r.out_tokens) for r in runs[True][0].served[name]}
        assert a == b and len(a) > 0
    assert all(_drained(fleet) for fleet, _ in runs.values())
    return [(rep.to_dict(), rep.attainment("premium"), _served(fleet))
            for fleet, rep in runs.values()]


class _FakeEngine:
    def __init__(self):
        self.ttft_log = []
        self.prefill_backlog = 0


def fleet_admission_priority_order(m):                         # :270
    rt = m.runtime.FabricRuntime(m.fabric.Fabric.of(m.fabric.Path("p", 1.0)))
    top = _FakeEngine()
    log = []
    AT = m.tenancy.AdmittedTenant
    tenants = [
        AT(name="low", priority=0, pause=lambda: log.append("pause:low"),
           resume=lambda: log.append("resume:low")),
        AT(name="mid", priority=1, pause=lambda: log.append("pause:mid"),
           resume=lambda: log.append("resume:mid")),
        AT(name="top", priority=2, slo_ttft=0.1, engine=top),
    ]
    ctl = m.tenancy.FleetAdmissionController(rt, tenants, check_every=0.01).start()
    top.prefill_backlog = 1
    top.ttft_log.append((0.0, 0.5))
    rt.clock.at(0.05, lambda: setattr(top, "prefill_backlog", 0))
    rt.clock.run(until=0.2)
    ctl.stop()
    assert log == ["pause:low", "pause:mid", "resume:mid", "resume:low"]
    assert [e["event"] for e in ctl.events] == ["throttle", "throttle", "resume", "resume"]
    assert ctl.paused_tenants == []
    return log, ctl.events, rt.clock.now


def arbitration_defers_without_loss(m):                        # :296
    S = m.scale
    specs = [
        S.FleetTenantSpec(
            name="premium",
            trace=S.burst_trace(base_rate=2.0, duration=40.0, burst_multiplier=10.0,
                                burst_start=8.0, burst_duration=16.0,
                                diurnal_amplitude=0.25),
            slo_ttft=0.4, weight=8.0, priority=1, seed=7),
        S.FleetTenantSpec(
            name="standard",
            trace=S.TraceSpec(name="steady", base_rate=2.0, duration=40.0,
                              diurnal_amplitude=0.25, diurnal_period=40.0),
            slo_ttft=2.0, weight=1.0, priority=0, seed=11),
    ]
    fleet = S.ServeFleet(specs, host_bw=1400.0, arbitration=True)
    rep = fleet.run(autoscale=False, max_sim_seconds=2000.0)
    throttles = [e for e in rep.admission_events if e["event"] == "throttle"]
    assert throttles and all(e["victim"] == "standard" and e["offender"] == "premium"
                             for e in throttles)
    assert any(e["event"] == "resume" for e in rep.admission_events)
    expected = len(S.ArrivalGenerator(specs[1].trace, seed=11).requests())
    served = fleet.served["standard"]
    assert len(served) == expected > 0
    for r in served:
        assert list(r.out_tokens) == [m.engine._EngineCore._sim_token(r.rid, i)
                                      for i in range(len(r.out_tokens))]
    return rep.to_dict(), _served(fleet)


def _plan(p):
    return (p.location, p.rate, p.baseline_rate, p.hit_mass,
            [dataclasses.astuple(a) for a in p.allocations])


def placement_flips_on_other_tenants_occupancy(m):             # :335
    fabric = m.disagg.kv_fabric()
    fresh = m.disagg.plan_decode_placement(fabric)
    assert fresh.location == "soc_cache"
    plan = m.disagg.plan_decode_placement(fabric, occupancy={"soc_read": {"train": 0.97}},
                                          tenant="serve")
    assert plan.location == "host" and plan.rate < fresh.rate
    plan2 = m.disagg.plan_decode_placement(fabric, occupancy={"soc_read": {"serve": 0.97}},
                                           tenant="serve")
    assert plan2.location == "soc_cache" and plan2.rate == pytest.approx(fresh.rate)
    return [_plan(p) for p in (fresh, plan, plan2)]


def occupancy_ledger_clamps_and_skips(m):                      # :353
    fabric = m.fabric.Fabric.of(m.fabric.Path("a", 100.0), m.fabric.Path("b", 10.0))
    led = m.tenancy.occupancy_ledger(
        fabric, {"a": {"t1": 0.6, "t2": 0.8}, "missing": {"t1": 1.0}, "b": {"me": 0.5}},
        exclude=("me",))
    assert led.reserved("a", OUT) == pytest.approx(100.0)
    assert led.reserved("b", OUT) == pytest.approx(0.0)
    return sorted(led._by_flow.items()), [led.reserved(p, d) for p in "ab" for d in (OUT, IN)]


def fleet_fabric_and_validation(m):                            # fleet.py's own checks
    S = m.scale
    fab = S.fleet_fabric(host_bw=1400.0, replica_bw=400.0, replicas=3)
    spec = S.headline_specs(duration=10.0)[0]
    return ([dataclasses.astuple(fab[p]) for p in fab], fab.concurrency_discount,
            S.replica_paths_of(fab), dataclasses.astuple(spec.tenant()),
            _raises(lambda: S.ServeFleet([])),
            _raises(lambda: S.ServeFleet([spec, spec])),
            _raises(lambda: S.ServeFleet([spec], fabric=m.fabric.Fabric.of(
                m.fabric.Path("x", 1.0)))))


SCENARIOS = [replica_pool_inventory, autoscale_config_validation, no_flapping_on_steady_load,
             scales_out_then_back_in, headline_static_vs_autoscaled,
             fleet_admission_priority_order, arbitration_defers_without_loss,
             placement_flips_on_other_tenants_occupancy, occupancy_ledger_clamps_and_skips,
             fleet_fabric_and_validation]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_port_equals_jax(scenario, jax_constants):  # noqa: F811
    want, got = scenario(JAX), scenario(PORT)
    assert got == want
    assert repr(got) == repr(want)          # bit for bit, not only by value


LAUNCH_ARGV = {
    "headline-30s": ["--duration", "30"],
    "arbitration-60s": ["--arbitration", "--duration", "60"],
    "autoscaled-burst": ["--mode", "autoscaled", "--duration", "40",
                         "--premium-rate", "3.0", "--max-replicas", "3"],
}


@pytest.mark.parametrize("case", LAUNCH_ARGV)
def test_fleet_launcher_prints_jax_lines(case, jax_constants):  # noqa: F811
    """``launch/fleet.py`` does no torch work: its lines are the JAX
    launcher's, and so is the report it returns."""
    outs, reports = [], []
    for main in (j_launch.main, t_launch.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            reports.append({k: v.to_dict() for k, v in main(LAUNCH_ARGV[case]).items()})
        outs.append(buf.getvalue())
    assert outs[1] == outs[0]
    assert reports[1] == reports[0]
    assert "premium" in outs[1] and "standard" in outs[1]
