"""The port's fabric, event runtime and tracer against the JAX package's
on the CPU.

Every scenario is one function of a module set; it runs once through
``repro.core.*`` / ``repro.obs.*`` / ``repro.serve.disagg`` and once
through their ``repro_torch`` copies, and the two results must be equal
with ``==``: completion times, rates, ledger reservations, span
timelines, Chrome-trace JSON and placement plans, to the last bit. The
scenarios are those of ``tests/test_runtime.py`` and
``tests/test_obs.py``; the copies' code must also be the JAX modules'
statement for statement, imports and docstrings aside."""
import ast
import dataclasses
import json
import types
from pathlib import Path as FsPath

import pytest

import repro.core.fabric as j_fabric
import repro.core.runtime as j_runtime
import repro.obs.export as j_export
import repro.obs.trace as j_trace
import repro.serve.disagg as j_disagg
import repro_torch.core.fabric as t_fabric
import repro_torch.core.runtime as t_runtime
import repro_torch.obs.export as t_export
import repro_torch.obs.trace as t_trace
import repro_torch.serve.disagg as t_disagg
from repro.ckpt.replication import simulate_replication

JAX = types.SimpleNamespace(fabric=j_fabric, runtime=j_runtime, trace=j_trace,
                            export=j_export, disagg=j_disagg)
PORT = types.SimpleNamespace(fabric=t_fabric, runtime=t_runtime, trace=t_trace,
                             export=t_export, disagg=t_disagg)
CAP, DISC = 100.0, 0.125


def _fab(m, *paths, **kw):
    return m.fabric.Fabric.of(*(m.fabric.Path(*p) for p in paths), **kw)


def _reserved(rt, paths):
    return [(p, rt.ledger.reserved(p, "out"), rt.ledger.reserved(p, "in")) for p in paths]


def _spans(tracer):
    return [(s.kind, s.name, s.tenant, s.flow, s.path, s.direction, s.t_start, s.t_end,
             list(s.rate_timeline), sorted(s.meta.items()),
             None if s.parent is None else s.parent.name) for s in tracer.spans]


# -- tests/test_runtime.py ---------------------------------------------

def overlapping_transfers(m):                                  # :84
    rt = m.runtime.FabricRuntime(_fab(m, ("link", CAP), concurrency_discount=DISC))
    t1, t2 = rt.transfer("link", 100.0), rt.transfer("link", 100.0)
    seen = {}
    rt.clock.schedule(0.1, lambda: seen.update(
        r1=t1.rate, r2=t2.rate, reserved=rt.ledger.reserved("link", "out")))
    rt.clock.run()
    return sorted(seen.items()), t1.finished_at, t2.finished_at, _reserved(rt, ["link"])


def staggered_rebalance(m):                                    # :107
    rt = m.runtime.FabricRuntime(_fab(m, ("link", CAP), concurrency_discount=DISC))
    t1 = rt.transfer("link", 100.0)
    box = {}
    rt.clock.schedule(0.25, lambda: box.update(solo=t1.rate))
    rt.clock.schedule(0.5, lambda: box.update(t2=rt.transfer("link", 100.0)))
    rt.clock.run()
    return box["solo"], t1.finished_at, box["t2"].finished_at, _reserved(rt, ["link"])


def unstall_after_release(m):                                  # :138
    rt = m.runtime.FabricRuntime(_fab(m, ("link", 100.0)))
    rt.ledger.reserve("link", out=100.0, flow="primary")
    t = rt.transfer("link", 50.0)
    rt.clock.run()
    stalled = (t.done, t.rate)
    rt.ledger.release("link", out=100.0, flow="primary")
    rt.rebalance("link")
    rt.clock.run()
    return stalled, t.done, t.rate, t.finished_at, _reserved(rt, ["link"])


def max_rate_water_fill(m):                                    # :153
    rt = m.runtime.FabricRuntime(_fab(m, ("p", 100.0)))
    slow = rt.transfer("p", 10.0, max_rate=10.0)
    fast = rt.transfer("p", 90.0)
    box = {}
    rt.clock.schedule(0.1, lambda: box.update(slow=slow.rate, fast=fast.rate))
    rt.clock.run()
    return sorted(box.items()), slow.finished_at, fast.finished_at, _reserved(rt, ["p"])


def external_reservations(m):                                  # :170
    rt = m.runtime.FabricRuntime(_fab(m, ("link", CAP), concurrency_discount=0.10))
    rt.ledger.reserve("link", out=30.0, flow="primary")
    t = rt.transfer("link", 60.0)
    rt.clock.run()
    return t.rate, t.finished_at, _reserved(rt, ["link"])


def shared_group(m):                                           # :185
    fabric = m.fabric.Fabric.of(m.fabric.Path("a", 100.0, shared_group="pcie"),
                                m.fabric.Path("b", 50.0, shared_group="pcie"),
                                concurrency_discount=0.2)
    rt = m.runtime.FabricRuntime(fabric)
    ta, tb = rt.transfer("a", 80.0), rt.transfer("b", 40.0)
    rt.clock.run()
    return ta.finished_at, tb.finished_at, _reserved(rt, ["a", "b"])


def replication(m):                                            # :204
    """simulate_replication's two schedules on the LineFS fabric, written
    against the module set (the JAX side is also held to JAX's own
    ``simulate_replication``)."""
    out = []
    for pipelined in (False, True):
        rt = m.runtime.FabricRuntime(m.fabric.linefs_fabric(200e9 / 8, 256e9 / 8))
        chunks, chunk, ratio, finish = 8, 1e9 / 8, 0.5, []
        if pipelined:
            staged, advanced = [0], m.runtime.Signal(rt.clock)

            def stage():
                for i in range(chunks):
                    yield rt.transfer("dma", chunk, flow=f"stage:{i}")
                    staged[0] = i + 1
                    advanced.fire()

            def send():
                for i in range(chunks):
                    while staged[0] <= i:
                        yield advanced
                    yield rt.transfer("net", chunk * ratio, flow=f"send:{i}")
                    finish.append(rt.clock.now)
            rt.process(stage(), name="replication-stage")
            rt.process(send(), name="replication-send")
        else:
            def serial():
                for i in range(chunks):
                    yield rt.transfer("dma", chunk, flow=f"stage:{i}")
                    yield rt.transfer("net", chunk * ratio, flow=f"send:{i}")
                    finish.append(rt.clock.now)
            rt.process(serial(), name="replication-serial")
        rt.clock.run(stop=lambda: len(finish) == chunks)
        out.append((pipelined, finish, _reserved(rt, ["dma", "net", "internal"])))
    if m is JAX:
        for pipelined, finish, _ in out:
            ref = simulate_replication(1e9, ratio=0.5, chunks=8, pipelined=pipelined,
                                       net_bw=200e9 / 8, staging_bw=256e9 / 8)
            assert ref.chunk_finish_s == finish
    return out


def global_vs_incremental(m):                                  # :507
    res = []
    for mode in ("incremental", "global"):
        fabric = m.fabric.Fabric.of(m.fabric.Path("h", 100.0, shared_group="g"),
                                    m.fabric.Path("s", 40.0, shared_group="g"),
                                    concurrency_discount=0.2)
        rt = m.runtime.FabricRuntime(fabric, rebalance=mode)
        ts = [rt.transfer("h" if i % 2 else "s", 10.0 + i, flow=f"f{i % 3}",
                          max_rate=25.0 if i % 4 else 1e9) for i in range(12)]
        rt.clock.at(0.5, lambda: rt.cancel(ts[3]))
        rt.clock.run()
        res.append(([(t.finished_at, t.canceled, t.remaining) for t in ts],
                    rt.clock.now, rt.clock.processed, _reserved(rt, ["h", "s"])))
    return res


# -- tests/test_obs.py -------------------------------------------------

def _staggered(m, tracer=None):
    rt = m.runtime.FabricRuntime(_fab(m, ("link", CAP), concurrency_discount=DISC),
                                 tracer=tracer)
    a = rt.transfer("link", 60.0, flow="a", tenant="t0")
    b = []
    rt.clock.schedule(0.5, lambda: b.append(rt.transfer("link", 40.0, flow="b",
                                                        tenant="t1")))
    rt.clock.run()
    return rt, a, b[0]


def span_timelines(m):                                         # :54
    tracer = m.trace.Tracer()
    rt, a, b = _staggered(m, tracer)
    return (_spans(tracer), sorted(tracer.busy_units().items()),
            a.finished_at, b.finished_at, _reserved(rt, ["link"]))


def rate_annotations(m):                                       # :77
    tracer = m.trace.Tracer()
    rt = m.runtime.FabricRuntime(_fab(m, ("link", CAP), concurrency_discount=DISC),
                                 tracer=tracer)
    ts = [rt.transfer("link", 100.0, flow=f"f{i}", tenant=f"t{i % 2}") for i in range(3)]
    rt.clock.schedule(0.7, lambda: rt.transfer("link", 50.0, flow="late"))
    probes = []

    def probe():
        now = rt.clock.now
        spans = [s for s in tracer.open_spans() if s.kind == m.trace.TRANSFER]
        probes.append((now, sorted((s.flow, s.rate_at(now)) for s in spans),
                       sorted((t.flow, t._res) for t in ts if not t.done),
                       rt.ledger.reserved("link", "out")))
    for at in (0.3, 0.9, 1.5):
        rt.clock.schedule(at, probe)
    rt.clock.run()
    return probes, _spans(tracer)


def tracer_on_vs_off(m):                                       # :110
    out = []
    for tracer in (None, m.trace.Tracer()):
        rt, a, b = _staggered(m, tracer)
        out.append((a.finished_at, b.finished_at, rt.clock.now, rt.clock.processed))
    assert out[0] == out[1]
    return out


def chrome_trace_json(m):                                      # :169
    tracer = m.trace.Tracer()
    _staggered(m, tracer)
    doc = m.export.chrome_trace(tracer)
    assert m.export.validate_chrome_trace(doc) == []
    return json.dumps(doc, sort_keys=True), m.export.summary(tracer)


# -- tests/test_runtime.py:375, the §5.2 placement plan ----------------

def placement_plans(m):
    fabric = m.disagg.kv_fabric()
    ledger = fabric.ledger()
    plans = [m.disagg.plan_decode_placement(fabric, ledger=ledger)]
    ledger.reserve("soc_read", out=0.95 * fabric["soc_read"].capacity, flow="tenant")
    plans.append(m.disagg.plan_decode_placement(fabric, ledger=ledger))
    plans.append(m.disagg.plan_decode_placement(m.disagg.kv_fabric()))
    assert [p.location for p in plans] == ["soc_cache", "host", "soc_cache"]
    return [(p.location, p.rate, p.baseline_rate, p.hit_mass,
             [dataclasses.astuple(a) for a in p.allocations]) for p in plans]


def occupancy_placement_plans(m):
    """The ``occupancy=`` branch: other tenants' measured shares become
    external reservations, the caller's own share is excluded, and a
    share above the path's capacity is clamped (tests/test_scale.py:335)."""
    fabric = m.disagg.kv_fabric()
    crowded = {"soc_read": {"train": 0.95, "serve": 0.02}, "nowhere": {"train": 1.0}}
    own = {"soc_read": {"serve": 0.95}}
    over = {"soc_read": {"train": 0.8, "batch": 0.7}}
    plans = [m.disagg.plan_decode_placement(fabric, occupancy=occ, tenant="serve")
             for occ in (crowded, own, over)]
    plans.append(m.disagg.plan_decode_placement(fabric, occupancy=crowded))
    assert [p.location for p in plans] == ["host", "soc_cache", "host", "host"]
    return [(p.location, p.rate, p.baseline_rate, p.hit_mass,
             [dataclasses.astuple(a) for a in p.allocations]) for p in plans]


SCENARIOS = [overlapping_transfers, staggered_rebalance, unstall_after_release,
             max_rate_water_fill, external_reservations, shared_group, replication,
             global_vs_incremental, span_timelines, rate_annotations,
             tracer_on_vs_off, chrome_trace_json, placement_plans,
             occupancy_placement_plans]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_port_equals_jax(scenario):
    want, got = scenario(JAX), scenario(PORT)
    assert got == want
    assert repr(got) == repr(want)          # bit for bit, not only by value


ROOT = FsPath(__file__).resolve().parents[1]
COPIES = ["core/fabric.py", "core/runtime.py", "obs/trace.py", "obs/export.py",
          "scale/arrivals.py", "serve/disagg.py", "tenancy/qos.py", "tenancy/admission.py",
          "tenancy/colocation.py", "tenancy/__init__.py", "offload/kvfilter.py",
          "scale/autoscale.py", "scale/fleet.py", "scale/__init__.py", "offload/__init__.py",
          "launch/fleet.py"]


def _body(path):
    """The module's AST without docstrings, with ``repro_torch``
    imports read as ``repro``."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            node.module = node.module.replace("repro_torch", "repro", 1)
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_jax_module(rel):
    """The copies keep every statement of the JAX module: a reordered
    float sum would change the simulated times."""
    assert _body(ROOT / "src" / "repro_torch" / rel) == _body(ROOT / "src" / "repro" / rel)

