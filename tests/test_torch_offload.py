"""The port's DrTM-KV data plane (``serve/disagg.py``'s ``DisaggKV``) and
its SoC get/put filter (``offload/kvfilter.py``) against the JAX
package's, on the CPU.

The data plane is numpy in both packages (hash index, value store, SoC
value cache), so the same seed must give the same arrays, values,
modeled latencies, zipf keys and filtered scans bit for bit. The
scenarios are ``tests/test_offload.py:496-558`` and
``tests/test_planner.py::test_drtm_kv_calibration``; each runs through
both packages, keeps the JAX test's assertions and returns what it
measured, and the two results must be equal with ``==``. Nothing here
reads ``core/hw.py``: the §5.2 fabric's figures are ``PathCosts``."""
import dataclasses
import types

import numpy as np
import pytest

import repro.offload as j_offload
import repro.serve.disagg as j_disagg
import repro_torch.offload as t_offload
import repro_torch.serve.disagg as t_disagg

JAX = types.SimpleNamespace(disagg=j_disagg, offload=j_offload)
PORT = types.SimpleNamespace(disagg=t_disagg, offload=t_offload)


def _kv(m, **kw):
    return m.disagg.DisaggKV(m.disagg.KVStoreParams(n_keys=2000, soc_cache_keys=100, **kw),
                             seed=1)


def _scan(s):
    return (s.keys.dtype.str, s.keys.tolist(), s.values.dtype.str, s.values.tolist(), s.where,
            s.scanned, s.matched, s.seconds)


def _alts(alts):
    return {k: (a.name, [dataclasses.astuple(u) for u in a.uses], sorted(a.criteria.items()))
            for k, a in alts.items()}


# -- tests/test_offload.py:496-558 ---------------------------------------

def filter_results_across_placement(m):                        # :500
    O = m.offload
    kv = _kv(m)
    keys = kv.zipf_keys(400, seed=3)
    predicate = lambda vals: vals[:, 0] < 64          # noqa: E731
    soc = kv.filtered_scan(keys, predicate, where=O.SOC_FILTER)
    host = kv.filtered_scan(keys, predicate, where=O.HOST_FILTER)
    np.testing.assert_array_equal(soc.keys, host.keys)
    np.testing.assert_array_equal(soc.values, host.values)
    assert soc.scanned == host.scanned == 400
    assert soc.matched == host.matched == len(soc.keys) > 0
    assert bool(np.all(predicate(soc.values)))
    return _scan(soc), _scan(host)


def filter_placement_flips_under_host_load(m):                 # :515
    O = m.offload
    kv = _kv(m)
    fab = kv.fabric()
    idle = O.plan_filter_placement(fab, selectivity=0.1, costs=kv.c)
    assert idle.location == O.HOST_FILTER and idle.host_rate > idle.soc_rate
    led = fab.ledger()
    led.reserve("host_read", out=0.9 * fab["host_read"].capacity, flow="serve")
    busy = O.plan_filter_placement(fab, selectivity=0.1, costs=kv.c, ledger=led)
    assert busy.location == O.SOC_FILTER and busy.soc_rate > busy.host_rate
    keys = kv.zipf_keys(200, seed=5)
    predicate = lambda vals: vals[:, 0] < 32          # noqa: E731
    f = O.KVFilter(kv)
    soc = f.scan(keys, predicate, where=O.SOC_FILTER, ledger=led)
    host = f.scan(keys, predicate, where=O.HOST_FILTER, ledger=led)
    assert soc.seconds < host.seconds
    return (dataclasses.astuple(idle), dataclasses.astuple(busy), _scan(soc), _scan(host),
            dataclasses.astuple(f.plan(selectivity=0.3, ledger=led)))


def filter_stats_and_alternatives(m):                          # :539
    O = m.offload
    kv = _kv(m)
    stats = O.OffloadStats()
    f = O.KVFilter(kv, stats=stats)
    keys = kv.zipf_keys(300, seed=9)
    scan = f.scan(keys, lambda v: v[:, 0] < 16, where=O.SOC_FILTER)
    s = stats.get_performance_stats()
    assert s["packets_total"] == 300
    assert s["packets_offloaded"] == 300 - scan.matched
    assert s["offload_hit_rate"] == pytest.approx(1 - scan.matched / 300)
    assert s["cpu_cycles_saved"] >= 300
    alts = O.kv_filter_alternatives(kv.c, selectivity=0.2)
    for alt in alts.values():
        kv.fabric().validate(alt)
    errs = []
    for fn in (lambda: O.kv_filter_alternatives(kv.c, selectivity=1.5),
               lambda: f.scan(keys, lambda v: v[:, 0] < 16, where="fpga")):
        with pytest.raises(ValueError) as e:
            fn()
        errs.append(str(e.value))
    return _scan(scan), sorted(s.items()), _alts(alts), errs


# -- tests/test_planner.py::test_drtm_kv_calibration ----------------------

def drtm_kv_calibration(m):                                    # :101
    kv = m.disagg.DisaggKV(m.disagg.KVStoreParams(n_keys=100_000, soc_cache_keys=10_000))
    paths, alts = kv.fabric(), kv.alternatives()
    rates = {k: a.solo_rate(paths) for k, a in alts.items()}
    assert abs(rates["A1"] / 1e6 - 50) < 3
    assert abs(rates["A4"] / 1e6 - 58.3) < 3
    assert abs(rates["A5"] / 1e6 - 70) < 3
    total, allocs = kv.combined_a4_a5()
    assert abs(total / 1e6 - 68) < 4
    lat = {k: a.criteria["latency_us"] for k, a in alts.items()}
    assert lat["A5"] < lat["A4"] < lat["A1"] < lat["A2"]
    return (sorted(rates.items()), total, [dataclasses.astuple(a) for a in allocs],
            sorted(lat.items()), kv.cache_hit_mass(), _alts(alts))


# -- the data plane ---------------------------------------------------------

def data_plane(m):
    """The index, value store and SoC cache, and ``get`` through each of
    the five alternatives over hot and cold keys (A5 hits and misses)."""
    kv = _kv(m)
    keys = [0, 1, 57, 99, 100, 101, 1234, 1999] + kv.zipf_keys(64, seed=11).tolist()
    gets = []
    for alt in ("A1", "A2", "A3", "A4", "A5"):
        for k in keys:
            val, lat = kv.get(int(k), alt)
            gets.append((alt, int(k), val.tolist(), lat))
    with pytest.raises(ValueError):
        kv.get(0, "A6")
    return (kv.nbuckets, kv.index_keys.tolist(), kv.index_addr.tolist(),
            kv.values.tobytes(), sorted(kv.overflow.items()), sorted(kv.soc_cached),
            gets, dataclasses.astuple(kv.p), dataclasses.astuple(kv.c))


def zipf_keys_and_hit_mass(m):
    out = []
    for theta, n_keys, cache in ((0.99, 2000, 100), (0.5, 5000, 1000), (1.2, 300, 10)):
        kv = m.disagg.DisaggKV(m.disagg.KVStoreParams(
            n_keys=n_keys, soc_cache_keys=cache, zipf_theta=theta), seed=2)
        out.append((kv.zipf_keys(500, seed=4).tolist(), kv.zipf_keys(7).tolist(),
                    kv.cache_hit_mass()))
    assert out[0][0] != out[1][0]
    return out


def filtered_scan_under_ledger(m):
    """``DisaggKV.filtered_scan`` (the lazy ``KVFilter`` import) with a
    live ledger and shared stats, both placements, several predicates."""
    O = m.offload
    kv = _kv(m, value_bytes=32)
    fab = kv.fabric()
    led = fab.ledger()
    led.reserve("host_read", out=0.5 * fab["host_read"].capacity, flow="serve")
    led.reserve("dma", out=0.25 * fab["dma"].capacity, flow="ckpt")
    stats = O.OffloadStats()
    keys = kv.zipf_keys(1000, seed=6)
    out = []
    for where in (O.SOC_FILTER, O.HOST_FILTER):
        for pred in (lambda v: v[:, 0] < 8, lambda v: v.sum(axis=1) % 3 == 0,
                     lambda v: v[:, -1] >= 0):
            out.append(_scan(kv.filtered_scan(keys, pred, where=where, ledger=led,
                                              stats=stats)))
    return out, sorted(stats.get_performance_stats().items())


SCENARIOS = [filter_results_across_placement, filter_placement_flips_under_host_load,
             filter_stats_and_alternatives, drtm_kv_calibration, data_plane,
             zipf_keys_and_hit_mass, filtered_scan_under_ledger]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_port_equals_jax(scenario):
    want, got = scenario(JAX), scenario(PORT)
    assert got == want
    assert repr(got) == repr(want)          # bit for bit, not only by value
