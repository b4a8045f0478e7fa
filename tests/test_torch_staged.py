"""The port's simulated-time serving against the JAX package's on the CPU:
the synchronous engine on a fabric runtime, the staged pipeline, its
decode replica pool, sim compute, arrival traces and the launcher.

Simulated times come from prompt lengths and token counts only, so every
per-request ``first_token_time``, ``finish_time`` and ``placement`` must
equal JAX's exactly (``==``). Tokens follow ``tests/test_torch_serve.py``'s
rule: identical unless JAX's margin between its top two logits where the
two engines part is within rel 4e-2. Between two engines of the port the
tokens must be identical. Models are the reduced configs from bridged
params, ``impl="ref"``, ``device="cpu"``."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.fabric import OPS_PER_S as J_OPS_PER_S
from repro.core.fabric import Fabric as JFabric
from repro.core.fabric import Path as JPath
from repro.core.fabric import merge_fabrics as j_merge_fabrics
from repro.core.runtime import FabricRuntime as JRuntime
from repro.models.params import init_params as jax_init_params
from repro.scale import ArrivalGenerator as JArrivals
from repro.scale import burst_trace as j_burst_trace
from repro.serve import disagg as j_disagg
from repro.serve import engine as JE
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.fabric import OPS_PER_S, Fabric, Path, merge_fabrics
from repro_torch.core.runtime import FabricRuntime
from repro_torch.obs.export import validate_chrome_trace
from repro_torch.scale import ArrivalGenerator, burst_trace
from repro_torch.serve import disagg
from repro_torch.serve import engine as TE
from repro_torch.serve.engine import (Request, ServeEngine, ServeTimeModel,
                                      StagedServeEngine)
from test_torch_serve import REL, _teacher_forced

ARCHS = ("internlm2-1.8b", "mamba2-2.7b")


@pytest.fixture(scope="module")
def lms():
    """Reduced (cfg, JAX cfg, JAX params, bridged params) per arch."""
    built = {}

    def get(arch):
        if arch not in built:
            cfg = get_config(arch).reduced()
            jcfg = jax_get_config(arch).reduced()
            jparams = jax.jit(lambda k: jax_init_params(jcfg, k)[0])(jax.random.PRNGKey(0))
            tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
            built[arch] = cfg, jcfg, jparams, tparams
        return built[arch]
    return get


@pytest.fixture(scope="module")
def lm(lms):
    return lms("internlm2-1.8b")


def _pair(spec, seed=7):
    """The same requests for both packages: spec = [(prompt_len,
    max_new, arrival), ...]."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 128, plen).astype(np.int32) for plen, _, _ in spec]
    mk = lambda cls: [cls(rid=i, prompt=p, max_new_tokens=new, arrival=at)
                      for i, (p, (_, new, at)) in enumerate(zip(prompts, spec))]
    return mk(JE.Request), mk(Request)


def _submit(eng, reqs):
    for r in reqs:
        eng.submit(r)


def _timeline(reqs):
    return [(r.rid, r.first_token_time, r.finish_time, r.placement, len(r.out_tokens))
            for r in reqs]


def _tokens_agree(lm, jreqs, treqs):
    """test_torch_serve's rule on every request pair."""
    for jr, tr, (jl, tl) in zip(jreqs, treqs, _teacher_forced(lm, jreqs)):
        scale = np.abs(jl).max(axis=-1)
        assert float((np.abs(jl - tl).max(axis=-1) / scale).max()) < REL
        parted = [i for i, (a, b) in enumerate(zip(jr.out_tokens, tr.out_tokens)) if a != b]
        if parted:
            top2 = np.sort(jl[parted[0]])[-2:]
            assert top2[1] - top2[0] < REL * scale[parted[0]], (jr.rid, parted[0])


def _p99(reqs):
    """The nearest-rank p99 of tests/test_runtime.py."""
    arr = sorted(r.ttft for r in reqs)
    return arr[min(len(arr) - 1, int(np.ceil(0.99 * len(arr))) - 1)]


# JAX's two-path fabric and time model of tests/test_runtime.py:281,300
TWO_PATHS = (("prefill", 16.0), ("decode", 10.0))
TM_ARGS = dict(prefill_path="prefill", decode_path="decode",
               prefill_units_per_token=1.0, decode_units_per_slot=1.0)
MIXED = [(8, 4, 0.0), (5, 4, 0.0), (12, 3, 0.0), (8, 4, 0.0), (3, 2, 0.0),
         (16, 4, 0.0), (7, 4, 0.0), (9, 3, 0.0)]


@pytest.mark.parametrize("arch", ARCHS)
def test_staged_matches_jax_staged(lms, arch):
    """Same retirement order, stats and per-request timeline as JAX's
    staged engine on the two-path fabric; tokens by the rule."""
    lm = lms(arch)
    cfg, jcfg, jparams, tparams = lm
    jreqs, treqs = _pair(MIXED)
    jeng = JE.StagedServeEngine(jcfg, jparams, slots=2, max_len=64, impl="ref",
                                fabric=JFabric.of(*(JPath(*p) for p in TWO_PATHS)),
                                time_model=JE.ServeTimeModel(**TM_ARGS))
    teng = StagedServeEngine(cfg, tparams, slots=2, max_len=64, impl="ref",
                             fabric=Fabric.of(*(Path(*p) for p in TWO_PATHS)),
                             time_model=ServeTimeModel(**TM_ARGS), device="cpu")
    _submit(jeng, jreqs)
    _submit(teng, treqs)
    jdone, tdone = jeng.run(), teng.run()
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert _timeline(treqs) == _timeline(jreqs)
    assert teng.stats == jeng.stats and teng.clock.now == jeng.clock.now
    if arch == "mamba2-2.7b":
        assert teng.stats["prefill_padded_tokens"] == 0
    assert all(r.done for r in treqs)
    _tokens_agree(lm, jreqs, treqs)


def test_staged_beats_port_sync_p99_with_identical_tokens(lm):
    """tests/test_runtime.py:300 on the port: the staged engine's p99 TTFT
    is below the sync engine's, tokens identical, and both timelines are
    JAX's sync engine's and staged engine's."""
    cfg, jcfg, jparams, tparams = lm
    spec = [(8, 4, 0.0)] * 8
    tm = ServeTimeModel(**TM_ARGS)
    sync = ServeEngine(cfg, tparams, slots=2, max_len=64, impl="ref", device="cpu",
                       runtime=FabricRuntime(Fabric.of(*(Path(*p) for p in TWO_PATHS))),
                       time_model=tm)
    jsync = JE.ServeEngine(jcfg, jparams, slots=2, max_len=64, impl="ref",
                           runtime=JRuntime(JFabric.of(*(JPath(*p) for p in TWO_PATHS))),
                           time_model=JE.ServeTimeModel(**TM_ARGS))
    staged = StagedServeEngine(cfg, tparams, slots=2, max_len=64, impl="ref",
                               fabric=Fabric.of(*(Path(*p) for p in TWO_PATHS)),
                               time_model=tm, device="cpu")
    jstaged = JE.StagedServeEngine(None, None, compute="sim",
                                   fabric=JFabric.of(*(JPath(*p) for p in TWO_PATHS)),
                                   slots=2, max_len=64,
                                   time_model=JE.ServeTimeModel(**TM_ARGS))
    runs = {}
    for name, eng, mk in (("sync", sync, 1), ("jsync", jsync, 0), ("staged", staged, 1),
                          ("jstaged", jstaged, 0)):
        reqs = _pair(spec)[mk]
        _submit(eng, reqs)
        eng.run()
        assert all(r.done for r in reqs)
        runs[name] = reqs
    assert _timeline(runs["sync"]) == _timeline(runs["jsync"])
    assert _timeline(runs["staged"]) == _timeline(runs["jstaged"])
    for a, b in zip(runs["sync"], runs["staged"]):
        assert a.out_tokens == b.out_tokens, a.rid
    assert _p99(runs["staged"]) < _p99(runs["sync"])
    assert max(r.finish_time for r in runs["staged"]) <= \
        max(r.finish_time for r in runs["sync"]) + 1e-9
    _tokens_agree(lm, runs["jsync"], runs["sync"])


def _chip_spec(spacing):
    """chip_smoke.py's staged phase: prompt lengths [8, 512] + 6 drawn,
    16 new tokens each."""
    rng = np.random.default_rng(0)
    lens = [8, 512] + rng.integers(9, 512, 6).tolist()
    return [(n, 16, i * spacing) for i, n in enumerate(lens)]


@pytest.mark.parametrize("spacing", [0.0, 0.5], ids=["burst", "spaced"])
def test_kv_fabric_at_chip_lengths(lm, spacing):
    """On kv_fabric() at chip_smoke.py's lengths (slots 4, max_len 1024):
    the port's staged and sync engines give JAX's TTFT, finish times and
    placements exactly; real compute gives the sim engine's timeline;
    the two engines' tokens are identical."""
    cfg, jcfg, jparams, tparams = lm
    spec = _chip_spec(spacing)
    kw = dict(slots=4, max_len=1024)
    jreqs, treqs = _pair(spec)
    jsync = JE.ServeEngine(jcfg, jparams, impl="ref", fabric=j_disagg.kv_fabric(),
                           runtime=JRuntime(j_disagg.kv_fabric()),
                           time_model=j_disagg.kv_serve_time_model(), **kw)
    sync = ServeEngine(cfg, tparams, impl="ref", fabric=disagg.kv_fabric(),
                       runtime=FabricRuntime(disagg.kv_fabric()),
                       time_model=disagg.kv_serve_time_model(), device="cpu", **kw)
    _submit(jsync, jreqs)
    _submit(sync, treqs)
    jsync.run()
    sync.run()
    assert _timeline(treqs) == _timeline(jreqs)
    _tokens_agree(lm, jreqs, treqs)

    staged_kw = dict(fabric=disagg.kv_fabric(), time_model=disagg.kv_serve_time_model(),
                     plan_placement=True, **kw)
    jstaged = JE.StagedServeEngine(None, None, compute="sim", fabric=j_disagg.kv_fabric(),
                                   time_model=j_disagg.kv_serve_time_model(),
                                   plan_placement=True, **kw)
    staged = StagedServeEngine(cfg, tparams, impl="ref", device="cpu", **staged_kw)
    sim = StagedServeEngine(None, None, compute="sim", **staged_kw)
    runs = [(jstaged, _pair(spec)[0]), (staged, _pair(spec)[1]), (sim, _pair(spec)[1])]
    for eng, reqs in runs:
        _submit(eng, reqs)
        eng.run()
    (_, jst), (_, st), (_, si) = runs
    assert _timeline(st) == _timeline(jst) == _timeline(si)
    assert staged.placements == jstaged.placements
    assert sum(staged.placements.values()) == 8
    assert [r.out_tokens for r in st] == [r.out_tokens for r in treqs]
    assert all(len(r.out_tokens) == 16 for r in st)


# -- tests/test_runtime.py's other engine cases ------------------------

def _future_arrivals(jax_side, lm):                          # :335
    cfg, jcfg, jparams, tparams = lm
    reqs = _pair([(8, 3, 0.5), (8, 3, 1.5)], seed=17)[0 if jax_side else 1]
    if jax_side:
        eng = JE.ServeEngine(jcfg, jparams, slots=2, max_len=64, impl="ref",
                             runtime=JRuntime(JFabric.of(*(JPath(*p) for p in TWO_PATHS))),
                             time_model=JE.ServeTimeModel("prefill", "decode"))
    else:
        eng = ServeEngine(cfg, tparams, slots=2, max_len=64, impl="ref", device="cpu",
                          runtime=FabricRuntime(Fabric.of(*(Path(*p) for p in TWO_PATHS))),
                          time_model=ServeTimeModel("prefill", "decode"))
    _submit(eng, reqs)
    done = eng.run(max_steps=100)
    assert [r.rid for r in done] == [0, 1]
    assert all(r.done and r.first_token_time >= r.arrival for r in reqs)
    return reqs, eng


def _staggered_arrivals(jax_side, lm):                       # :354
    cfg, jcfg, jparams, tparams = lm
    reqs = _pair([(8, 3, 0.7 * i) for i in range(4)], seed=3)[0 if jax_side else 1]
    if jax_side:
        eng = JE.StagedServeEngine(jcfg, jparams, slots=2, max_len=64, impl="ref",
                                   fabric=JFabric.of(*(JPath(*p) for p in TWO_PATHS)),
                                   time_model=JE.ServeTimeModel("prefill", "decode"))
    else:
        eng = StagedServeEngine(cfg, tparams, slots=2, max_len=64, impl="ref",
                                device="cpu",
                                fabric=Fabric.of(*(Path(*p) for p in TWO_PATHS)),
                                time_model=ServeTimeModel("prefill", "decode"))
    _submit(eng, reqs)
    eng.run()
    assert all(r.done and r.first_token_time >= r.arrival + 8 / 16.0 - 1e-9 for r in reqs)
    return reqs, eng


def _placement_counts(jax_side, lm):                         # :393
    cfg, jcfg, jparams, tparams = lm
    reqs = _pair([(8, 3, 0.0)] * 4, seed=5)[0 if jax_side else 1]
    if jax_side:
        eng = JE.StagedServeEngine(jcfg, jparams, slots=2, max_len=64, impl="ref",
                                   fabric=j_disagg.kv_fabric(),
                                   time_model=j_disagg.kv_serve_time_model(),
                                   plan_placement=True)
    else:
        eng = StagedServeEngine(cfg, tparams, slots=2, max_len=64, impl="ref",
                                device="cpu", fabric=disagg.kv_fabric(),
                                time_model=disagg.kv_serve_time_model(),
                                plan_placement=True)
    _submit(eng, reqs)
    eng.run()
    assert sum(eng.placements.values()) == 4
    assert all(r.placement in ("soc_cache", "host") for r in reqs)
    return reqs, eng


@pytest.mark.parametrize("case", [_future_arrivals, _staggered_arrivals, _placement_counts],
                         ids=lambda f: f.__name__.strip("_"))
def test_engine_case_matches_jax(lm, case):
    jreqs, jeng = case(True, lm)
    treqs, teng = case(False, lm)
    assert _timeline(treqs) == _timeline(jreqs)
    assert teng.stats == jeng.stats
    assert getattr(teng, "placements", None) == getattr(jeng, "placements", None)
    _tokens_agree(lm, jreqs, treqs)


# -- sim compute against JAX's -----------------------------------------

POOL_PATHS = (("pf", 100.0), ("dec", 50.0), ("rep:0", 50.0), ("rep:1", 50.0))


def _sim_scale_events(jax_side, spacing=0.2):                # test_scale.py:117
    """A base run and one with two scale-outs and two scale-ins (one
    with shards in flight) on tests/test_scale.py's pool fabric."""
    E = JE if jax_side else TE
    F, P, R = (JFabric, JPath, JRuntime) if jax_side else (Fabric, Path, FabricRuntime)
    out = []
    for scale in (False, True):
        rt = R(F.of(*(P(*p) for p in POOL_PATHS)))
        eng = E.StagedServeEngine(None, None, compute="sim", runtime=rt,
                                  time_model=E.ServeTimeModel("pf", "dec", 1.0, 2.0),
                                  decode_pool=True)
        rng = np.random.default_rng(5)
        reqs = [E.Request(rid=i, prompt=rng.integers(1, 1000, 8).astype(np.int32),
                          max_new_tokens=4, arrival=spacing * i) for i in range(12)]
        _submit(eng, reqs)
        if scale:
            rt.clock.at(0.3, lambda: eng.add_decode_replica("rep:0"))
            rt.clock.at(0.6, lambda: eng.add_decode_replica("rep:1"))
            rt.clock.at(1.0, eng.retire_decode_replica)
            rt.clock.at(1.6, eng.retire_decode_replica)
        served = eng.run()
        out.append((sorted((r.rid, r.ttft, r.finish_time, tuple(r.out_tokens))
                           for r in served), eng.scale_events, rt.clock.now,
                    [(p, rt.ledger.reserved(p, "out")) for p in rt.fabric]))
    assert [tuple(x[3] for x in run[0]) for run in out][0] == \
        [tuple(x[3] for x in run[0]) for run in out][1]
    return out


def _sim_dense_scale_events(jax_side):
    """The same with arrivals 0.02 s apart: several slots decode at once,
    so two live replicas split each step's shards."""
    return _sim_scale_events(jax_side, spacing=0.02)


def _sim_burst_trace(jax_side):
    """A seeded burst_trace replay through the sim staged engine on
    kv_fabric(); the arrivals and prompts are JAX's generator's."""
    gen = (JArrivals if jax_side else ArrivalGenerator)(
        (j_burst_trace if jax_side else burst_trace)(base_rate=4.0, duration=20.0),
        seed=3, vocab=1000)
    reqs = gen.requests()
    d = j_disagg if jax_side else disagg
    E = JE if jax_side else TE
    eng = E.StagedServeEngine(None, None, compute="sim", slots=4, max_len=128,
                              fabric=d.kv_fabric(), time_model=d.kv_serve_time_model(),
                              plan_placement=True)
    _submit(eng, reqs)
    eng.run()
    assert all(r.done for r in reqs) and len(reqs) > 40
    return ([(r.rid, r.arrival, r.prompt.tolist(), r.max_new_tokens, r.ttft,
              r.finish_time, r.placement, r.out_tokens) for r in reqs],
            eng.placements, eng.clock.now, eng.stats)


@pytest.mark.parametrize("case", [_sim_scale_events, _sim_dense_scale_events,
                                  _sim_burst_trace],
                         ids=lambda f: f.__name__.strip("_"))
def test_sim_mode_equals_jax(case):
    want, got = case(True), case(False)
    assert got == want
    assert repr(got) == repr(want)


def test_real_compute_tokens_survive_scale_events(lm):
    """tests/test_scale.py:159 on the port: greedy tokens are identical
    with and without a scale-out/scale-in cycle, and the timeline under
    scale events is the sim engine's (which JAX's equals above)."""
    cfg, _, _, tparams = lm
    tm = ServeTimeModel("pf", "dec", 0.5, 0.5)

    def run(scale, compute):
        rt = FabricRuntime(Fabric.of(*(Path(*p) for p in POOL_PATHS)))
        eng = StagedServeEngine(cfg if compute == "torch" else None,
                                tparams if compute == "torch" else None,
                                slots=2, max_len=64, impl="ref", runtime=rt,
                                time_model=tm, decode_pool=True, compute=compute,
                                device="cpu")
        reqs = _pair([(8, 4, 0.1 * i) for i in range(4)], seed=11)[1]
        _submit(eng, reqs)
        if scale:
            rt.clock.at(0.15, lambda: eng.add_decode_replica("rep:0"))
            rt.clock.at(0.5, eng.retire_decode_replica)
        eng.run()
        assert [e["event"] for e in eng.scale_events] == (
            ["scale_out", "scale_in"] if scale else [])
        return reqs

    plain, scaled, sim = run(False, "torch"), run(True, "torch"), run(True, "sim")
    assert [r.out_tokens for r in plain] == [r.out_tokens for r in scaled]
    assert _timeline(scaled) == _timeline(sim)


def _chip_pool_run(jax_side):
    """chip_smoke.py's pool run in sim compute: kv_fabric() merged with
    two spare SoC read paths, SoC-cache reads through the pool, one
    scale-out while decoding and a scale-in that cancels a shard in
    flight."""
    E, d, F, P, R, ops, merge = \
        (JE, j_disagg, JFabric, JPath, JRuntime, J_OPS_PER_S, j_merge_fabrics) \
        if jax_side else (TE, disagg, Fabric, Path, FabricRuntime, OPS_PER_S, merge_fabrics)
    spare = F.of(*(P(f"spare_read:{i}", d.PathCosts().read_soc_rate, ops,
                     latency=1e-6, kind="rdma") for i in range(2)))
    tm = dataclasses.replace(d.kv_serve_time_model(), decode_path="soc_read",
                             placement_paths={"host": "host_read"})
    rt = R(merge(d.kv_fabric(), spare))
    eng = E.StagedServeEngine(None, None, compute="sim", slots=4, max_len=1024,
                              runtime=rt, time_model=tm, plan_placement=True,
                              decode_pool=True)
    reqs = _pair(_chip_spec(0.0))[0 if jax_side else 1]
    _submit(eng, reqs)
    seen = {}
    rt.clock.at(5.890, lambda: (seen.update(active=sum(
        a is not None for a in eng.active)), eng.add_decode_replica("spare_read:0")))
    rt.clock.at(5.893, lambda: (seen.update(inflight=len(
        eng._extras()[-1].inflight)), eng.retire_decode_replica()))
    eng.run()
    assert seen["active"] > 0 and seen["inflight"] > 0
    assert all(rt.ledger.reserved(p, "out") == pytest.approx(0.0, abs=1e-6)
               for p in rt.fabric)
    return _timeline(reqs), eng.placements, eng.scale_events, seen


def test_pool_on_merged_kv_fabric_equals_jax():
    want, got = _chip_pool_run(True), _chip_pool_run(False)
    assert got == want
    assert sum(got[1].values()) == 8


# -- the launcher ------------------------------------------------------

def _line(out, prefix):
    return next(ln for ln in out.splitlines() if ln.startswith(prefix))


def test_launcher_staged_line_equals_jax(capsys):
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve as port_serve
    argv = ["--arch", "internlm2-1.8b", "--staged", "--reduced", "--requests", "6",
            "--max-new", "6", "--arrival-spacing", "0.0002"]
    port_serve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    jax_serve.main(argv)
    want = capsys.readouterr().out
    key = "[serve] simulated TTFT"
    assert _line(got, key) == _line(want, key)
    assert "flash_attention=0 decode_attention=0 ssd_scan=0 (device cpu)" in got


def test_launcher_trace_replay_writes_chrome_trace(tmp_path, capsys):
    from repro_torch.launch import serve as port_serve
    out = tmp_path / "serve_trace.json"
    reqs = port_serve.main(["--arch", "internlm2-1.8b", "--staged", "--reduced",
                            "--device", "cpu", "--trace", "burst",
                            "--trace-duration", "8", "--trace-json", str(out)])
    text = capsys.readouterr().out
    assert all(r.done for r in reqs) and len(reqs) > 0
    assert "[serve] trace 'burst10x'" in text and "[trace]" in text
    assert validate_chrome_trace(json.loads(out.read_text())) == []
    with pytest.raises(SystemExit):
        port_serve.main(["--arch", "internlm2-1.8b", "--reduced", "--device", "cpu",
                         "--trace", "burst"])


# -- device ------------------------------------------------------------

def test_compute_modes_and_device(monkeypatch, lm):
    cfg, _, _, tparams = lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = ServeTimeModel(**TM_ARGS)
    fabric = Fabric.of(*(Path(*p) for p in TWO_PATHS))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StagedServeEngine(cfg, tparams, fabric=fabric, time_model=tm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, tparams, fabric=disagg.kv_fabric())
    sim = StagedServeEngine(None, None, compute="sim", fabric=fabric, time_model=tm)
    assert sim.device is None and sim.cache is None
    with pytest.raises(ValueError, match="compute must be"):
        StagedServeEngine(cfg, tparams, compute="jax", fabric=fabric, time_model=tm,
                          device="cpu")
    with pytest.raises(ValueError, match="needs a ModelConfig"):
        StagedServeEngine(None, None, fabric=fabric, time_model=tm, device="cpu")
