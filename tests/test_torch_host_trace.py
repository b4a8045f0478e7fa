"""The host tracer (``repro_torch/obs/host.py``) inside the serve engine
and the train step, on the CPU at the reduced configs:

(a) the span tree of a few engine steps and of a train step: names,
    parents, one ``serve.request`` per request, queue waits, host reads
    counted per step;
(b) record-only: the same greedy tokens and the same parameters, bit for
    bit, with a tracer and without;
(c) off: no span made and no clock read;
(d) under ``torch.profiler``, every stacked span is a ``user_annotation``
    with the same nesting, and the aten ops run inside it fall inside its
    interval.

And the launchers' ``--trace-json`` / ``--trace`` files of host spans."""
import collections
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import RunConfig, get_config
from repro_torch.models.params import init_params
from repro_torch.obs import host as H
from repro_torch.obs import trace as OT
from repro_torch.obs.export import validate_chrome_trace
from repro_torch.optim.adamw import adamw_init, tree_leaves, tree_unflatten
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train.train_step import make_train_step

STACKED = {"serve.step": None, "serve.admit": "serve.step", "serve.prefill": "serve.admit",
           "serve.prefill.enqueue": "serve.prefill", "serve.prefill.sync": "serve.prefill",
           "serve.splice": "serve.admit", "serve.decode": "serve.step",
           "serve.decode.inputs": "serve.decode", "serve.decode.enqueue": "serve.decode",
           "serve.finish": "serve.step", "serve.finish.sync": "serve.finish"}
TRAIN = {"train.step": None, "train.forward": "train.step", "train.backward": "train.step",
         "train.accumulate": "train.step", "train.optimizer": "train.step"}
# (prompt length, max new tokens): more requests than slots, so some wait
REQS = [(5, 4), (12, 3), (9, 5), (20, 2), (7, 3)]


@pytest.fixture(scope="module")
def arch():
    cfg = get_config("internlm2-1.8b").reduced()
    gen = torch.Generator()
    gen.manual_seed(0)
    return cfg, init_params(cfg, gen, "cpu")


def _serve(arch, tracer):
    cfg, params = arch
    eng = ServeEngine(cfg, params, slots=2, max_len=64, device="cpu", host_tracer=tracer)
    rng = np.random.default_rng(1)
    reqs = [Request(rid=10 + i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=m) for i, (n, m) in enumerate(REQS)]
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.queue or any(eng.active):
        eng.step()
        steps += 1
    return [list(r.out_tokens) for r in reqs], steps


def _train(arch, tracer, steps=2):
    cfg, params = arch
    params = _clone(params)                     # the step updates params in place
    run = RunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, microbatch=2)
    step_fn = make_train_step(cfg, run, host_tracer=tracer)
    opt = adamw_init(params)
    rng = np.random.default_rng(2)
    for i in range(steps):
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))),
                 "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))),
                 "loss_mask": torch.ones((4, 16))}
        params, opt, _ = step_fn(params, opt, batch, i + 1)
    return params


def _clone(tree):
    return tree_unflatten(tree, [x.clone() for x in tree_leaves(tree)])


def _parent(span):
    return span.parent.name if span.parent is not None else None


def test_engine_span_tree(arch):
    tracer = H.HostTracer()
    _, steps = _serve(arch, tracer)
    by = collections.defaultdict(list)
    for s in tracer.spans:
        by[s.name].append(s)
        assert s.closed and s.t_end >= s.t_start
    assert not tracer.open_spans()
    for name, parent in STACKED.items():
        assert by[name], name
        assert all(_parent(s) == parent for s in by[name]), name
    assert len(by["serve.step"]) == steps
    req = by["serve.request"]
    assert sorted(s.meta["rid"] for s in req) == [10 + i for i in range(len(REQS))]
    assert all(s.tenant == "requests" and s.parent is None for s in req)
    assert {s.meta["rid"]: (s.meta["prompt_tokens"], s.meta["output_tokens"]) for s in req} \
        == {10 + i: (n, m) for i, (n, m) in enumerate(REQS)}
    start = {s.meta["rid"]: s.t_start for s in req}
    pre = by["serve.prefill"]
    assert sorted(s.meta["rid"] for s in pre) == sorted(start)
    waits = [s.t_start - start[s.meta["rid"]] for s in pre]
    assert min(waits) >= 0
    for s in pre:
        assert s.meta["bucket"] == max(8, 1 << (s.meta["tokens"] - 1).bit_length())
    # host reads: 1 for each prefill, 2 for a greedy decode step
    for st in by["serve.step"]:
        decoded = st.meta["active"] > 0
        assert st.meta["host_syncs"] == st.meta["admitted"] + (2 if decoded else 0)
    assert sum(st.meta["admitted"] for st in by["serve.step"]) == len(REQS)


def test_train_step_span_tree(arch):
    tracer = H.HostTracer()
    _train(arch, tracer)
    by = collections.defaultdict(list)
    for s in tracer.spans:
        by[s.name].append(s)
    for name, parent in TRAIN.items():
        assert all(_parent(s) == parent for s in by[name]), name
    assert len(by["train.step"]) == 2
    # two microbatches a step: a forward and a backward each, one add and the mean
    assert [s.meta["microbatch"] for s in by["train.forward"]] == [0, 1, 0, 1]
    assert all(s.meta["tokens"] == 2 * 16 for s in by["train.forward"])
    assert len(by["train.backward"]) == 4 and len(by["train.accumulate"]) == 4
    assert len(by["train.optimizer"]) == 2


def test_tracing_is_record_only(arch):
    assert _serve(arch, H.HostTracer()) == _serve(arch, None)
    a, b = _train(arch, H.HostTracer()), _train(arch, None)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def test_off_makes_no_span_and_reads_no_clock(arch, monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("tracing work with no tracer")
    monkeypatch.setattr(OT.Span, "__init__", boom)
    monkeypatch.setattr(H.WallClock, "now", property(boom))
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    tokens, _ = _serve(arch, None)
    assert all(tokens)
    _train(arch, None, steps=1)


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]


def _check_mirrored(tracer, events, tree):
    ann = [e for e in events if e.get("cat") == "user_annotation" and e["name"] in tree]
    spans = [s for s in tracer.spans if s.name in tree]
    assert collections.Counter(e["name"] for e in ann) == \
        collections.Counter(s.name for s in spans)
    ann.sort(key=lambda e: (e["ts"], -e["dur"]))
    for e in ann:                     # the innermost annotation around it is its parent's
        outer = [o for o in ann if o is not e and o["ts"] <= e["ts"]
                 and e["ts"] + e["dur"] <= o["ts"] + o["dur"]]
        want = tree[e["name"]]
        got = min(outer, key=lambda o: o["dur"])["name"] if outer else None
        assert got == want, (e["name"], got, want)
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")]
    leaves = [e for e in ann if e["name"] in ("serve.decode.enqueue", "train.backward")]
    assert leaves
    for e in leaves:
        inner = [o for o in ops if e["ts"] <= o["ts"] < e["ts"] + e["dur"]]
        assert inner, e["name"]
        assert all(o["ts"] + o["dur"] <= e["ts"] + e["dur"] + 1 for o in inner
                   if o["tid"] == e["tid"])


def test_spans_are_mirrored_into_the_profiler(arch, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    tracer = H.HostTracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(arch, tracer)
    events = _annotations(prof, tmp_path)
    _check_mirrored(tracer, events, STACKED)
    assert not [e for e in events if e["name"] == "serve.request"]
    tracer = H.HostTracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train(arch, tracer, steps=1)
    _check_mirrored(tracer, _annotations(prof, tmp_path), TRAIN)


def test_no_profiler_no_range(arch, monkeypatch):
    calls = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: calls.append(name))
    tracer = H.HostTracer()
    _serve(arch, tracer)
    assert tracer.spans and not calls


def test_close_must_be_innermost():
    tracer = H.HostTracer()
    a = tracer.open("a")
    tracer.open("b")
    with pytest.raises(RuntimeError, match="innermost"):
        tracer.close(a)


def test_launchers_write_host_spans(tmp_path, capsys):
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    out = tmp_path / "serve.json"
    launch_serve.main(["--arch", "internlm2-1.8b", "--reduced", "--device", "cpu",
                       "--requests", "3", "--max-new", "3", "--trace-json", str(out)])
    doc = json.loads(out.read_text())
    assert validate_chrome_trace(doc) == []
    names = collections.Counter(e["name"] for e in doc["traceEvents"] if e["ph"] == "X")
    assert names["serve.request"] == 3 and names["serve.step"] > 0
    out = tmp_path / "train.json"
    launch_train.main(["--arch", "internlm2-1.8b", "--reduced", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "16", "--trace", str(out)])
    doc = json.loads(out.read_text())
    assert validate_chrome_trace(doc) == []
    names = collections.Counter(e["name"] for e in doc["traceEvents"] if e["ph"] == "X")
    assert names["train.step"] == 2 and names["train.optimizer"] == 2
    assert "[trace]" in capsys.readouterr().out
