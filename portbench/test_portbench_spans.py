"""The program's spans as the benchmark reads them: the attribution of a
synthetic profiler trace to its ``serve.*`` spans, beside the ``pb.``
ranges' (unchanged by them), and each reader of ``host_spans.PENDING``
on a tiny traced run on the CPU."""
import math

import pytest

from portbench import host_spans, spec, tiny
from portbench import spans as S
from portbench import trace as T


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def _events(program=True):
    """One decode step in a 100 us window: the host enqueues two kernels
    inside ``serve.decode.enqueue`` (launches at 12 and 20), then waits in
    ``serve.finish.sync`` while the device runs them and idles; a copy's
    launch (not a kernel launch) starts the read."""
    ev = [_x("pb.trace", "user_annotation", 0, 100),
          _x("pb.decode", "user_annotation", 10, 30),
          _x("pb.finish", "user_annotation", 45, 50),
          _x("cudaLaunchKernel", "cuda_runtime", 12, 2, correlation=1),
          _x("cudaLaunchKernel", "cuda_runtime", 20, 2, correlation=2),
          _x("cudaMemcpyAsync", "cuda_runtime", 50, 30, correlation=3),
          _x("k_a", "kernel", 30, 10, correlation=1),
          _x("k_b", "kernel", 60, 10, correlation=2),
          _x("Memcpy DtoH", "gpu_memcpy", 75, 5, correlation=3)]
    if program:
        ev += [_x("serve.step", "user_annotation", 5, 90),
               _x("serve.decode", "user_annotation", 10, 30),
               _x("serve.decode.enqueue", "user_annotation", 11, 25),
               _x("serve.finish", "user_annotation", 45, 50),
               _x("serve.finish.sync", "user_annotation", 46, 40)]
    return ev


def test_idle_is_charged_to_the_innermost_program_span():
    got = S.reduce_spans(_events())
    # idle: [0, 30) middle 15 -> enqueue; [40, 60) middle 50 -> finish.sync;
    # [70, 75) middle 72.5 -> finish.sync; [80, 100) middle 90 -> finish
    assert got["serve.decode.enqueue"]["idle_s"] == pytest.approx(30e-6)
    assert got["serve.finish.sync"]["idle_s"] == pytest.approx(25e-6)
    assert got["serve.finish"]["idle_s"] == pytest.approx(20e-6)
    assert got["serve.step"]["idle_s"] == 0.0 and got[S.NO_SPAN]["idle_s"] == 0.0
    assert sum(v["idle_s"] for v in got.values()) == pytest.approx((100 - 25) * 1e-6)


def test_launches_and_device_time_are_counted_per_span():
    got = S.reduce_spans(_events())
    assert got["serve.decode.enqueue"]["launches"] == 2
    assert got["serve.decode"]["launches"] == 2 and got["serve.step"]["launches"] == 2
    assert got["serve.finish.sync"]["launches"] == 0           # a copy is no launch
    assert got["serve.decode"]["device_s"] == pytest.approx(20e-6)
    assert got["serve.finish.sync"]["device_s"] == pytest.approx(5e-6)
    assert got["serve.step"]["count"] == 1
    assert got["serve.step"]["host_s"] == pytest.approx(90e-6)


def test_idle_outside_every_program_span_has_its_own_entry():
    ev = [e for e in _events() if e["name"] != "serve.step"]
    got = S.reduce_spans(ev)
    assert got[S.NO_SPAN]["idle_s"] == 0.0
    ev = [e for e in ev if not e["name"].startswith("serve.finish")]
    got = S.reduce_spans(ev)
    assert got[S.NO_SPAN]["idle_s"] == pytest.approx(45e-6)


def test_program_spans_leave_the_pb_ranges_as_they_were():
    with_, without = T.reduce_events(_events()), T.reduce_events(_events(program=False))
    for k in ("idle_gaps", "range_s", "busy_s", "window_s", "device_ops"):
        assert with_[k] == without[k], k
    assert dict(with_["idle_gaps"]) == pytest.approx(
        {"pb.decode": 30e-6, "pb.finish": 45e-6})


def test_a_run_without_spans_reads_none():
    run = {"kind": "serve", "t0": 0.0, "t1": 1.0, "trace": {"range_s": {}}}
    for m in host_spans.PENDING:
        assert spec.reader(m["name"])(dict(run, kind=m["moves"].split("_")[0])) is None


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("portbench"))
    bench = spec.load_benchmark(root / "BENCHMARK.json")
    pending = [{k: v for k, v in m.items() if k != "workloads"} for m in host_spans.PENDING]
    out = {}

    def get(cell):
        if cell not in out:
            import time

            import torch
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                out[cell] = host_spans.run_cell(bench, cell, 2 ** 31 + 23, 1.5, True,
                                                device="cpu", t_process=time.perf_counter(),
                                                root=root, pending=pending)
            finally:
                torch.set_num_threads(threads)
        return out[cell]
    return get


SERVE_READ = ["engine.queue_wait_p90_ms", "engine.decode_enqueue_ms", "engine.decode_sync_ms",
              "engine.prefill_pad_share"]
TRAIN_READ = ["train.forward_host_ms", "train.backward_host_ms"]


@pytest.mark.parametrize("metric", [m["name"] for m in host_spans.PENDING])
def test_each_pending_metric_reads_a_tiny_traced_run(traced, metric):
    """A finite number from the host's spans; the launch counts need the
    card's launch calls, which a CPU trace has none of."""
    cell = "tiny-dense.train" if metric.startswith("train.") else "tiny-dense.serve"
    out = traced(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and out["spans"]
    if metric in SERVE_READ + TRAIN_READ:
        v = out["metrics"][metric]["value"]
        assert math.isfinite(v) and v >= 0
        if metric == "engine.prefill_pad_share":
            assert 0 < v < 100                    # prompts 8-24 in power-of-two buckets
    else:
        assert metric not in out["metrics"]


def test_a_traced_run_charges_idle_to_program_spans(traced):
    out = traced("tiny-dense.serve")
    names = set(out["spans"])
    assert {"serve.step", "serve.decode", "serve.finish.sync", S.NO_SPAN} <= names
    assert out["spans"]["serve.decode"]["count"] > 0
    assert "serve_tokens_per_s" in out["window"]
