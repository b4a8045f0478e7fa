"""One run of one cell, as ``run.py`` makes it, with the program's own
spans read too.

    python3 portbench/host_spans.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 1`` the program gets a ``repro_torch.obs.host.HostTracer``
for the whole run (``ServeEngine(host_tracer=...)``,
``make_train_step(host_tracer=...)``), the run's record keeps its spans
(``host_spans``) and the traced window's reduction adds the attribution
to them (``spans.reduce_spans``, under ``trace["spans"]``). The result
line is ``run.py``'s, with the metrics of ``PENDING`` among the per-layer
ones, ``spans`` (the traced window's attribution) and ``window`` (the
cell's end-to-end metrics over the window, which the host tracer ran
through). ``--trace 0`` is ``run.py`` exactly: no tracer is built.

``BENCHMARK.json`` and the harness files stay as they are; the hooks
below are what they would take to read these metrics themselves.
"""
from __future__ import annotations

import contextlib
import functools
import json
import sys
from pathlib import Path
from typing import Dict, Iterable, List

REPO = Path(__file__).resolve().parents[1]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import run as RUN  # noqa: E402  (the process's start, the caches)
from portbench import spec  # noqa: E402

SERVE_CELLS = ["internlm2-1.8b.serve.chat", "mamba2-2.7b.serve.longdoc",
               "internlm2-1.8b.serve.longdoc"]
TRAIN_CELLS = ["internlm2-1.8b.train.8x4k", "internlm2-1.8b.train.8x4k-f32"]


def _entry(name, unit, source, moves, workloads, layer):
    return {"name": name, "unit": unit, "better": "lower", "source": source,
            "layer": layer, "moves": moves, "workloads": workloads}


#: the per-layer metrics that read the program's spans, as entries of
#: ``BENCHMARK.json``'s ``per_layer``
PENDING = [
    _entry("engine.queue_wait_p90_ms", "ms", "program_span", "serve_tokens_per_s",
           SERVE_CELLS, "engine serve/engine.py"),
    _entry("engine.decode_enqueue_ms", "ms", "program_span", "serve_tokens_per_s",
           SERVE_CELLS, "engine serve/engine.py"),
    _entry("engine.decode_sync_ms", "ms", "program_span", "serve_tokens_per_s",
           SERVE_CELLS, "engine serve/engine.py"),
    _entry("engine.launches_per_decode_step", "launches", "device_trace",
           "serve_tokens_per_s", SERVE_CELLS, "engine serve/engine.py"),
    _entry("engine.prefill_pad_share", "%", "program_span", "serve_tokens_per_s",
           ["internlm2-1.8b.serve.chat", "internlm2-1.8b.serve.longdoc"],
           "engine serve/engine.py"),
    _entry("train.forward_host_ms", "ms", "program_span", "train_tokens_per_s",
           TRAIN_CELLS, "train step train/train_step.py"),
    _entry("train.backward_host_ms", "ms", "program_span", "train_tokens_per_s",
           TRAIN_CELLS, "train step train/train_step.py"),
    _entry("train.launches_per_step", "launches", "device_trace", "train_tokens_per_s",
           TRAIN_CELLS, "train step train/train_step.py"),
]


@contextlib.contextmanager
def hooked(got: Dict):
    """A ``HostTracer`` handed to every engine and train step built
    inside, the traced reduction's ``spans`` and the record's
    ``host_spans``; the record lands in ``got["rec"]``."""
    import repro_torch.serve.engine as E
    import repro_torch.train.train_step as TS
    from portbench import serve, train
    from portbench import spans as S
    from portbench import trace as T
    from repro_torch.obs.host import HostTracer

    tracer = HostTracer()

    class Engine(E.ServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, host_tracer=tracer, **kw)

    def reduce_events(events, top=10):
        out = reduce_orig(events, top)
        out["spans"] = S.reduce_spans(events)
        return out

    def recorded(run_fn):
        @functools.wraps(run_fn)
        def fn(*a, **kw):
            rec = run_fn(*a, **kw)
            rec["host_spans"] = [s.to_dict() for s in tracer.spans]
            got["rec"] = rec
            return rec
        return fn

    reduce_orig = T.reduce_events
    saved = [(E, "ServeEngine"), (TS, "make_train_step"), (T, "reduce_events"),
             (serve, "run"), (train, "run")]
    olds = [getattr(m, a) for m, a in saved]
    new = [Engine, functools.partial(TS.make_train_step, host_tracer=tracer), reduce_events,
           recorded(serve.run), recorded(train.run)]
    try:
        for (m, a), v in zip(saved, new):
            setattr(m, a, v)
        yield tracer
    finally:
        for (m, a), v in zip(saved, olds):
            setattr(m, a, v)


def run_cell(bench: Dict, cell: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_process: float, root: Path = spec.ROOT,
             controls: Iterable[str] = (), pending: List[Dict] = PENDING) -> Dict:
    """``harness.run_cell``; with ``trace``, under ``hooked`` and with
    ``pending`` read, ``spans`` and ``window`` added before ``checks``."""
    from portbench.harness import run_cell as plain
    if not trace:
        return plain(bench, cell, seed, seconds, False, device=device, t_process=t_process,
                     root=root, controls=controls)
    bench = dict(bench, per_layer=bench["per_layer"] + pending)
    got: Dict = {}
    with hooked(got):
        out = plain(bench, cell, seed, seconds, True, device=device, t_process=t_process,
                    root=root, controls=controls)
    rec = got["rec"]
    checks = out.pop("checks")
    out["spans"] = (rec.get("trace") or {}).get("spans")
    out["window"] = spec.read_metrics(
        [m for m in spec.end_to_end(bench, cell) if m["name"] != "setup_s"], rec, root)
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    RUN._caches()
    import torch
    bench = spec.load_benchmark()
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                   t_process=RUN.T_PROCESS)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
