"""engine.queue_wait_p90_ms: the 90th percentile, over every request
whose ``serve.prefill`` starts in the window, of the time from its
``serve.request`` span's start (``ServeEngine.submit``) to that prefill's
start: how long a request waits in the engine's queue."""
from portbench import stats


def read(run):
    spans = run.get("host_spans")
    if run["kind"] != "serve" or spans is None:
        return None
    sent = {s["meta"]["rid"]: s["t_start"] for s in spans if s["name"] == "serve.request"}
    waits = [s["t_start"] - sent[s["meta"]["rid"]] for s in spans
             if s["name"] == "serve.prefill" and stats.in_window(run, s["t_start"])
             and s["meta"]["rid"] in sent]
    p = stats.percentile(waits, 90)
    return None if p is None else 1e3 * p
