"""engine.prefill_ms: host time of ``_prefill_request`` (which ends in a
host read of the first token): the window's prefill time over its count."""
from portbench import stats


def read(run):
    if run["kind"] != "serve":
        return None
    spans = [b - a for a, b, _ in run["prefills"] if stats.in_window(run, b)]
    return 1e3 * sum(spans) / len(spans) if spans else None
