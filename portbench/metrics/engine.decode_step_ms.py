"""engine.decode_step_ms: host time of a decode step, from the start of
``_decode_compute`` to the end of ``_finish_decode`` (which reads the
step's tokens to the host): the window's decode time over its steps."""
from portbench import stats


def read(run):
    if run["kind"] != "serve":
        return None
    spans = [b - a for a, b, _ in run["decodes"] if stats.in_window(run, b)]
    return 1e3 * sum(spans) / len(spans) if spans else None
