"""engine.decode_sync_ms: the mean host time of ``serve.finish.sync`` (the
step's argmax and position reads to the host: the host waiting for the
device) over the window's decode steps."""
from portbench import spans


def read(run):
    return spans.mean_ms(run, "serve.finish.sync") if run["kind"] == "serve" else None
