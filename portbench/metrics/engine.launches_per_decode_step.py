"""engine.launches_per_decode_step: the ``cudaLaunch*``/``cuLaunch*`` calls
inside the traced window's ``serve.decode`` spans, over their count."""
from portbench import spans


def read(run):
    return spans.traced(run, "serve.decode", "launches") if run["kind"] == "serve" else None
