"""engine.decode_enqueue_ms: the mean host time of ``serve.decode.enqueue``
(``M.decode_step`` up to its return: the host issuing a decode step's
launches) over the window's decode steps."""
from portbench import spans


def read(run):
    return spans.mean_ms(run, "serve.decode.enqueue") if run["kind"] == "serve" else None
