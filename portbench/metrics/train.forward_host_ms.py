"""train.forward_host_ms: the host time of the ``train.forward`` spans
(``loss_fn``, one a microbatch) inside each ``train.step`` of the window,
over those steps."""
from portbench import spans


def read(run):
    return spans.per_step_ms(run, "train.forward") if run["kind"] == "train" else None
