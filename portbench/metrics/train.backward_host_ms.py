"""train.backward_host_ms: the host time of the ``train.backward`` spans
(``torch.autograd.grad``, one a microbatch) inside each ``train.step`` of
the window, over those steps."""
from portbench import spans


def read(run):
    return spans.per_step_ms(run, "train.backward") if run["kind"] == "train" else None
