"""train.launches_per_step: the ``cudaLaunch*``/``cuLaunch*`` calls inside
the traced ``train.step`` spans, over their count."""
from portbench import spans


def read(run):
    return spans.traced(run, "train.step", "launches") if run["kind"] == "train" else None
