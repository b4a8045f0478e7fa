"""train.device_ms_per_step: the device's busy time (the union of its
operations' intervals) over the traced steps, over their count."""


def read(run):
    tr = run.get("trace")
    if run["kind"] != "train" or not tr or tr["busy_s"] <= 0:
        return None
    return 1e3 * tr["busy_s"] / tr["steps"]
