"""device_idle_share.train: the traced window's wall time not covered by
any device operation, as a share of the window."""


def read(run):
    tr = run.get("trace")
    if run["kind"] != "train" or not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
