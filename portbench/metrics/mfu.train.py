"""mfu.train: model FLOPs of the window's steps (6 x matrix params x
tokens plus causal attention, nothing recomputed) over their wall time,
as a share of the card's bf16 peak."""


def read(run):
    from portbench import flops
    if run["kind"] != "train" or not run["steps"]:
        return None
    span = run["steps"][-1][1] - run["steps"][0][0]
    return 100.0 * run["flops_per_step"] * len(run["steps"]) / span / flops.PEAK_BF16
