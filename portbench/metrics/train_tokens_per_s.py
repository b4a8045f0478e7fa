"""train_tokens_per_s: the tokens of every step completed in the window
over the wall time from the first such step's start to the last one's end."""


def read(run):
    if run["kind"] != "train" or not run["steps"]:
        return None
    span = run["steps"][-1][1] - run["steps"][0][0]
    return run["tokens_per_step"] * len(run["steps"]) / span
