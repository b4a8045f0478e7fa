"""serve_tokens_per_s: output tokens emitted in the window (first tokens
included) over the window's seconds."""
from portbench import stats


def read(run):
    if run["kind"] != "serve":
        return None
    return len(stats.token_times(run)) / stats.window_s(run)
