"""ttft_p90_ms.host: the 90th percentile, over every request whose first token
falls in the window, of the time from its client's send to that token."""
from portbench import stats


def read(run):
    if run["kind"] != "serve":
        return None
    p = stats.percentile(stats.ttfts(run), 90)
    return None if p is None else 1e3 * p
