"""itl_p95_ms.host: the 95th percentile over every gap between consecutive
output tokens of a request that ends in the window."""
from portbench import stats


def read(run):
    if run["kind"] != "serve":
        return None
    p = stats.percentile(stats.itls(run), 95)
    return None if p is None else 1e3 * p
