"""peak_mem_gib.serve: ``torch.cuda.max_memory_allocated()`` once the
window has closed, after a reset at set-up's start, in GiB."""


def read(run):
    if run["kind"] != "serve" or not run["memory_peak_bytes"]:
        return None
    return run["memory_peak_bytes"] / 2 ** 30
