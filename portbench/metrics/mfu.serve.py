"""mfu.serve: model FLOPs of the window's prompts (unpadded) and decode
tokens (live rows at their fills) over the window's seconds, as a share
of the card's bf16 peak."""
from portbench import flops, stats


def read(run):
    if run["kind"] != "serve":
        return None
    m = run["model"]
    work = sum(flops.prefill_flops(m, n) for _, b, n in run["prefills"]
               if stats.in_window(run, b))
    work += sum(flops.decode_flops(m, fills) for _, b, fills in run["decodes"]
                if stats.in_window(run, b))
    return 100.0 * work / stats.window_s(run) / flops.PEAK_BF16
