"""mfu.serve.hybrid: model FLOPs of the window's prompts and decode
tokens (live rows at their fills), counted for the hybrid family by
``flops_hybrid.py`` (mixers by kind, router, shared expert, the held
experts' share of the routed ones), over the window's seconds, as a
share of the card's bf16 peak. Nothing to read for other families."""
from portbench import flops, flops_hybrid, stats


def read(run):
    if run["kind"] != "serve" or run["model"].get("family") != "hybrid":
        return None
    m = run["model"]
    work = sum(flops_hybrid.prefill_flops(m, n) for _, b, n in run["prefills"]
               if stats.in_window(run, b))
    work += sum(flops_hybrid.decode_flops(m, fills) for _, b, fills in run["decodes"]
                if stats.in_window(run, b))
    return 100.0 * work / stats.window_s(run) / flops.PEAK_BF16
