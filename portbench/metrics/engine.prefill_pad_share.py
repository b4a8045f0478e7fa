"""engine.prefill_pad_share: the padding of the window's prefills, in %:
the summed ``bucket - tokens`` of the ``serve.prefill`` spans that end in
the window over their summed ``bucket`` (``ServeEngine.stats``'
``prefill_padded_tokens`` over ``prefill_tokens`` plus it, counted where
each prefill happens). 0 where prefill runs at the exact length."""
from portbench import spans


def read(run):
    xs = spans.host_spans(run, "serve.prefill") if run["kind"] == "serve" else None
    if not xs:
        return None
    padded = sum(s["meta"]["bucket"] for s in xs)
    return 100.0 * sum(s["meta"]["bucket"] - s["meta"]["tokens"] for s in xs) / padded
