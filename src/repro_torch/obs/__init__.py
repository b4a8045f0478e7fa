"""Observability for the fabric runtime: typed span tracing
(``obs.trace``) and Chrome-trace export with text summaries
(``obs.export``). Copies of the JAX package's jax-free modules of the
same names, so the simulated results and the exported JSON are the
same.
"""
from repro_torch.obs.export import chrome_trace, dump, summary, validate_chrome_trace
from repro_torch.obs.trace import (BARRIER, COMPUTE, NULL_TRACER, PHASE, PROCESS,
                                   TRANSFER, NullTracer, Span, Tracer)

__all__ = [
    "BARRIER", "COMPUTE", "NULL_TRACER", "PHASE", "PROCESS", "TRANSFER",
    "NullTracer", "Span", "Tracer",
    "chrome_trace", "dump", "summary", "validate_chrome_trace",
]
