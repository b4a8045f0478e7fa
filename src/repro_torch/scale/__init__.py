"""Open-loop arrival traces for the serving engines (``arrivals``): a
copy of the JAX package's ``scale/arrivals.py`` that makes the port's
``Request``, so the same (spec, seed) gives the same arrivals and
prompts in both packages.
"""
from repro_torch.scale.arrivals import (ArrivalGenerator, Burst, LengthSpec,
                                        TraceSpec, burst_trace)

__all__ = ["ArrivalGenerator", "Burst", "LengthSpec", "TraceSpec", "burst_trace"]
