"""Phases of the real model work on the host's wall clock.

``obs/trace.py`` traces the simulated fabric on its simulated clock (a
statement-for-statement copy of the JAX module). ``HostTracer`` is that
``Tracer`` on ``time.perf_counter``, for the serve engine
(``serve/engine.py``: ``serve.*``) and the train step
(``train/train_step.py``: ``train.*``). Each nested phase is mirrored
into ``torch.profiler``'s timeline while a profiler records, as a
``record_function`` range of the same name, so the device's kernels and
idle gaps can be put down to the program span the host was in. The
spans stay in memory; ``obs.export.dump`` writes them as Chrome-trace
JSON.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Iterator, List, Optional

from repro_torch.obs.trace import Span, Tracer


class WallClock:
    """The host's wall clock, ``time.perf_counter``, in seconds."""

    @property
    def now(self) -> float:
        return time.perf_counter()


class HostTracer(Tracer):
    """``open``/``close`` (and ``phase()``, which pairs them) nest on one
    stack: a phase's parent is the innermost open one, and phases close
    in the reverse order of opening. While a ``torch.profiler`` records,
    each also opens and closes a ``record_function`` range of its name,
    which the profiler's trace holds as a ``user_annotation`` on the
    clock of the kernels and launch calls. ``begin_phase``/``end_phase``
    mark an interval that outlives the stack (a request across engine
    steps): kept in ``spans``, not mirrored.

    The program's call sites hold ``None`` when tracing is off and test
    it before each call, so an untraced run makes no span and reads no
    clock. Record-only: a phase reads the clock and nothing else."""

    def __init__(self):
        import torch
        super().__init__(clock=WallClock())
        self._profiling = torch.autograd._profiler_enabled
        self._range = torch.autograd.profiler.record_function
        self._ranges: List[Any] = []     # each open() phase's range, or None

    def open(self, name: str, *, tenant: Optional[str] = None, **meta) -> Span:
        """Begin a phase inside the innermost open one."""
        span = self.begin_phase(name, tenant=tenant,
                                parent=self._stack[-1] if self._stack else None, **meta)
        self._stack.append(span)
        rng = None
        if self._profiling():
            rng = self._range(name)
            rng.__enter__()
        self._ranges.append(rng)
        return span

    def close(self, span: Span, **meta) -> None:
        """End ``span``, the innermost open phase; ``meta`` joins its own."""
        if not self._stack or self._stack[-1] is not span:
            raise RuntimeError(f"{span!r} is not the innermost open phase")
        self._stack.pop()
        rng = self._ranges.pop()
        if rng is not None:
            rng.__exit__(None, None, None)
        self.end_phase(span, **meta)

    @contextmanager
    def phase(self, name: str, *, tenant: Optional[str] = None,
              **meta) -> Iterator[Span]:
        span = self.open(name, tenant=tenant, **meta)
        try:
            yield span
        finally:
            self.close(span)
