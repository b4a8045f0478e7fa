"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on NVIDIA cards.

``run.py`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line. Everything that belongs to one model configuration, one traffic
mix or one per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the model as it is run, its published
  source, the keys changed from it (``reduced``), the sizes assumed and
  the limits of the comparison that decides ``correct``;
- ``traffic/<traffic>.json``: the loop (``serve`` or ``train``) and its
  parameters (clients, slots, lengths, batch);
- ``metrics/<metric>.py``: one reader of a per-layer metric, ``read(run)``.

The yardstick is frozen here: the length laws (``traffic.py``), the
FLOP and byte counts and the peaks (``flops.py``), the reduction of the
profiler's trace (``trace.py``), the plain f32 reference
(``reference/``) and the comparison (``check.py``). From the program
the benchmark takes only the system under test. Nothing here imports
``jax`` or the JAX package ``repro``.
"""
