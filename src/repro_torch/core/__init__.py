"""core: the fabric of communication paths (``fabric``) and the
event-driven runtime that runs transfers over it in simulated time
(``runtime``).

Both are copies of the JAX package's jax-free modules of the same names
with the imports pointed at this package (``import repro`` loads jax):
the arithmetic is kept expression for expression, so simulated times,
rates and ledger state equal the JAX package's exactly.
``compression`` is the port's own int8 quantizer.
"""
