"""The port's int8 blockwise quantization (the plain versions of K4a and
K4b, on the CPU) against the JAX package: ``repro.core.compression``
and the Pallas kernels in interpret mode. Inputs are made with numpy
from a seed and handed to both frameworks.

Tolerances: q, the scales, the dequantized values and the error-feedback
residual are bit-equal (0) with ``repro.core.compression`` run eagerly:
every step is one IEEE-rounded operation in both frameworks (a true
division, round half to even, an exact max). The Pallas kernel runs
jitted, and XLA turns its division by the constant 127 into a multiply
by the reciprocal, so its scales may sit one f32 ulp off; they are held
to the JAX package's own rel 1e-6 (``tests/test_kernels.py:86-87``),
its q and dequantized values to 0 in these cases.

Then AdamW with int8 moments where v's block rounds an element to 0
under a nonzero m: the port's update bit-equal to JAX's through the step
that divides m by eps."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings, strategies as st

from repro.core import compression as jc
from repro.kernels.quant.ops import dequantize_int8 as jax_dequant_pallas
from repro.kernels.quant.ops import quantize_int8 as jax_quant_pallas
from repro.optim import adamw as ja
from repro_torch.core import compression as tc
from repro_torch.kernels.quant.ops import dequantize, quantize
from repro_torch.optim import adamw as ta

# tests/test_kernels.py::test_quant_kernel_vs_ref's (n, block) cases
QUANT_CASES = [(1000, 128), (4096, 256), (17, 16)]


def _x(n, scale, seed=0):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def _check_equal(what, j, t):
    j, t = np.asarray(j), t.numpy()
    bad = int((j != t).sum()) if j.shape == t.shape else -1
    print(f"[parity] {what}: {bad} of {j.size} differ (tol 0)")
    assert j.shape == t.shape and j.dtype == t.dtype and bad == 0


@pytest.mark.parametrize("n,block", QUANT_CASES)
def test_quantize_vs_compression_and_pallas(n, block):
    x = _x(n, 3.0)
    qt = tc.quantize_int8_blockwise(torch.from_numpy(x), block)
    ref = jc.quantize_int8_blockwise(jnp.asarray(x), block)
    _check_equal(f"q vs compression n={n} block={block}", ref.q, qt.q)
    _check_equal(f"scale vs compression n={n} block={block}", ref.scale, qt.scale)
    qp, sp = jax_quant_pallas(jnp.asarray(x), block=block)          # interpret mode
    _check_equal(f"q vs Pallas n={n} block={block}", qp, qt.q)
    sp = np.asarray(sp[:, 0])
    rel = float(np.abs(sp - qt.scale.numpy()).max() / np.abs(sp).max())
    print(f"[parity] scale vs Pallas n={n} block={block}: max rel {rel:.3g} (tol 1e-6), "
          f"{int((sp != qt.scale.numpy()).sum())} of {sp.size} one ulp off")
    assert rel < 1e-6
    back = tc.dequantize_int8_blockwise(qt, (n,))
    _check_equal(f"dequantized vs compression n={n} block={block}",
                 jc.dequantize_int8_blockwise(ref, (n,)), back)
    _check_equal(f"dequantized vs Pallas n={n} block={block}",
                 jax_dequant_pallas(qp, jnp.asarray(qt.scale.numpy())[:, None], (n,)), back)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e-20, 1e6])
@pytest.mark.parametrize("n", [1, 255, 257, 77_777])
def test_quantize_scales_and_ragged_sizes(n, scale):
    """Ragged sizes (the tail read as zeros) at scales down to the
    denormal range and up to 1e6, f32 and bf16 input, f32 and bf16
    output."""
    x = _x(n, scale, seed=n)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        xt = torch.from_numpy(x).to(dtype)
        xj = jnp.asarray(x).astype(jdtype)
        qt = tc.quantize_int8_blockwise(xt)
        ref = jc.quantize_int8_blockwise(xj)
        _check_equal(f"q n={n} scale={scale} {dtype}", ref.q, qt.q)
        _check_equal(f"scale n={n} scale={scale} {dtype}", ref.scale, qt.scale)
        for out, jout in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            back = tc.dequantize_int8_blockwise(qt, (n,), out)
            jback = jc.dequantize_int8_blockwise(ref, (n,), jout)
            assert back.dtype == out
            _check_equal(f"dequantized n={n} scale={scale} {dtype}->{out}",
                         np.asarray(jback.astype(jnp.float32)), back.float())


def test_quantize_keeps_any_shape_and_empty():
    x = torch.from_numpy(_x(2 * 3 * 50, 1.0)).view(2, 3, 50)
    qt = tc.quantize_int8_blockwise(x, 64)
    assert qt.q.shape == (5, 64) and qt.scale.shape == (5,)
    assert tc.quantized_nbytes(qt) == 5 * 64 + 5 * 4
    back = tc.dequantize_int8_blockwise(qt, x.shape, torch.bfloat16)
    assert back.shape == x.shape and back.dtype == torch.bfloat16
    q, s = quantize(torch.zeros(0), 256)
    assert q.shape == (0, 256) and s.shape == (0,)
    assert dequantize(q, s, (0,)).shape == (0,)
    with pytest.raises(ValueError, match="more than"):
        dequantize(qt.q, qt.scale, (1000,))
    with pytest.raises(ValueError, match="positive"):
        quantize(x, 0)


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 2000), st.integers(3, 9), st.floats(0.1, 100.0))
@example(n=1545, logblock=6, scale=26.78125)
@example(n=1573, logblock=6, scale=56.07048330152059)
def test_quant_roundtrip_error_bound(n, logblock, scale):
    """|deq(q(x)) - x| <= half a quantization step, per block, plus the
    rounding of the two f32 operations that compute it
    (tests/test_property.py:23, on the port).

    ``core/compression.py`` quantizes with ``q = round(fl(x / s))`` and
    dequantizes with ``fl(q * s)``, s the block's f32 scale (``step``).
    Each f32 operation is off by at most half an ulp, 2^-24 of its
    result: ``|fl(x / s) - x / s| <= 2^-24 |x| / s`` and ``|fl(q s) - q s|
    <= 2^-24 (|x| + s)``. So ``|deq - x| <= s / 2 + 2^-23 |x| + 2^-24 s``,
    held here as ``step / 2 + 2^-22 (|x| + step)`` in float64. The
    reference test's ``step * 0.5 + 1e-6`` is below that at |x| near 60
    (the two ``@example``s: one element of the first lies 1.46e-6 past
    it). q, the scales and the dequantized values are bit-equal with the
    JAX package's at every draw."""
    block = 2 ** logblock
    x = np.random.RandomState(n).randn(n).astype(np.float32) * scale
    qt = tc.quantize_int8_blockwise(torch.from_numpy(x), block)
    back = tc.dequantize_int8_blockwise(qt, (n,)).numpy()
    ref = jc.quantize_int8_blockwise(jnp.asarray(x), block)
    assert np.array_equal(np.asarray(ref.q), qt.q.numpy())
    assert np.array_equal(np.asarray(ref.scale), qt.scale.numpy())
    assert np.array_equal(np.asarray(jc.dequantize_int8_blockwise(ref, (n,))), back)
    step = np.repeat(qt.scale.numpy(), block)[:n].astype(np.float64)
    err = np.abs(back.astype(np.float64) - x.astype(np.float64))
    assert (err <= step * 0.5 + 2.0 ** -22 * (np.abs(x.astype(np.float64)) + step)).all()


@pytest.mark.parametrize("block", [16, 256])
def test_compress_with_feedback_residual_parity(block):
    """Four rounds of error-feedback compression: q, scales and the
    residual carried bit-equal with the JAX package's; the sum of what
    was sent plus the final residual is the sum of the true grads."""
    rng = np.random.default_rng(block)
    n = 1000
    jef = jc.ErrorFeedback.init((n,))
    tef = tc.ErrorFeedback.init((n,), device="cpu")
    sent, true = np.zeros(n, np.float32), np.zeros(n, np.float32)
    for i in range(4):
        g = (rng.standard_normal(n) * 10.0 ** (i - 2)).astype(np.float32)
        jq, jef = jc.compress_with_feedback(jnp.asarray(g), jef, block=block)
        tq, tef = tc.compress_with_feedback(torch.from_numpy(g), tef, block=block)
        _check_equal(f"feedback q round {i} block={block}", jq.q, tq.q)
        _check_equal(f"feedback scale round {i} block={block}", jq.scale, tq.scale)
        _check_equal(f"feedback residual round {i} block={block}", jef.residual, tef.residual)
        sent += tc.dequantize_int8_blockwise(tq, (n,)).numpy()
        true += g
    assert np.allclose(sent + tef.residual.numpy(), true, atol=1e-4)


def test_error_feedback_init_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.ErrorFeedback.init((4,))


def test_int8_moments_zero_v_matches_jax():
    """Int8 AdamW moments where v's block quantizes to 0 under a nonzero
    m: one leaf (1, 256), params 0.02 N(0, 1), step 1's grad 1 at element
    0 and 1e-2 N(0, 1) elsewhere (numpy seed 0), step 2's grad element 0
    alone; lr 1e-3, no clipping, no decay. v's block scale is set by
    element 0 (254x the others' v and more), so their v rounds to 0 while
    their m does not, and step 2 divides m by eps. The port's whole-leaf
    ``adamw_update`` and JAX's are bit-equal after each step, params and
    both moments' q and scale: the blow-up is the reference's own
    arithmetic (``repro/optim/adamw.py:86`` on
    ``repro/core/compression.py:76-77``)."""
    rng = np.random.default_rng(0)
    p0 = (0.02 * rng.standard_normal((1, 256))).astype(np.float32)
    g1 = (1e-2 * rng.standard_normal((1, 256))).astype(np.float32)
    g1[0, 0] = 1.0
    g2 = np.zeros((1, 256), np.float32)
    g2[0, 0] = 1.0
    kw = dict(lr=1e-3, grad_clip=0.0, weight_decay=0.0, moments="int8")
    jp, tp = {"w": jnp.asarray(p0)}, {"w": torch.from_numpy(p0.copy())}
    js, ts = ja.adamw_init(jp, moments="int8"), ta.adamw_init(tp, moments="int8")
    before = p0
    for step, g in enumerate((g1, g2), 1):
        jp, js, _ = ja.adamw_update({"w": jnp.asarray(g)}, js, jp, **kw)
        tp, ts, _ = ta.adamw_update({"w": torch.from_numpy(g.copy())}, ts, tp, **kw)
        _check_equal(f"int8 moments step {step} params", jp["w"], tp["w"])
        for name in ("m", "v"):
            _check_equal(f"int8 moments step {step} {name}.q", getattr(js, name)["w"].q,
                         getattr(ts, name)["w"].q)
            _check_equal(f"int8 moments step {step} {name}.scale",
                         getattr(js, name)["w"].scale, getattr(ts, name)["w"].scale)
        after = tp["w"].numpy().copy()
        hazard = int(((ts.v["w"].q == 0) & (ts.m["w"].q != 0)).sum())
        print(f"[parity] int8 moments step {step}: max|dp| {np.abs(after - before).max():.6g}, "
              f"{hazard} of 256 values with v's int8 0 under a nonzero m")
        before = after
    assert np.abs(after - p0).max() > 1.0          # the blow-up is there, in both
