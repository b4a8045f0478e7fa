"""The port's attention kernels (their plain versions, on the CPU) against
the JAX package: the Pallas kernels in interpret mode and the plain
functions the JAX model calls. Inputs are made with numpy from a seed
and handed to both frameworks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention_kernel as jax_decode_kernel
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.models.attention import attention_ref as jax_attention_ref
from repro.models.attention import decode_attention as jax_decode_attention
from repro_torch.kernels.decode_attention.ops import decode_attention_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import attention as attn
from test_kernels import DEC_CASES, FA_CASES


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pair(x, bf16):
    """The same values in both frameworks (bf16 rounds alike from f32)."""
    if bf16:
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _err(j, t):
    return float(np.abs(np.asarray(j.astype(jnp.float32)) - t.float().numpy()).max())


def _check(what, err, tol):
    """Hold a max abs error to its tolerance and print it (``-s`` shows
    the parity table that PERF.md quotes)."""
    print(f"[parity] {what}: max abs err {err:.3g} (tol {tol})")
    assert err < tol


@pytest.mark.parametrize("case", FA_CASES)
def test_flash_plain_vs_pallas(case):
    b, s, hq, hkv, d, win, cap, qb, kb, dt = case
    bf16 = dt == jnp.bfloat16
    rng = np.random.default_rng(0)
    qj, qt = _pair(_normal(rng, (b, s, hq, d)), bf16)
    kj, kt = _pair(_normal(rng, (b, s, hkv, d)), bf16)
    vj, vt = _pair(_normal(rng, (b, s, hkv, d)), bf16)
    ref = jax_flash(qj, kj, vj, causal=True, window=win, softcap=cap,
                    q_block=qb, kv_block=kb)
    out = flash_attention(qt, kt, vt, causal=True, window=win, softcap=cap)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    _check(f"flash_attention vs Pallas {case[:-1]} {np.dtype(dt).name}", _err(ref, out),
           2e-2 if bf16 else 2e-5)


@pytest.mark.parametrize("case", DEC_CASES)
def test_decode_plain_vs_pallas(case):
    b, s, hq, hkv, d, win, cap, clen = case
    rng = np.random.default_rng(1)
    qj, qt = _pair(_normal(rng, (b, 1, hq, d)), False)
    kj, kt = _pair(_normal(rng, (b, s, hkv, d)), False)
    vj, vt = _pair(_normal(rng, (b, s, hkv, d)), False)
    ref = jax_decode_kernel(qj, kj, vj, jnp.asarray(clen), window=win,
                            softcap=cap, kv_block=128)
    out = decode_attention_kernel(qt, kt, vt, clen, window=win, softcap=cap)
    _check(f"decode_attention vs Pallas {case}", _err(ref, out), 2e-5)


PER_ROW_CASES = [
    # B, S, Hq, Hkv, d, window, softcap, per-row lengths, q bf16, cache bf16
    (4, 64, 4, 2, 16, None, None, (1, 64, 17, 33), False, False),
    (3, 128, 8, 2, 32, 24, 30.0, (128, 5, 77), False, False),
    (4, 64, 4, 2, 16, None, None, (1, 64, 9, 40), True, False),
    (2, 96, 4, 1, 16, 16, None, (96, 3), True, True),
]


@pytest.mark.parametrize("case", PER_ROW_CASES)
def test_decode_per_row_vs_model_decode(case):
    """Per-row cache lengths (the engine's continuous batching) against
    the plain decode_attention the JAX model calls."""
    b, s, hq, hkv, d, win, cap, lens, q16, c16 = case
    rng = np.random.default_rng(2)
    qj, qt = _pair(_normal(rng, (b, 1, hq, d)), q16)
    kj, kt = _pair(_normal(rng, (b, s, hkv, d)), c16)
    vj, vt = _pair(_normal(rng, (b, s, hkv, d)), c16)
    lens = np.asarray(lens, np.int32)
    ref = jax_decode_attention(qj, kj, vj, jnp.asarray(lens), window=win, softcap=cap)
    out = decode_attention_kernel(qt, kt, vt, torch.from_numpy(lens),
                                  window=win, softcap=cap)
    assert out.dtype == vt.dtype
    _check(f"decode_attention per-row vs decode_attention {case}", _err(ref, out),
           2e-2 if c16 else 2e-5)


@pytest.mark.parametrize("s,win", [(100, None), (37, 16), (129, None)])
def test_flash_ragged_length_vs_attention_ref(s, win):
    """Lengths off any block size (the engine's unbucketed prefill)."""
    rng = np.random.default_rng(3)
    qj, qt = _pair(_normal(rng, (2, s, 4, 32)), False)
    kj, kt = _pair(_normal(rng, (2, s, 2, 32)), False)
    vj, vt = _pair(_normal(rng, (2, s, 2, 32)), False)
    ref = jax_attention_ref(qj, kj, vj, causal=True, window=win)
    out = flash_attention(qt, kt, vt, causal=True, window=win)
    _check(f"flash_attention ragged S={s} window={win} vs attention_ref", _err(ref, out), 2e-5)


def test_dispatch_takes_plain_versions_on_cpu():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(_normal(rng, (1, 16, 4, 16)))
    k = torch.from_numpy(_normal(rng, (1, 16, 2, 16)))
    for impl in ("auto", "ref"):
        torch.testing.assert_close(attn.attention(q, k, k, impl=impl),
                                   attn.attention_ref(q, k, k), rtol=0, atol=0)
        torch.testing.assert_close(
            attn.decode(q[:, :1], k, k, torch.tensor([3]), impl=impl),
            attn.decode_attention(q[:, :1], k, k, torch.tensor([3])), rtol=0, atol=0)
    with pytest.raises(ValueError):
        attn.attention(q, k, k, impl="pallas")
