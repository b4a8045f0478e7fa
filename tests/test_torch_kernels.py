"""The port's kernels (their plain versions, on the CPU) against the JAX
package: the Pallas kernels in interpret mode and the plain functions
the JAX model calls (attention, and the SSD scan with the rest of
``models/ssm.py``). Inputs are made with numpy from a seed and handed to
both frameworks."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention_kernel as jax_decode_kernel
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.models.attention import attention_ref as jax_attention_ref
from repro.models.attention import decode_attention as jax_decode_attention
from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro.models import ssm as jssm
from repro_torch.kernels.decode_attention.ops import SMS, decode_attention_kernel, split_rows
from repro_torch.kernels.decode_attention.ref import decode_attention_split_emulation
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref, ssd_tensor_core_emulation
from repro_torch.models import attention as attn
from repro_torch.models import ssm as tssm
from test_kernels import DEC_CASES, FA_CASES, SSD_CASES


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


# K1 at head dim 256 (B, S, Hq, Hkv, window, softcap, q scale, dtype):
# gemma2-9b's shape cut to size (G = 2, a window shorter than S that
# starts inside a 64-key block, softcap 50) and gemma-7b's (MHA, causal).
# The q scale multiplies the rows of every second group of 16, so that
# their scores reach the softcap, as gemma2's logits do
HD256_CASES = [(1, 256, 4, 2, 100, 50.0, 1.0, dt) for dt in (jnp.float32, jnp.bfloat16)] + [
    (1, 256, 4, 4, None, None, 1.0, dt) for dt in (jnp.float32, jnp.bfloat16)] + [
    (1, 256, 4, 2, 100, 50.0, 40.0, dt) for dt in (jnp.float32, jnp.bfloat16)]


@pytest.mark.parametrize("case", HD256_CASES)
def test_flash_hd256_plain_vs_pallas(case):
    b, s, hq, hkv, win, cap, qs, dt = case
    bf16 = dt == jnp.bfloat16
    rng = np.random.default_rng(5)
    q = _normal(rng, (b, s, hq, 256))
    q[:, (np.arange(s) // 16) % 2 == 1] *= qs
    qj, qt = _pair(q, bf16)
    kj, kt = _pair(_normal(rng, (b, s, hkv, 256)), bf16)
    vj, vt = _pair(_normal(rng, (b, s, hkv, 256)), bf16)
    ref = jax_flash(qj, kj, vj, causal=True, window=win, softcap=cap, q_block=64, kv_block=64)
    out = flash_attention(qt, kt, vt, causal=True, window=win, softcap=cap)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    _check(f"flash_attention hd 256 vs Pallas {case[:-1]} {np.dtype(dt).name}", _err(ref, out),
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


# K2's split pass and LSE merge (ref.decode_attention_split_emulation):
# rows a split, None for the one-split schedule (split_rows = S)
SPLIT_ROWS = (16, 64, None)
# B, S, Hq, Hkv, d, window, softcap, per-row lengths: lengths on and off
# split edges; a window that starts inside a split; cache_len 1 and 0
SPLIT_EDGE_CASES = [
    (4, 128, 4, 2, 32, None, None, (16, 17, 64, 65)),
    (3, 128, 8, 2, 32, 40, None, (100, 70, 128)),
    (3, 128, 4, 1, 16, 24, 30.0, (1, 0, 128)),
    # G = 16, the tensor-core pass (16-key chunks, stages of 64 keys): the
    # same edges, and a window that starts inside a split and a stage
    (4, 128, 32, 2, 32, None, None, (16, 17, 64, 65)),
    (3, 128, 16, 1, 64, 40, None, (100, 70, 128)),
    (3, 128, 32, 2, 16, 24, 30.0, (1, 0, 128)),
]


@pytest.mark.parametrize("rows", SPLIT_ROWS)
@pytest.mark.parametrize("case", DEC_CASES)
def test_decode_split_emulation_vs_pallas(case, rows):
    """The kernel's split and merge against the Pallas kernel on the JAX
    package's decode cases (the inputs of test_decode_plain_vs_pallas)."""
    b, s, hq, hkv, d, win, cap, clen = case
    rng = np.random.default_rng(1)
    qj, qt = _pair(_normal(rng, (b, 1, hq, d)), False)
    kj, kt = _pair(_normal(rng, (b, s, hkv, d)), False)
    vj, vt = _pair(_normal(rng, (b, s, hkv, d)), False)
    ref = jax_decode_kernel(qj, kj, vj, jnp.asarray(clen), window=win,
                            softcap=cap, kv_block=128)
    out = decode_attention_split_emulation(qt, kt, vt, clen, rows or s, window=win,
                                           softcap=cap)
    _check(f"decode split emulation rows={rows or s} vs Pallas {case}", _err(ref, out), 2e-5)


@pytest.mark.parametrize("scalar", [False, True], ids=["per_row", "scalar"])
@pytest.mark.parametrize("rows", SPLIT_ROWS)
@pytest.mark.parametrize("case", PER_ROW_CASES)
def test_decode_split_emulation_vs_model_decode(case, rows, scalar):
    """Against the plain decode_attention the JAX model calls, with
    per-row lengths and with one scalar length (the first row's)."""
    b, s, hq, hkv, d, win, cap, lens, q16, c16 = case
    rng = np.random.default_rng(2)
    qj, qt = _pair(_normal(rng, (b, 1, hq, d)), q16)
    kj, kt = _pair(_normal(rng, (b, s, hkv, d)), c16)
    vj, vt = _pair(_normal(rng, (b, s, hkv, d)), c16)
    lens = np.asarray(lens[0] if scalar else lens, np.int32)
    ref = jax_decode_attention(qj, kj, vj, jnp.asarray(lens), window=win, softcap=cap)
    out = decode_attention_split_emulation(qt, kt, vt, torch.from_numpy(lens), rows or s,
                                           window=win, softcap=cap)
    assert out.dtype == vt.dtype and out.shape == qt.shape
    _check(f"decode split emulation rows={rows or s} vs decode_attention {case} "
           f"cache_len={lens.tolist()}", _err(ref, out), 2e-2 if c16 else 2e-5)


@pytest.mark.parametrize("rows", SPLIT_ROWS)
@pytest.mark.parametrize("case", SPLIT_EDGE_CASES)
def test_decode_split_emulation_edges_vs_pallas(case, rows):
    """Split edges, windows and lengths 1 and 0, each row against the
    Pallas kernel at its own scalar length: a row with no visible key is
    0, as Pallas gives it."""
    b, s, hq, hkv, d, win, cap, lens = case
    rng = np.random.default_rng(5)
    qj, qt = _pair(_normal(rng, (b, 1, hq, d)), False)
    kj, kt = _pair(_normal(rng, (b, s, hkv, d)), False)
    vj, vt = _pair(_normal(rng, (b, s, hkv, d)), False)
    out = decode_attention_split_emulation(qt, kt, vt, torch.tensor(lens), rows or s,
                                           window=win, softcap=cap)
    for i, n in enumerate(lens):
        ref = jax_decode_kernel(qj[i:i + 1], kj[i:i + 1], vj[i:i + 1], jnp.asarray(n),
                                window=win, softcap=cap, kv_block=128)
        _check(f"decode split emulation rows={rows or s} vs Pallas {case[:7]} row {i} "
               f"cache_len={n}", _err(ref, out[i:i + 1]), 2e-5)
        if n == 0:
            assert out[i].abs().max().item() == 0.0


def test_split_rows_depends_on_shapes_only():
    """split_rows reads B, S, Hkv and hd, never cache_len; a full cache at
    the serve path's decode shape (4 slots, max_len 1024, 8 kv heads of
    128) gives at least two blocks an SM; a floor keeps short caches in
    one split; it stays within [1, S]."""
    assert list(inspect.signature(split_rows).parameters) == ["b", "s", "hkv", "hd"]
    rows = split_rows(4, 1024, 8, 128)
    assert rows == 64 and 4 * 8 * -(-1024 // rows) >= 2 * SMS
    for b, s, hkv, hd in [(1, 256, 8, 128), (2, 512, 2, 64), (1, 1024, 2, 256),
                          (64, 1024, 8, 128), (1, 8, 1, 16), (3, 100, 4, 128)]:
        r = split_rows(b, s, hkv, hd)
        assert 1 <= r <= s and r == split_rows(b, s, hkv, hd)
        assert r >= min(s, 8192 // hd)                   # the floor
    assert split_rows(1, 48, 8, 128) == 48                 # below the floor: one split


def test_decode_split_emulation_path_shape():
    """The serve path's decode shape with the wrapper's own split_rows:
    B=4, max_len 1024, 16 q / 8 kv heads of 128, f32 cache, bf16 q,
    lengths [1, 1024, 300, 77], against the model's decode_attention."""
    rng = np.random.default_rng(6)
    qj, qt = _pair(_normal(rng, (4, 1, 16, 128)), True)
    kj, kt = _pair(_normal(rng, (4, 1024, 8, 128)), False)
    vj, vt = _pair(_normal(rng, (4, 1024, 8, 128)), False)
    lens = np.asarray([1, 1024, 300, 77], np.int32)
    ref = jax_decode_attention(qj, kj, vj, jnp.asarray(lens))
    out = decode_attention_split_emulation(qt, kt, vt, torch.from_numpy(lens),
                                           split_rows(4, 1024, 8, 128))
    _check("decode split emulation at the path shape vs decode_attention", _err(ref, out), 2e-5)


# K2 at G = 16 (B, S, Hq, Hkv, hd, window, softcap, per-row lengths):
# glm4-9b's decode shape (32 q heads over 2 kv heads of 128, 4 slots,
# max_len 1024) at the serve path's lengths, and a window across split
# edges with a softcap and cache_len 1. (cache_len 0, where the kernel
# gives 0 as Pallas does and the model's decode_attention a mean of v,
# is held to Pallas in test_decode_split_emulation_edges_vs_pallas.)
G16_CASES = [(4, 1024, 32, 2, 128, None, None, (1, 1024, 300, 77)),
             (3, 256, 16, 1, 64, 40, 30.0, (256, 65, 1)),
             (2, 128, 32, 2, 32, None, 50.0, (1, 100))]


# chip_smoke.py's DEC_SPLIT_CASES at G = 16 (B, S, Hq, Hkv, hd, window,
# softcap, per-row lengths, cache dtype or None for q's)
G16_SPLIT_CASES = [(4, 1024, 32, 2, 128, None, None, (1, 1024, 300, 77), None),
                   (4, 1024, 32, 2, 128, 200, 30.0, (64, 65, 1024, 1), None),
                   (4, 1024, 32, 2, 256, 300, None, (1024, 1, 333, 64), None),
                   (4, 1024, 32, 2, 128, None, None, (9, 1024, 130, 1), "float32")]


@pytest.mark.parametrize("rows", [None, "wrapper"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", G16_CASES + G16_SPLIT_CASES)
def test_decode_tensor_core_emulation_vs_pallas(case, bf16, rows):
    """The tensor-core split pass's arithmetic (``_tc_split_state``: bf16
    terms, 16-key chunks, stages, the lanes' sums) and the single-pass
    merge, at the wrapper's split_rows and in one split, each row against
    the Pallas kernel (interpret mode) at its own scalar length, and the
    batch against JAX's decode_attention: 2e-5 in f32, 2e-2 where bf16
    rounds the output (q and cache in f32, or q in bf16 and the cache in
    the case's dtype; the port's output has the cache's dtype, the Pallas
    kernel's q's, JAX's decode_attention the cache's)."""
    b, s, hq, hkv, d, win, cap, lens, *cache = case
    cache = cache[0] if cache else None
    rng = np.random.default_rng(8)
    c16 = bf16 and cache != "float32"
    qj, qt = _pair(_normal(rng, (b, 1, hq, d)), bf16)
    kj, kt = _pair(_normal(rng, (b, s, hkv, d)), c16)
    vj, vt = _pair(_normal(rng, (b, s, hkv, d)), c16)
    r = split_rows(b, s, hkv, d) if rows else s
    out = decode_attention_split_emulation(qt, kt, vt, torch.tensor(lens), r, window=win,
                                           softcap=cap)
    assert out.dtype == vt.dtype and out.shape == qt.shape
    tol = 2e-2 if c16 else 2e-5
    tol_pallas = 2e-2 if bf16 else 2e-5
    what = f"rows={r} {case[:7]} q {'bf16' if bf16 else 'f32'} cache {vt.dtype}"
    for i, n in enumerate(lens):
        ref = jax_decode_kernel(qj[i:i + 1], kj[i:i + 1], vj[i:i + 1], jnp.asarray(n),
                                window=win, softcap=cap, kv_block=128)
        _check(f"decode tensor-core emulation {what} vs Pallas row {i} cache_len={n}",
               _err(ref, out[i:i + 1]), tol_pallas)
    ref = jax_decode_attention(qj, kj, vj, jnp.asarray(np.asarray(lens, np.int32)),
                               window=win, softcap=cap)
    _check(f"decode tensor-core emulation {what} vs decode_attention", _err(ref, out), tol)


@pytest.mark.parametrize("case", G16_CASES)
def test_decode_g16_vs_model_decode(case):
    """16 q heads to a kv head: the wrapper's plain version (bf16 q, f32
    cache, the serve path's dtypes) and the kernel's split and merge at
    the wrapper's own split_rows, each against the JAX model's
    decode_attention: max abs 2e-5 (f32 softmax in both)."""
    b, s, hq, hkv, d, win, cap, lens = case
    rng = np.random.default_rng(7)
    qj, qt = _pair(_normal(rng, (b, 1, hq, d)), True)
    kj, kt = _pair(_normal(rng, (b, s, hkv, d)), False)
    vj, vt = _pair(_normal(rng, (b, s, hkv, d)), False)
    lens = np.asarray(lens, np.int32)
    ref = jax_decode_attention(qj, kj, vj, jnp.asarray(lens), window=win, softcap=cap)
    out = decode_attention_kernel(qt, kt, vt, torch.from_numpy(lens), window=win, softcap=cap)
    rows = split_rows(b, s, hkv, d)
    split = decode_attention_split_emulation(qt, kt, vt, torch.from_numpy(lens), rows,
                                             window=win, softcap=cap)
    assert out.shape == qt.shape and out.dtype == torch.float32
    _check(f"decode_attention G={hq // hkv} vs decode_attention {case}", _err(ref, out), 2e-5)
    _check(f"decode split emulation G={hq // hkv} rows={rows} vs decode_attention {case}",
           _err(ref, split), 2e-5)


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


@pytest.mark.parametrize("s,d", [(s, d) for s in (37, 100, 300, 511) for d in (128, 64, 256)])
def test_flash_ragged_batch_bf16_vs_attention_ref(s, d):
    """The card's ragged cases for the bf16 tensor-core path (B=2, a
    partial last tile, two q heads per kv head), here on the plain path."""
    rng = np.random.default_rng(4)
    qj, qt = _pair(_normal(rng, (2, s, 4, d)), True)
    kj, kt = _pair(_normal(rng, (2, s, 2, d)), True)
    vj, vt = _pair(_normal(rng, (2, s, 2, d)), True)
    ref = jax_attention_ref(qj, kj, vj, causal=True)
    out = flash_attention(qt, kt, vt, causal=True)
    assert out.dtype == torch.bfloat16 and out.shape == qt.shape
    _check(f"flash_attention ragged B=2 S={s} hd={d} bf16 vs attention_ref", _err(ref, out),
           2e-2)


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


# ----------------------------------------------------------------------
# SSD scan and the rest of models/ssm.py
# ----------------------------------------------------------------------

SSD_TOL = 5e-3          # tests/test_kernels.py: the scan against the recurrence
CHUNKED_TOL = 2e-3      # tests/test_ssm.py: chunked against sequential, f32


def _ssd_inputs(rng, b, s, h, p, n):
    """x, dt (softplus, > 0), A (< 0), Bm, C as f32 numpy, as test_ssm.py
    draws them."""
    x = _normal(rng, (b, s, h, p))
    dt = np.log1p(np.exp(_normal(rng, (b, s, h)))).astype(np.float32)
    A = (-np.exp(_normal(rng, (h,)))).astype(np.float32)
    return x, dt, A, _normal(rng, (b, s, n)), _normal(rng, (b, s, n))


def _both(arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_plain_vs_pallas(case):
    b, s, h, p, n, L, ht = case
    arrs_j, arrs_t = _both(_ssd_inputs(np.random.default_rng(5), b, s, h, p, n))
    yj, hj = jax_ssd_scan(*arrs_j, chunk=L, head_tile=ht)
    yt, htt = ssd_scan(*arrs_t, chunk=L)
    assert yt.dtype == htt.dtype == torch.float32
    assert yt.shape == (b, s, h, p) and htt.shape == (b, h, p, n)
    _check(f"ssd_scan y vs Pallas {case}", _err(yj, yt), SSD_TOL)
    _check(f"ssd_scan h vs Pallas {case}", _err(hj, htt), SSD_TOL)


@pytest.mark.parametrize("s,chunk", [(37, 16), (100, 32), (129, 16), (129, 32)])
def test_ssd_scan_ragged_vs_ssd_ref(s, chunk):
    """Lengths off the chunk (the engine's exact-length SSM prefill),
    which the Pallas kernel cannot take, against the recurrence; x, B, C
    in bf16 as the model gives them."""
    x, dt, A, Bm, C = _ssd_inputs(np.random.default_rng(6), 2, s, 3, 8, 16)
    xj, xt = _pair(x, True)
    bj, bt = _pair(Bm, True)
    cj, ct = _pair(C, True)
    yj, hj = jssm.ssd_ref(xj.astype(jnp.float32), jnp.asarray(dt), jnp.asarray(A),
                          bj, cj)
    yt, htt = ssd_scan(xt, torch.from_numpy(dt), torch.from_numpy(A), bt, ct,
                       chunk=chunk)
    assert yt.dtype == torch.float32
    _check(f"ssd_scan ragged S={s} chunk={chunk} y vs ssd_ref", _err(yj, yt), SSD_TOL)
    _check(f"ssd_scan ragged S={s} chunk={chunk} h vs ssd_ref", _err(hj, htt), SSD_TOL)


SSM_LAYER_TOL = 1e-4    # chip_smoke.py: K3 against the plain scan in each mamba2 layer


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_tensor_core_emulation_vs_jax(case):
    """The tensor-core path's arithmetic (64-token chunks, f32 operands
    as three bf16 terms, states passed in f32) on bf16 x/B/C against JAX's
    chunked scan and the Pallas kernel in interpret mode, both in f32 on
    the same bf16 values."""
    b, s, h, p, n, L, ht = case
    x, dt, A, Bm, C = _ssd_inputs(np.random.default_rng(9), b, s, h, p, n)
    (xj, xt), (bj, bt), (cj, ct) = (_pair(v, True) for v in (x, Bm, C))
    y, hf = ssd_tensor_core_emulation(xt, torch.from_numpy(dt), torch.from_numpy(A), bt, ct)
    assert y.dtype == hf.dtype == torch.float32
    assert y.shape == (b, s, h, p) and hf.shape == (b, h, p, n)
    f32 = [v.astype(jnp.float32) for v in (xj, bj, cj)]
    dtj, Aj = jnp.asarray(dt), jnp.asarray(A)
    yc, hc = jssm.ssd_chunked(f32[0], dtj, Aj, f32[1], f32[2], chunk=L)
    yp, hp = jax_ssd_scan(f32[0], dtj, Aj, f32[1], f32[2], chunk=L, head_tile=ht)
    _check(f"tensor-core emulation y vs JAX ssd_chunked {case}", _err(yc, y), SSD_TOL)
    _check(f"tensor-core emulation h vs JAX ssd_chunked {case}", _err(hc, hf), SSD_TOL)
    _check(f"tensor-core emulation y vs Pallas {case}", _err(yp, y), SSD_TOL)
    _check(f"tensor-core emulation h vs Pallas {case}", _err(hp, hf), SSD_TOL)


def _silu(v):
    return (v / (1.0 + np.exp(-v))).astype(np.float32)


@pytest.mark.parametrize("b,s", [(1, 300), (2, 100)])
def test_ssd_tensor_core_emulation_mamba2_like(b, s):
    """At mamba2-2.7b's head shape (P=64, N=128), four heads, inputs
    distributed as chip_smoke.py makes them (silu'd bf16 x/B/C, dt =
    softplus(z - 4), A in [-16, -1]): the emulation against the plain
    chunked scan in f32 (the model's chunk of 256), relative to the
    largest magnitude, under the per-layer limit the card is held to."""
    rng = np.random.default_rng(10)
    x = torch.from_numpy(_silu(_normal(rng, (b, s, 4, 64)))).to(torch.bfloat16)
    dt = torch.from_numpy(np.log1p(np.exp(_normal(rng, (b, s, 4)) - 4.0)).astype(np.float32))
    A = torch.from_numpy((-(1.0 + 15.0 * rng.random(4))).astype(np.float32))
    Bm, C = (torch.from_numpy(_silu(_normal(rng, (b, s, 128)))).to(torch.bfloat16)
             for _ in range(2))
    y, hf = ssd_tensor_core_emulation(x, dt, A, Bm, C)
    yr, hr = ssd_chunked_ref(x.float(), dt, A, Bm.float(), C.float(), chunk=256)
    for what, out, ref in (("y", y, yr), ("h", hf, hr)):
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        print(f"[parity] tensor-core emulation {what} B={b} S={s} H=4 P=64 N=128 vs "
              f"ssd_chunked f32: rel err {rel:.3g} (tol {SSM_LAYER_TOL})")
        assert rel < SSM_LAYER_TOL


@pytest.mark.parametrize("case", [(2, 64, 4, 8, 16, 16), (1, 100, 3, 16, 8, 32),
                                  (2, 256, 8, 16, 32, 64)])
def test_ssd_chunked_vs_jax(case):
    """tests/test_ssm.py's CASES: the port's chunked scan against JAX's,
    and its sequential reference against JAX's."""
    b, s, h, p, n, L = case
    arrs_j, arrs_t = _both(_ssd_inputs(np.random.default_rng(7), b, s, h, p, n))
    yj, hj = jssm.ssd_chunked(*arrs_j, chunk=L)
    yt, htt = tssm.ssd_chunked(*arrs_t, chunk=L)
    _check(f"ssd_chunked y vs JAX {case}", _err(yj, yt), CHUNKED_TOL)
    _check(f"ssd_chunked h vs JAX {case}", _err(hj, htt), CHUNKED_TOL)
    yj, hj = jssm.ssd_ref(*arrs_j)
    yt, htt = tssm.ssd_ref(*arrs_t)
    _check(f"ssd_ref y vs JAX {case}", _err(yj, yt), CHUNKED_TOL)
    _check(f"ssd_ref h vs JAX {case}", _err(hj, htt), CHUNKED_TOL)


def test_ssd_prefill_decode_split_vs_jax():
    """tests/test_ssm.py:30-40: the state after a chunked prefill of S
    tokens continues the recurrence in a decode step."""
    b, s, h, p, n = 1, 32, 2, 8, 4
    x, dt, A, Bm, C = _ssd_inputs(np.random.default_rng(8), b, s + 1, h, p, n)
    (xj, dtj, Aj, bj, cj), (xt, dtt, At, bt, ct) = _both((x, dt, A, Bm, C))
    y_all, _ = jssm.ssd_ref(xj, dtj, Aj, bj, cj)
    _, hmid = tssm.ssd_chunked(xt[:, :s], dtt[:, :s], At, bt[:, :s], ct[:, :s], chunk=8)
    y_t, h_t = tssm.ssd_decode_step(xt[:, s], dtt[:, s], At, bt[:, s], ct[:, s], hmid)
    _check("ssd_chunked -> ssd_decode_step vs JAX ssd_ref", _err(y_all[:, s], y_t),
           CHUNKED_TOL)
    _, hmid_j = jssm.ssd_chunked(xj[:, :s], dtj[:, :s], Aj, bj[:, :s], cj[:, :s], chunk=8)
    yj, hj = jssm.ssd_decode_step(xj[:, s], dtj[:, s], Aj, bj[:, s], cj[:, s], hmid_j)
    _check("ssd_decode_step y vs JAX", _err(yj, y_t), CHUNKED_TOL)
    _check("ssd_decode_step h vs JAX", _err(hj, h_t), CHUNKED_TOL)


@pytest.mark.parametrize("s", [16, 2])
def test_causal_conv_and_step_vs_jax(s):
    """The conv over a prompt and its returned state (the last K-1
    inputs, the zero initial state included when S < K-1), then decode
    steps that continue it: against JAX, f32 to 1e-5, and with bf16
    inputs and weights against an f32 state (the model's decode with an
    f32 cache), where both promote to f32."""
    b, ch, k = 2, 8, 4
    rng = np.random.default_rng(9)
    x, w = _normal(rng, (b, s + 3, ch)), _normal(rng, (k, ch))
    yj, stj = jssm.causal_conv(jnp.asarray(x[:, :s]), jnp.asarray(w))
    yt, stt = tssm.causal_conv(torch.from_numpy(x[:, :s]), torch.from_numpy(w))
    assert stt.shape == (b, k - 1, ch)
    _check(f"causal_conv y S={s} vs JAX", _err(yj, yt), 1e-5)
    _check(f"causal_conv state S={s} vs JAX", _err(stj, stt), 1e-5)
    for bf16 in (False, True):
        xj, xt = _pair(x, bf16)
        wj, wt = _pair(w, bf16)
        sj, st = stj, stt
        for t in range(s, s + 3):
            oj, sj = jssm.causal_conv_step(xj[:, t], wj, sj)
            ot, st = tssm.causal_conv_step(xt[:, t], wt, st)
            assert ot.dtype == torch.float32 and st.dtype == torch.float32
            _check(f"causal_conv_step S={s} t={t} bf16={bf16} vs JAX", _err(oj, ot), 1e-5)
            _check(f"causal_conv_step state S={s} t={t} bf16={bf16} vs JAX",
                   _err(sj, st), 1e-5)
