"""Wrapper of the CUDA flash-decoding kernel (``csrc/decode_attention.cu``)
in the model zoo's (B,1,Hq,hd) / (B,S,Hkv,hd) layout, with a per-row
``cache_len``.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (``ref.decode_attention``). The kernel splits the cache length
over at most 16 blocks (``split_rows`` rows each, from the shapes alone)
and merges the splits' softmax states in the same launch, which
``decode_attention_kernel.launches`` counts. At G <= 8 a split runs on
the CUDA cores and the block that counts a row's last split merges,
through an f32 scratch allocated here and a per-(b, kv head) int32
counter (``_counters``: made and zeroed once per device, stream and
size; every launch leaves them 0). At G in (8, 16] a split runs on the
tensor cores (``mma.sync``, 3xTF32; hd % 16 == 0) and a row's splits are
one thread-block cluster that merges through its shared memory: no
scratch, no counter. ``out=`` makes the kernel write a given buffer (the
serve engine's CUDA graph reads K2's output from a fixed address).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, refuse_grad
from repro_torch.kernels.decode_attention.ref import decode_attention

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_GROUPS = 16           # glm4-9b: 32 q heads over 2 kv heads
MAX_CUDA_CORE_GROUPS = 8  # above: the tensor-core split pass, hd % 16 == 0
SMS = 132                 # streaming multiprocessors of an H100 SXM
MIN_SPLIT_ELEMS = 8192    # a split reads at least 64 rows of hd 128 per kv head
MAX_SPLITS = 16           # a cluster's blocks (MAX_SPLITS in the source)


def split_rows(b: int, s: int, hkv: int, hd: int) -> int:
    """Cache rows per block of the split pass, from the shapes alone (the
    host never reads ``cache_len``, which would sync with the card).

    A full cache gives at least two blocks an SM: the largest power of
    two at most ``s / ceil(2 * SMS / (b * hkv))``. A floor of
    ``MIN_SPLIT_ELEMS / hd`` rows (64 at hd 128) keeps short caches from
    paying for empty splits, and one of ``ceil(s / MAX_SPLITS)`` keeps a
    row's splits in one cluster; at most ``s``, at least 1."""
    want = -(-2 * SMS // max(1, b * hkv))             # splits for 2 blocks an SM
    rows = 1 << (max(1, s // want).bit_length() - 1)  # a power of two <= s / want
    return max(1, min(s, max(rows, MIN_SPLIT_ELEMS // hd, -(-s // MAX_SPLITS))))


def _check(q, k_cache, v_cache, window, softcap):
    dev = q.device
    if not (q.is_cuda and k_cache.device == dev and v_cache.device == dev):
        raise ValueError("decode_attention: q and the caches must lie on one "
                         "CUDA device")
    if q.dtype not in DTYPES:
        raise TypeError(f"decode_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    if k_cache.dtype not in DTYPES or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"decode_attention: the caches must share a dtype of "
                        f"float32 or bfloat16, got {k_cache.dtype}, {v_cache.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4 \
            or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: want q (B,1,Hq,hd) and caches "
                         f"(B,S,Hkv,hd), got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, _, hq, d = q.shape
    if k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError("decode_attention: caches must match q's batch and head dim")
    hkv = k_cache.shape[2]
    if hkv == 0 or hq % hkv or hq // hkv > MAX_GROUPS:
        raise ValueError(f"decode_attention: {hq} q heads must group over "
                         f"{hkv} kv heads, at most {MAX_GROUPS} to a group")
    if d > MAX_HEAD_DIM or d % 4:
        raise ValueError(f"decode_attention: head dim {d} must be a multiple "
                         f"of 4 and at most {MAX_HEAD_DIM}")
    if hq // hkv > MAX_CUDA_CORE_GROUPS and d % 16:
        raise ValueError(f"decode_attention: {hq // hkv} q heads to a kv head take the "
                         f"tensor cores, whose head dim must be a multiple of 16, got {d}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be contiguous "
                             "and 16-byte aligned")
    if window is not None and window <= 0:
        raise ValueError(f"decode_attention: window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"decode_attention: softcap must be positive, got {softcap}")


def _row_lengths(cache_len, b: int, device) -> torch.Tensor:
    """An int, a scalar tensor or a (B,) tensor -> (B,) int32 on device."""
    clen = torch.as_tensor(cache_len, device=device)
    if clen.dim() == 0:
        clen = clen.expand(b)
    if clen.shape != (b,):
        raise ValueError(f"decode_attention: cache_len must be a scalar or "
                         f"({b},), got {tuple(clen.shape)}")
    if clen.dtype.is_floating_point or clen.dtype == torch.bool:
        raise TypeError(f"decode_attention: cache_len must be integer, got {clen.dtype}")
    return clen.to(torch.int32).contiguous()


def _check_out(out, q, k_cache) -> None:
    if out.shape != q.shape or out.dtype != k_cache.dtype or out.device != q.device:
        raise ValueError(f"decode_attention: out must be {tuple(q.shape)} {k_cache.dtype} "
                         f"on {q.device}, got {tuple(out.shape)} {out.dtype} on {out.device}")
    if not out.is_contiguous() or (out.is_cuda and out.data_ptr() % 16):
        raise ValueError("decode_attention: out must be contiguous and 16-byte aligned")


def decode_attention_kernel(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, cache_len, *,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None,
                            out: Optional[torch.Tensor] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """q (B,1,Hq,hd); caches (B,S,Hkv,hd); cache_len scalar or (B,);
    ``scale`` the scores' factor, 1/sqrt(hd) where None. Returns
    (B,1,Hq,hd) in the cache dtype: ``out`` where given (q's shape, the
    cache dtype, q's device), written in place, else a new tensor."""
    if out is not None:
        _check_out(out, q, k_cache)
    if q.device.type == "cpu":
        res = decode_attention(q, k_cache, v_cache, cache_len,
                               window=window, softcap=softcap, scale=scale)
        return res if out is None else out.copy_(res)
    _check(q, k_cache, v_cache, window, softcap)
    refuse_grad("decode_attention", q, k_cache, v_cache)
    if q.device.index != torch.cuda.current_device():    # launch from q's device
        with torch.cuda.device(q.device):
            return decode_attention_kernel(q, k_cache, v_cache, cache_len,
                                           window=window, softcap=softcap, out=out,
                                           scale=scale)
    b, _, _, d = q.shape
    out = launch(q, k_cache, v_cache, _row_lengths(cache_len, b, q.device),
                 split_rows(b, k_cache.shape[1], k_cache.shape[2], d), window, softcap,
                 out=out, scale=scale)
    if out.numel():
        decode_attention_kernel.launches += 1
    return out


def slot_floats(g: int, hd: int) -> int:
    """Floats of one split's partial state in the scratch: acc (G, hd), m
    (G), l (G), padded to a multiple of 4 (``slot_floats`` in the source)."""
    return g * hd + (2 * g + 3) // 4 * 4


#: (device index, stream, B * Hkv) -> int32 counters, zero between launches
_counter_cache = {}


def _counters(device, stream: int, n: int) -> torch.Tensor:
    """The per-(b, kv head) counters of the launches on ``stream``: made
    (and zeroed, one fill) at the first call of a size; every launch
    leaves them 0, so later calls launch nothing but the kernel."""
    key = (device.index, stream, n)
    c = _counter_cache.get(key)
    if c is None:
        c = _counter_cache[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return c


def launch(q, k_cache, v_cache, clen, rows: int, window, softcap,
           out: Optional[torch.Tensor] = None,
           scale: Optional[float] = None) -> torch.Tensor:
    """The C entry on checked inputs on the current device, with ``rows``
    cache rows a split; counts nothing. ``clen``: (B,) int32 on q's device;
    ``out``, where given, a checked buffer the kernel writes instead of a
    new one; ``scale`` the scores' factor, 1/sqrt(hd) where None."""
    b, _, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    if out is None:
        out = torch.empty(q.shape, dtype=k_cache.dtype, device=q.device)
    if out.numel() == 0:
        return out
    nsplit = max(1, -(-s // rows))
    if nsplit > MAX_SPLITS:
        raise ValueError(f"decode_attention: {rows} rows a split cut {s} rows into more "
                         f"than {MAX_SPLITS} splits")
    # the raw handle: torch.cuda.current_stream(...).cuda_stream builds a
    # Stream object, several us of host time on a path of one-token calls
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    g = hq // hkv
    if g > MAX_CUDA_CORE_GROUPS:            # the cluster merges: no scratch, no counter
        part, counters = None, 0
    else:                                   # the splits' partials: acc, m, l
        # held past the launch: freed before it, its block could become
        # the counters of a first call, which the partials then overwrite
        part = torch.empty(b * hkv * nsplit * slot_floats(g, d), dtype=torch.float32,
                           device=q.device)
        counters = _counters(q.device, stream, b * hkv).data_ptr()
    err = _build.library("decode_attention").decode_forward(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), clen.data_ptr(), out.data_ptr(),
        0 if part is None else part.data_ptr(), counters, DTYPES[q.dtype],
        DTYPES[k_cache.dtype], b, s, hq, hkv, d, rows,
        window or 0, 1.0 / (d ** 0.5) if scale is None else scale, softcap or 0.0, stream)
    _build.check(err, "decode_attention launch")
    return out


decode_attention_kernel.launches = 0
