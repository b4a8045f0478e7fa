"""Plain PyTorch version of the flash-decoding kernel: the one-token
attention of ``repro/models/attention.py::decode_attention``."""
from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ref import NEG_INF, expand_kv, softcap_


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q (B, 1, Hq, hd); caches (B, S, Hkv, hd); cache_len (an int, a
    scalar tensor or (B,)) = number of valid cache rows, the token
    written this step included; ``scale`` the scores' factor, 1/sqrt(hd)
    where None. Returns (B, 1, Hq, hd) in the cache dtype."""
    b, _, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    groups = hq // hkv
    qf = q.float()[:, 0]                                      # (B, Hq, d)
    kf = expand_kv(k_cache, groups).float()                   # (B, S, Hq, d)
    vf = expand_kv(v_cache, groups).float()
    scores = torch.einsum("bhd,bkhd->bhk", qf, kf)
    scores = softcap_(scores / math.sqrt(d) if scale is None else scores * scale, softcap)
    kpos = torch.arange(s, device=q.device)[None, :]
    clen = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    mask = kpos < clen
    if window is not None:
        mask &= kpos >= clen - window
    scores = torch.where(mask[:, None, :], scores,
                         torch.tensor(NEG_INF, dtype=scores.dtype, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", probs, vf)
    return out[:, None].to(v_cache.dtype)


#: query heads to a kv head above which the kernel's split pass runs on
#: the tensor cores (``MAX_CUDA_CORE_GROUPS`` in ``ops.py``)
CUDA_CORE_GROUPS = 8


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to tf32 (10 stored mantissa bits), to nearest with ties
    away from zero (``cvt.rna.tf32.f32``), in f32."""
    bits = x.float().contiguous().view(torch.int32)
    sign = bits & torch.tensor(-2 ** 31, dtype=torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & -0x2000
    return (mag | sign).view(torch.float32)


def _terms(x: torch.Tensor, n: int) -> List[torch.Tensor]:
    """``x`` as the kernel feeds it to the tensor cores: one term (a bf16
    value, exact in tf32) or 3xTF32's two, big = tf32(x) and small =
    tf32(x - big), in f32."""
    x = x.float()
    if n == 1:
        return [x]
    big = _tf32(x)
    return [big, _tf32(x - big)]


def _pairs(na: int, nb: int):
    """The products of terms (i, j) the kernel takes, small·big ones first,
    then big·big (``mma_terms``)."""
    return [(i, j) for i, j in ((0, 1), (1, 0), (0, 0)) if i < na and j < nb]


def _tc_instance(d: int):
    """(HD, keys a stage, 16-key chunks a stage, warps a chunk) of the
    tensor-core kernel instance that takes head dim ``d``: 8 warps, a
    chunk's warps forming q·k over 32 columns each."""
    hd = 64 if d <= 64 else 128 if d <= 128 else 256
    hsplit = hd // 32
    ng = 8 // hsplit
    return hd, 16 * ng, ng, hsplit


def _tc_split_state(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
                    scale: float, softcap: Optional[float]):
    """One split's (m, l, acc) as ``decode_split_tc_kernel`` forms it.

    q (B, Hkv, G, d) unscaled; k, v (B, P, Hkv, d): the split's rows from
    its first visible one, P a whole number of stages, zero past the
    row's end; valid (B, P). The stage's 16-key chunks go to its warp
    groups, each with its own online state: S = Σ over the group's warps,
    in order, of each one's Σ over its 4 k-steps of 8 columns (columns 16c
    + 4t + 2p and + 1 for t = 0..3) of the term products (``_pairs``) in
    f32, times ``scale``, softcapped; per chunk the row max, p = e^(s - m)
    (0 past the end), a lane's sum over its 4 keys (2t, 2t+1, 8+2t, 9+2t)
    kept per lane, acc·corr + P·V over the chunk's two k-steps of 8 keys a
    term product at a time. At the end each row's sum over the 4 lanes
    (pairs, then the two pair sums), and the groups' states merge by the
    log-sum-exp rule in group order."""
    b, p_rows, hkv, d = k.shape
    g = q.shape[2]
    hd_inst, ks, ng, _ = _tc_instance(d)
    dev = q.device
    pad = hd_inst - d
    qt = _terms(F.pad(q.float(), (0, pad)), 1 if q.dtype == torch.bfloat16 else 2)
    nkv = 1 if k.dtype == torch.bfloat16 else 2
    kt, vt = (_terms(F.pad(x.float(), (0, pad)), nkv) for x in (k, v))
    # S (B, Hkv, G, P): each warp's 4 k-steps, the term products inside,
    # then the warps' parts in order
    sc = torch.zeros((b, hkv, g, p_rows), device=dev)
    for w0 in range(0, hd_inst, 32):
        part = torch.zeros((b, hkv, g, p_rows), device=dev)
        for c0 in (w0, w0 + 16):
            for p2 in (0, 1):
                cols = torch.tensor([c0 + 4 * t + 2 * p2 + u for t in range(4) for u in (0, 1)],
                                    device=dev)
                for i, j in _pairs(len(qt), len(kt)):
                    part = part + torch.einsum("bhgd,bkhd->bhgk", qt[i][..., cols],
                                               kt[j][..., cols])
        sc = sc + part
    sc = softcap_(sc * scale, softcap)
    neg = torch.tensor(NEG_INF, device=dev)
    nst = p_rows // ks
    sc = torch.where(valid[:, None, None, :], sc, neg).reshape(b, hkv, g, nst, ng, 16)
    ok = valid.reshape(b, 1, 1, nst, ng, 16)
    vv = [t.reshape(b, nst, ng, 16, hkv, d + pad) for t in vt]
    m = torch.full((b, hkv, g, ng), NEG_INF, device=dev)
    lane = torch.zeros((b, hkv, g, ng, 4), device=dev)
    acc = torch.zeros((b, hkv, g, ng, d + pad), device=dev)
    # a lane's keys: 2t, 2t+1, 8+2t, 9+2t in that order
    order = torch.tensor([[2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t] for t in range(4)],
                         device=dev)
    for st in range(nst):
        s_ = sc[:, :, :, st]                                        # (B,Hkv,G,NG,16)
        busy = ok[:, :, :, st].any(-1)                              # the chunk has a key
        mx = torch.maximum(m, s_.amax(-1))
        corr = torch.exp(m - mx)
        p = torch.where(ok[:, :, :, st], torch.exp(s_ - mx[..., None]), torch.zeros_like(s_))
        part = p[..., order]                                        # (B,Hkv,G,NG,4,4)
        lsum = ((part[..., 0] + part[..., 1]) + part[..., 2]) + part[..., 3]
        new_acc = acc * corr[..., None]
        pt = _terms(p, 2)
        for k0 in (0, 8):
            for i, j in _pairs(2, len(vv)):
                new_acc = new_acc + torch.einsum("bhgwk,bwkhd->bhgwd", pt[i][..., k0:k0 + 8],
                                                 vv[j][:, st, :, k0:k0 + 8])
        lane = torch.where(busy[..., None], lane * corr[..., None] + lsum, lane)
        acc = torch.where(busy[..., None], new_acc, acc)
        m = torch.where(busy, mx, m)
    l = (lane[..., 0] + lane[..., 1]) + (lane[..., 2] + lane[..., 3])
    # the groups' states, in group order
    mx = m.amax(-1)
    den = torch.zeros_like(mx)
    num = torch.zeros((b, hkv, g, d + pad), device=dev)
    for w in range(ng):
        c = torch.exp(m[..., w] - mx)
        den = den + l[..., w] * c
        num = num + acc[..., w, :] * c[..., None]
    return mx, den, num[..., :d]


def decode_attention_split_emulation(q: torch.Tensor, k_cache: torch.Tensor,
                                     v_cache: torch.Tensor, cache_len, split_rows: int,
                                     *, window: Optional[int] = None,
                                     softcap: Optional[float] = None) -> torch.Tensor:
    """The CUDA kernel's split and merge in plain tensor ops, on any device.

    Cache rows are cut into splits of ``split_rows``; a split that meets
    no row of ``[lo, clen)`` is skipped, as the kernel's split pass skips
    it. Each other split's partial state is (m, l, acc): the largest
    score, the sum of e^(s - m) and the e^(s - m)-weighted sum of v over
    its visible rows, with q scaled by 1/sqrt(hd) before the product as
    the kernel does. The merge takes them in split order by the
    log-sum-exp rule, M = max m_j, out = sum acc_j e^(m_j - M) /
    max(sum l_j e^(m_j - M), 1e-30), so a row with no visible key gives 0
    (the Pallas kernel's value; ``decode_attention`` averages v there).
    Inside a split the kernel's warps keep their own online states and
    merge them by the same rule: at G <= 8 (the CUDA cores) equal to
    this up to f32 rounding; at G > 8 the split's state is the tensor-core
    pass's own arithmetic (``_tc_split_state``: 3xTF32 terms, 16-key
    chunks per warp group, stages of 64 keys at hd 64, 32 at hd 128, 16
    at hd 256). The kernel's blocks of a row (one cluster) merge the live
    splits in split order, as here.
    Returns (B, 1, Hq, hd) in the cache dtype."""
    b, _, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    dev = q.device
    qf = q.float()[:, 0].reshape(b, hkv, g, d) * (1.0 / math.sqrt(d))
    clen = torch.as_tensor(cache_len, device=dev).long().expand(b).clamp(0, s)
    lo = (clen - window).clamp(min=0) if window is not None else torch.zeros_like(clen)
    parts = []
    for r0 in range(0, s, split_rows):
        r1 = min(r0 + split_rows, s)
        live = (torch.maximum(lo, torch.tensor(r0, device=dev))
                < torch.minimum(clen, torch.tensor(r1, device=dev)))          # (B,)
        if not bool(live.any()):
            continue
        if g > CUDA_CORE_GROUPS:
            first = torch.clamp(lo, min=r0)
            end = torch.clamp(clen, max=r1)
            n = int((end - first).clamp(min=0).max())
            ks = _tc_instance(d)[1]
            pos = first[:, None] + torch.arange(-(-n // ks) * ks, device=dev)[None, :]
            valid = pos < end[:, None]
            rows = torch.arange(b, device=dev)[:, None], pos.clamp(max=s - 1)
            kr, vr = (torch.where(valid[..., None, None], c[rows], torch.zeros((), dtype=c.dtype))
                      for c in (k_cache, v_cache))
            m, l, acc = _tc_split_state(q[:, 0].reshape(b, hkv, g, d), kr, vr, valid,
                                        1.0 / math.sqrt(d), softcap)
            parts.append((live[:, None, None], m, l, acc))
            continue
        kpos = torch.arange(r0, r1, device=dev)[None, :]
        mask = ((kpos < clen[:, None]) & (kpos >= lo[:, None]))[:, None, None, :]
        sc = softcap_(torch.einsum("bhgd,bkhd->bhgk", qf, k_cache[:, r0:r1].float()), softcap)
        sc = torch.where(mask, sc, torch.tensor(NEG_INF, device=dev))
        m = sc.amax(-1)                                                      # (B,Hkv,G)
        p = torch.exp(sc - m[..., None]) * mask
        acc = torch.einsum("bhgk,bkhd->bhgd", p, v_cache[:, r0:r1].float())
        parts.append((live[:, None, None], m, p.sum(-1), acc))
    mx = torch.full((b, hkv, g), NEG_INF, device=dev)
    for live, m, _, _ in parts:
        mx = torch.where(live, torch.maximum(mx, m), mx)
    num = torch.zeros((b, hkv, g, d), device=dev)
    den = torch.zeros((b, hkv, g), device=dev)
    for live, m, l, acc in parts:
        c = torch.where(live, torch.exp(m - mx), torch.zeros_like(m))
        den = den + l * c
        num = num + acc * c[..., None]
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out.reshape(b, 1, hq, d).to(v_cache.dtype)
