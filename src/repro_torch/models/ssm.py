"""Mamba2 / SSD (state-space duality) sequence mixing, the counterpart
of ``repro/models/ssm.py``.

``ssd_chunked`` is the chunked-parallel algorithm (arXiv:2405.21060
Listing 1 structure): intra-chunk quadratic term + inter-chunk state
recurrence. It is the plain version of the CUDA ``ssd_scan`` kernel.
``ssd_ref`` is the sequential recurrence, the oracle of both.

Shapes: x (B,S,H,P) values; dt (B,S,H) post-softplus step sizes;
A (H,) negative; Bm/C (B,S,N) input/output state projections (ngroups=1);
state h (B,H,P,N).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, C: torch.Tensor, *, chunk: int = 256,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P) in ``x.dtype``, final_state (B,H,P,N) f32).
    The math is f32; a ragged S is zero-padded to a multiple of ``chunk``
    (dt = 0 there, so the pad neither decays nor feeds the state)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    pad = (-s) % chunk
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bm.float(), C.float()
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    sp = s + pad
    g, L = sp // chunk, chunk

    xf = xf.reshape(b, g, L, h, p)
    dtf = dtf.reshape(b, g, L, h)
    Bf = Bf.reshape(b, g, L, n)
    Cf = Cf.reshape(b, g, L, n)

    dA = dtf * A.float()                                 # (B,G,L,H)
    cum = torch.cumsum(dA, dim=2)                        # (B,G,L,H)

    # ---- intra-chunk (the quadratic/"attention-like" branch) ----
    CB = torch.einsum("bgtn,bgsn->bgts", Cf, Bf)         # (B,G,L,L)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    # exp only of cum_t - cum_s for s <= t (JAX forms the s > t overflow
    # and drops it with where; here it is -inf -> 0 before the exp)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,G,L,L,H)
    decay = torch.exp(diff.masked_fill(~tri[None, None, :, :, None], float("-inf")))
    scores = CB[..., None] * decay * dtf[:, :, None, :, :]
    y_intra = torch.einsum("bgtsh,bgshp->bgthp", scores, xf)

    # ---- chunk states ----
    last = cum[:, :, -1:, :]                             # (B,G,1,H)
    w = torch.exp(last - cum) * dtf                      # (B,G,L,H)
    states = torch.einsum("bgsh,bgsn,bgshp->bghpn", w, Bf, xf)  # (B,G,H,P,N)

    # ---- inter-chunk recurrence over G ----
    chunk_decay = torch.exp(last[:, :, 0, :])            # (B,G,H)
    hstate = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
              if h0 is None else h0.float())
    hprevs = []
    for gi in range(g):
        hprevs.append(hstate)                            # state entering chunk gi
        hstate = hstate * chunk_decay[:, gi, :, None, None] + states[:, gi]
    hprev = torch.stack(hprevs, dim=1)                   # (B,G,H,P,N)

    y_inter = torch.einsum("bgtn,bghpn->bgthp", Cf, hprev) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, sp, h, p)[:, :s]
    return y.to(x.dtype), hstate


def ssd_decode_step(xt: torch.Tensor, dtt: torch.Tensor, A: torch.Tensor,
                    Bt: torch.Tensor, Ct: torch.Tensor, hstate: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence. xt (B,H,P); dtt (B,H); Bt/Ct (B,N);
    hstate (B,H,P,N). Returns (y (B,H,P) f32, h' f32)."""
    xt, dtt = xt.float(), dtt.float()
    dA = torch.exp(dtt * A.float())                      # (B,H)
    dBx = torch.einsum("bh,bn,bhp->bhpn", dtt, Bt.float(), xt)
    hnew = hstate * dA[:, :, None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", Ct.float(), hnew)
    return y, hnew


def ssd_ref(x, dt, A, Bm, C, *, h0=None):
    """Sequential O(S) reference recurrence (oracle for tests)."""
    b, s, h, p = x.shape
    hstate = (torch.zeros((b, h, p, Bm.shape[-1]), dtype=torch.float32,
                          device=x.device) if h0 is None else h0.float())
    ys = []
    for t in range(s):
        y, hstate = ssd_decode_step(x[:, t], dt[:, t], A, Bm[:, t], C[:, t], hstate)
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype), hstate


# ----------------------------------------------------------------------
# depthwise causal conv (width K) used on x/B/C streams
# ----------------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor,
                state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,Ch), w (K,Ch) depthwise, in ``x.dtype``. Returns (y (B,S,Ch),
    new_state (B,K-1,Ch) = the last K-1 inputs, the zero initial state
    included for prompts shorter than K-1, for decode continuation)."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)                    # (B, S+K-1, Ch)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    return y, xp[:, xp.shape[1] - (k - 1):]


def causal_conv_step(xt: torch.Tensor, w: torch.Tensor, state: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token conv. xt (B,Ch); state (B,K-1,Ch). The dtypes promote as
    in JAX: an f32 state with bf16 inputs and weights gives f32."""
    xp = torch.cat([state, xt[:, None]], dim=1)          # (B,K,Ch)
    dtype = torch.promote_types(xp.dtype, w.dtype)
    y = torch.einsum("bkc,kc->bc", xp.to(dtype), w.to(dtype))
    return y, xp[:, 1:]
