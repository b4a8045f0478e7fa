"""Mamba2 (arXiv:2405.21060), attention-free: each layer is pre-norm
RMSNorm, then one input projection to x, z (d_inner each), B, C
(d_state each, one group) and dt (one per head); a depthwise causal
convolution of width ``ssm_conv`` and SiLU on x, B and C; the SSD
recurrence per head h (head dim P, state N):

    state_t = exp(dt_t A_h) state_{t-1} + dt_t x_t B_tᵀ,   y_t = state_t C_t + D_h x_t

with ``dt = softplus(dt_raw + dt_bias)`` and ``A = -exp(A_log)``; then
the gated RMSNorm ``norm(y * silu(z))`` and the output projection.
Embeddings are tied to the output head. The SSD runs in its chunked
form: within a chunk the quadratic (attention-like) sum, across chunks
the state carried from one to the next.

Inputs: ``w_xz (L, D, 2, Di)``, ``w_bc (L, D, 2, N)``, ``w_dt (L, D, H)``,
``conv_x (L, K, Di)``, ``conv_b``/``conv_c (L, K, N)``, ``A_log``, ``D``,
``dt_bias (L, H)``, ``norm (L, Di)``, ``out (L, Di, D)``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench.reference.common import mm, rmsnorm, silu


def LAYOUT(m: Dict) -> Dict:
    L, D, V = m["num_layers"], m["d_model"], m["vocab_size"]
    Di = m["ssm_expand"] * D
    N, P, K = m["ssm_state"], m["ssm_head_dim"], m["ssm_conv"]
    H = Di // P

    def normal(std):
        return {"init": "normal", "std": std}
    ones = {"init": "ones"}
    s = ("layers", 0, "ssm")
    return {("embed", "table"): ((V, D), normal(0.02)),
            ("layers", 0, "norm1", "scale"): ((L, D), ones),
            s + ("w_xz",): ((L, D, 2, Di), normal(D ** -0.5)),
            s + ("w_bc",): ((L, D, 2, N), normal(D ** -0.5)),
            s + ("w_dt",): ((L, D, H), normal(D ** -0.5)),
            s + ("conv_x",): ((L, K, Di), normal(K ** -0.5)),
            s + ("conv_b",): ((L, K, N), normal(K ** -0.5)),
            s + ("conv_c",): ((L, K, N), normal(K ** -0.5)),
            s + ("A_log",): ((L, H), {"init": "log_uniform_a", "lo": 1.0, "hi": 16.0}),
            s + ("D",): ((L, H), ones),
            s + ("dt_bias",): ((L, H), {"init": "inv_softplus_dt", "lo": 1e-3, "hi": 1e-1}),
            s + ("norm",): ((L, Di), ones),
            s + ("out",): ((L, Di, D), normal(Di ** -0.5)),
            ("final_norm", "scale"): ((D,), ones)}


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution: y_t = sum_i w_i x_(t - K + 1 + i),
    zeros before the sequence. x (S, C), w (K, C)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[i:i + x.shape[0]] * w[i] for i in range(k))


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int) -> torch.Tensor:
    """y (S, H, P) of the SSD recurrence from a zero state: x (S, H, P),
    dt (S, H), A (H,), B and C (S, N); chunks of ``chunk`` positions."""
    s, h, p = x.shape
    state = x.new_zeros(h, p, B.shape[-1])
    ys = []
    for c0 in range(0, s, chunk):
        xs, dts, bs, cs = x[c0:c0 + chunk], dt[c0:c0 + chunk], B[c0:c0 + chunk], C[c0:c0 + chunk]
        n = xs.shape[0]
        cum = torch.cumsum(dts * A, dim=0)                              # (n, H)
        seg = cum[:, None, :] - cum[None, :, :]                         # (t, s, H)
        keep = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()[:, :, None]
        decay = torch.exp(seg.masked_fill(~keep, float("-inf")))
        w = (cs @ bs.t())[:, :, None] * decay * dts[None, :, :]        # (t, s, H)
        y = torch.einsum("tsh,shp->thp", w, xs)
        y = y + torch.einsum("tn,hpn->thp", cs, state) * torch.exp(cum)[:, :, None]
        ys.append(y)
        carry = torch.exp(cum[-1][None, :] - cum) * dts                 # (n, H)
        state = state * torch.exp(cum[-1])[:, None, None] \
            + torch.einsum("sh,sn,shp->hpn", carry, bs, xs)
    return torch.cat(ys)


def layer(m: Dict, params: Dict, i: int, x: torch.Tensor,
          lowp: Optional[str] = None) -> torch.Tensor:
    p = params["layers"][0]
    q = p["ssm"]
    s, d = x.shape
    di, n, hp = m["ssm_expand"] * d, m["ssm_state"], m["ssm_head_dim"]
    nh = di // hp
    h = rmsnorm(x, p["norm1"]["scale"][i], m["norm_eps"])
    xz = mm(h, q["w_xz"][i].reshape(d, 2 * di), lowp).view(s, 2, di)
    bc = mm(h, q["w_bc"][i].reshape(d, 2 * n), lowp).view(s, 2, n)
    dt_raw = mm(h, q["w_dt"][i], lowp)
    xc = silu(causal_conv(xz[:, 0], q["conv_x"][i].float()))
    bm = silu(causal_conv(bc[:, 0], q["conv_b"][i].float()))
    cm = silu(causal_conv(bc[:, 1], q["conv_c"][i].float()))
    dt = F.softplus(dt_raw + q["dt_bias"][i].float())
    A = -torch.exp(q["A_log"][i].float())
    xh = xc.view(s, nh, hp)
    y = ssd(xh, dt, A, bm, cm, m["ssm_chunk"]) + xh * q["D"][i].float()[:, None]
    y = rmsnorm(y.reshape(s, di) * silu(xz[:, 1]), q["norm"][i], m["norm_eps"])
    return x + mm(y, q["out"][i], lowp)


def hidden(m: Dict, params: Dict, tokens: torch.Tensor,
           lowp: Optional[str] = None) -> torch.Tensor:
    x = params["embed"]["table"][tokens.long()].float()
    for i in range(m["num_layers"]):
        x = layer(m, params, i, x, lowp)
    return rmsnorm(x, params["final_norm"]["scale"], m["norm_eps"])


@torch.no_grad()
def logits_rows(m: Dict, params: Dict, tokens: torch.Tensor, rows: Sequence[int],
                lowp: Optional[str] = None) -> torch.Tensor:
    h = hidden(m, params, tokens, lowp)
    idx = torch.as_tensor(list(rows), device=h.device)
    return mm(h[idx], params["embed"]["table"].t(), lowp)
