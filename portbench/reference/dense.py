"""A dense decoder with grouped-query attention (InternLM2, arXiv:2403.17297):
pre-norm RMSNorm, rotary embedding, causal softmax attention in which
each kv head serves ``num_heads / num_kv_heads`` query heads, and a
SwiGLU MLP (``silu(x W_gate) * (x W_up)`` then ``W_down``); a final RMSNorm
and an untied output head.

The inputs' layout: ``wq (L, D, H, hd)``, ``wk``/``wv (L, D, Hkv, hd)``,
``wo (L, H, hd, D)``, ``w_in (L, D, 2, F)`` with the gate at index 0 and
the up projection at 1, ``w_out (L, F, D)``, tables ``(V, D)``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference.common import ce_sum, mm, rmsnorm, rope, silu


def LAYOUT(m: Dict) -> Dict:
    L, D, V = m["num_layers"], m["d_model"], m["vocab_size"]
    H, Hkv, hd, F = m["num_heads"], m["num_kv_heads"], m["head_dim"], m["d_ff"]

    def normal(std):
        return {"init": "normal", "std": std}
    ones = {"init": "ones"}
    out = {("embed", "table"): ((V, D), normal(0.02)),
           ("layers", 0, "norm1", "scale"): ((L, D), ones),
           ("layers", 0, "attn", "wq"): ((L, D, H, hd), normal(D ** -0.5)),
           ("layers", 0, "attn", "wk"): ((L, D, Hkv, hd), normal(D ** -0.5)),
           ("layers", 0, "attn", "wv"): ((L, D, Hkv, hd), normal(D ** -0.5)),
           ("layers", 0, "attn", "wo"): ((L, H, hd, D), normal((H * hd) ** -0.5)),
           ("layers", 0, "norm2", "scale"): ((L, D), ones),
           ("layers", 0, "mlp", "w_in"): ((L, D, 2, F), normal(D ** -0.5)),
           ("layers", 0, "mlp", "w_out"): ((L, F, D), normal(F ** -0.5)),
           ("final_norm", "scale"): ((D,), ones)}
    if not m.get("tie_embeddings", False):
        out[("lm_head", "w")] = ((V, D), normal(0.02))
    return out


def head(m: Dict, params: Dict) -> torch.Tensor:
    return params["embed"]["table"] if m.get("tie_embeddings") else params["lm_head"]["w"]


def layer(m: Dict, params: Dict, i: int, x: torch.Tensor, positions: torch.Tensor,
          lowp: Optional[str] = None) -> torch.Tensor:
    """Layer i on one sequence's residual stream x (S, D), in f32."""
    p = params["layers"][0]
    s, d = x.shape
    H, Hkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    eps = m["norm_eps"]
    a = p["attn"]
    h = rmsnorm(x, p["norm1"]["scale"][i], eps)
    q = mm(h, a["wq"][i].reshape(d, H * hd), lowp).view(s, H, hd)
    k = mm(h, a["wk"][i].reshape(d, Hkv * hd), lowp).view(s, Hkv, hd)
    v = mm(h, a["wv"][i].reshape(d, Hkv * hd), lowp).view(s, Hkv, hd)
    q, k = rope(q, positions, m["rope_theta"]), rope(k, positions, m["rope_theta"])
    g = H // Hkv
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)  # head j reads kv j // g
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    att = torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), v)
    x = x + mm(att.reshape(s, H * hd), a["wo"][i].reshape(H * hd, d), lowp)
    h = rmsnorm(x, p["norm2"]["scale"][i], eps)
    f = m["d_ff"]
    gu = mm(h, p["mlp"]["w_in"][i].reshape(d, 2 * f), lowp).view(s, 2, f)
    return x + mm(silu(gu[:, 0]) * gu[:, 1], p["mlp"]["w_out"][i], lowp)


def hidden(m: Dict, params: Dict, tokens: torch.Tensor, lowp: Optional[str] = None,
           remat: bool = False) -> torch.Tensor:
    """The final-normed hidden states (S, D) of one sequence of ids (S,)."""
    x = params["embed"]["table"][tokens.long()].float()
    positions = torch.arange(tokens.shape[0], device=x.device)
    for i in range(m["num_layers"]):
        if remat:
            x = checkpoint(layer, m, params, i, x, positions, lowp, use_reentrant=False)
        else:
            x = layer(m, params, i, x, positions, lowp)
    return rmsnorm(x, params["final_norm"]["scale"], m["norm_eps"])


@torch.no_grad()
def logits_rows(m: Dict, params: Dict, tokens: torch.Tensor, rows: Sequence[int],
                lowp: Optional[str] = None) -> torch.Tensor:
    """f32 logits (len(rows), V) at the given positions of one sequence."""
    h = hidden(m, params, tokens, lowp)
    idx = torch.as_tensor(list(rows), device=h.device)
    return mm(h[idx], head(m, params).t(), lowp)


def loss_sum(m: Dict, params: Dict, tokens: torch.Tensor, labels: torch.Tensor,
             z_loss: float, lowp: Optional[str] = None, rows: int = 1024) -> torch.Tensor:
    """Sum over one sequence's positions of the cross-entropy with z-loss,
    differentiable; layers and head chunks recomputed in the backward."""
    h = hidden(m, params, tokens, lowp, remat=True)
    w = head(m, params)
    tot = torch.zeros((), device=h.device)
    for r0 in range(0, h.shape[0], rows):
        tot = tot + checkpoint(ce_sum, h[r0:r0 + rows], w, labels[r0:r0 + rows], z_loss,
                               lowp, use_reentrant=False)
    return tot
