"""A hybrid of Mamba-2 and attention layers, each followed by a
mixture of experts beside a shared expert (IBM Granite 4.0-H, HF
``granitemoehybrid``), written from its layer equations:

    x = m_emb · E[ids]
    per layer:  x = x + m_res · Mixer(RMSNorm(x))       Mixer = Mamba2 or Attn
                h = RMSNorm(x);  x = x + m_res · (MoE(h) + Shared(h))
    logits = RMSNorm(x) · Eᵀ / s_logits

Attention is grouped-query, causal, with no position embedding (NoPE)
and the softmax scale ``attention_multiplier``. Mamba2 is ``ssm.py``'s
block with a bias on the depthwise conv (``silu(conv(x) + b)`` on x, B
and C). The MoE routes each token over all ``num_experts`` router
outputs: the top ``num_experts_per_tok`` by router logit, their weights a
softmax over those; an expert is a SwiGLU of width ``d_ff``, the shared
expert one of width ``shared_d_ff``. Only experts [0, ``experts_held``)
are computed: the share of one chip in an expert-parallel layer, whose
other experts' part of the result is left out (``experts_held`` 0 or
absent: every expert).

Layers follow a period of ``attn_period`` (attention at slot
``attn_period // 2``, Mamba2 elsewhere); each leaf stacks the period's
``num_layers / attn_period`` layers of its slot on a leading dim.
Attention runs in blocks of query rows and the MoE one held expert at a
time, on the tokens routed to it, so that a long sequence fits.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench.reference.common import mm, rmsnorm, silu
from portbench.reference.ssm import causal_conv, ssd

Q_BLOCK = 1024                       # query rows a block of the attention


def _held(m: Dict) -> int:
    return m.get("experts_held") or m["num_experts"]


def LAYOUT(m: Dict) -> Dict:
    L, D, V, P = m["num_layers"], m["d_model"], m["vocab_size"], m["attn_period"]
    G = L // P
    H, Hkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    Di = m["ssm_expand"] * D
    N, K = m["ssm_state"], m["ssm_conv"]
    Hs = Di // m["ssm_head_dim"]
    E, Eh, Fe, Fs = m["num_experts"], _held(m), m["d_ff"], m["shared_d_ff"]

    def normal(std):
        return {"init": "normal", "std": std}
    ones = {"init": "ones"}
    # the table times embedding_multiplier has the inputs' usual std 0.02:
    # N(0, 0.02^2) times 12, with the head tied, puts each token's own
    # logit some 8 standard deviations over the rest, and every served
    # token, the fp8 control's too, is the reference's first
    out = {("embed", "table"): ((V, D), normal(0.02 / m["embedding_multiplier"]))}
    for slot in range(P):
        s = ("layers", slot)
        out[s + ("norm1", "scale")] = ((G, D), ones)
        if slot == P // 2:
            a = s + ("attn",)
            out.update({a + ("wq",): ((G, D, H, hd), normal(D ** -0.5)),
                        a + ("wk",): ((G, D, Hkv, hd), normal(D ** -0.5)),
                        a + ("wv",): ((G, D, Hkv, hd), normal(D ** -0.5)),
                        a + ("wo",): ((G, H, hd, D), normal((H * hd) ** -0.5))})
        else:
            q = s + ("ssm",)
            out.update({
                q + ("w_xz",): ((G, D, 2, Di), normal(D ** -0.5)),
                q + ("w_bc",): ((G, D, 2, N), normal(D ** -0.5)),
                q + ("w_dt",): ((G, D, Hs), normal(D ** -0.5)),
                q + ("conv_x",): ((G, K, Di), normal(K ** -0.5)),
                q + ("conv_b",): ((G, K, N), normal(K ** -0.5)),
                q + ("conv_c",): ((G, K, N), normal(K ** -0.5)),
                q + ("conv_x_bias",): ((G, Di), normal(K ** -0.5)),
                q + ("conv_b_bias",): ((G, N), normal(K ** -0.5)),
                q + ("conv_c_bias",): ((G, N), normal(K ** -0.5)),
                q + ("A_log",): ((G, Hs), {"init": "log_uniform_a", "lo": 1.0, "hi": 16.0}),
                q + ("D",): ((G, Hs), ones),
                q + ("dt_bias",): ((G, Hs), {"init": "inv_softplus_dt", "lo": 1e-3,
                                             "hi": 1e-1}),
                q + ("norm",): ((G, Di), ones),
                q + ("out",): ((G, Di, D), normal(Di ** -0.5))})
        out[s + ("norm2", "scale")] = ((G, D), ones)
        out.update({s + ("moe", "router"): ((G, D, E), normal(D ** -0.5)),
                    s + ("moe", "w_in"): ((G, Eh, D, 2, Fe), normal(D ** -0.5)),
                    s + ("moe", "w_out"): ((G, Eh, Fe, D), normal(Fe ** -0.5)),
                    s + ("shared", "w_in"): ((G, D, 2, Fs), normal(D ** -0.5)),
                    s + ("shared", "w_out"): ((G, Fs, D), normal(Fs ** -0.5))})
    out[("final_norm", "scale")] = ((D,), ones)
    return out


def swiglu(h: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
           lowp: Optional[str] = None) -> torch.Tensor:
    """``(silu(h W_gate) ⊙ (h W_up)) W_out``; w_in (D, 2, F), the gate at 0."""
    d, _, f = w_in.shape
    gu = mm(h, w_in.reshape(d, 2 * f), lowp).view(-1, 2, f)
    return mm(silu(gu[:, 0]) * gu[:, 1], w_out, lowp)


def attention(m: Dict, a: Dict, g: int, h: torch.Tensor,
              lowp: Optional[str] = None) -> torch.Tensor:
    """Causal GQA attention without position embedding, scores scaled by
    ``attention_multiplier``, on one sequence h (S, D)."""
    s, d = h.shape
    H, Hkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    q = mm(h, a["wq"][g].reshape(d, H * hd), lowp).view(s, H, hd)
    k = mm(h, a["wk"][g].reshape(d, Hkv * hd), lowp).view(s, Hkv, hd)
    v = mm(h, a["wv"][g].reshape(d, Hkv * hd), lowp).view(s, Hkv, hd)
    k, v = k.repeat_interleave(H // Hkv, dim=1), v.repeat_interleave(H // Hkv, dim=1)
    out = torch.empty_like(q)
    kpos = torch.arange(s, device=h.device)[None, :]
    for q0 in range(0, s, Q_BLOCK):
        qb = q[q0:q0 + Q_BLOCK]
        scores = torch.einsum("qhd,khd->hqk", qb, k) * m["attention_multiplier"]
        qpos = torch.arange(q0, q0 + qb.shape[0], device=h.device)[:, None]
        scores = scores.masked_fill(kpos > qpos, float("-inf"))
        out[q0:q0 + Q_BLOCK] = torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), v)
    return mm(out.reshape(s, H * hd), a["wo"][g].reshape(H * hd, d), lowp)


def mamba(m: Dict, q: Dict, g: int, h: torch.Tensor, lowp: Optional[str] = None) -> torch.Tensor:
    """The Mamba2 block with a biased conv on one sequence h (S, D)."""
    s, d = h.shape
    di, n, hp = m["ssm_expand"] * d, m["ssm_state"], m["ssm_head_dim"]
    nh = di // hp
    xz = mm(h, q["w_xz"][g].reshape(d, 2 * di), lowp).view(s, 2, di)
    bc = mm(h, q["w_bc"][g].reshape(d, 2 * n), lowp).view(s, 2, n)
    dt_raw = mm(h, q["w_dt"][g], lowp)
    xc = silu(causal_conv(xz[:, 0], q["conv_x"][g].float()) + q["conv_x_bias"][g].float())
    bm = silu(causal_conv(bc[:, 0], q["conv_b"][g].float()) + q["conv_b_bias"][g].float())
    cm = silu(causal_conv(bc[:, 1], q["conv_c"][g].float()) + q["conv_c_bias"][g].float())
    dt = F.softplus(dt_raw + q["dt_bias"][g].float())
    A = -torch.exp(q["A_log"][g].float())
    xh = xc.view(s, nh, hp)
    y = ssd(xh, dt, A, bm, cm, m["ssm_chunk"]) + xh * q["D"][g].float()[:, None]
    y = rmsnorm(y.reshape(s, di) * silu(xz[:, 1]), q["norm"][g], m["norm_eps"])
    return mm(y, q["out"][g], lowp)


def route(logits: torch.Tensor, k: int):
    """(weights (S, k), experts (S, k)): the top k router logits of each
    token and a softmax over them."""
    top, idx = torch.topk(logits, k, dim=-1)
    return torch.softmax(top, dim=-1), idx


def moe(m: Dict, p: Dict, g: int, h: torch.Tensor, lowp: Optional[str] = None) -> torch.Tensor:
    """The held experts' part of the MoE on h (S, D), routed over all."""
    w, idx = route(mm(h, p["router"][g], lowp), m["num_experts_per_tok"])
    y = torch.zeros_like(h)
    for e in range(_held(m)):
        rows, col = (idx == e).nonzero(as_tuple=True)
        if rows.numel():
            o = swiglu(h[rows], p["w_in"][g, e], p["w_out"][g, e], lowp)
            y.index_add_(0, rows, o * w[rows, col][:, None])
    return y


def layer(m: Dict, params: Dict, slot: int, g: int, x: torch.Tensor,
          lowp: Optional[str] = None) -> torch.Tensor:
    """Layer ``g * attn_period + slot`` on one sequence's stream x (S, D)."""
    p = params["layers"][slot]
    eps, r = m["norm_eps"], m["residual_multiplier"]
    h = rmsnorm(x, p["norm1"]["scale"][g], eps)
    if slot == m["attn_period"] // 2:
        mix = attention(m, p["attn"], g, h, lowp)
    else:
        mix = mamba(m, p["ssm"], g, h, lowp)
    x = x + r * mix
    h = rmsnorm(x, p["norm2"]["scale"][g], eps)
    shared = swiglu(h, p["shared"]["w_in"][g], p["shared"]["w_out"][g], lowp)
    return x + r * (moe(m, p["moe"], g, h, lowp) + shared)


def hidden(m: Dict, params: Dict, tokens: torch.Tensor,
           lowp: Optional[str] = None) -> torch.Tensor:
    x = params["embed"]["table"][tokens.long()].float() * m["embedding_multiplier"]
    period = m["attn_period"]
    for i in range(m["num_layers"]):
        x = layer(m, params, i % period, i // period, x, lowp)
    return rmsnorm(x, params["final_norm"]["scale"], m["norm_eps"])


@torch.no_grad()
def logits_rows(m: Dict, params: Dict, tokens: torch.Tensor, rows: Sequence[int],
                lowp: Optional[str] = None) -> torch.Tensor:
    """f32 logits (len(rows), V) at the given positions of one sequence."""
    h = hidden(m, params, tokens, lowp)
    idx = torch.as_tensor(list(rows), device=h.device)
    return mm(h[idx], params["embed"]["table"].t(), lowp) / m["logits_scaling"]
