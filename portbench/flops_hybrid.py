"""Model FLOPs of the hybrid family (``reference/hybrid.py``): Mamba2 and
attention layers, each followed by a mixture of experts beside a shared
expert, of which a chip computes its ``experts_held``.

A product of an (m, k) by a (k, n) matrix counts 2mkn, as in
``flops.py``, and nothing recomputed. A token's layer: its mixer's
projections (Mamba2: x, z, B, C, dt in and the output; attention: q, k,
v and o), the router, the shared expert, and the routed experts at
``top_k × experts_held / num_experts`` of an expert a token: what this
chip's experts compute of it on average, not the rows the lossless
dispatch runs. The sequence mixing: attention 4·hd per visible pair and
q head; the SSD 4PN a token and head (4·Di·N), the conv 2K a channel.
The head on the tokens whose logits are taken.
"""
from __future__ import annotations

from typing import Dict, Sequence

from portbench.flops import head_params


def _held(m: Dict) -> int:
    return m.get("experts_held") or m["num_experts"]


def layer_kinds(m: Dict) -> Dict[str, int]:
    """Layers of each mixer kind: one attention layer a period."""
    attn = m["num_layers"] // m["attn_period"]
    return {"attn": attn, "ssm": m["num_layers"] - attn}


def mixer_params(m: Dict, kind: str) -> int:
    """Weights of a mixer that enter a matrix product."""
    d = m["d_model"]
    if kind == "attn":
        return d * m["head_dim"] * (2 * m["num_heads"] + 2 * m["num_kv_heads"])
    di = m["ssm_expand"] * d
    return d * (2 * di + 2 * m["ssm_state"] + di // m["ssm_head_dim"]) + di * d


def ffn_params_per_token(m: Dict) -> float:
    """The router, the shared expert and this chip's share of the routed
    experts a token meets on average."""
    d = m["d_model"]
    routed = m["num_experts_per_tok"] * _held(m) / m["num_experts"]
    return d * m["num_experts"] + 3 * d * m["shared_d_ff"] + routed * 3 * d * m["d_ff"]


def body_params_per_token(m: Dict) -> float:
    kinds = layer_kinds(m)
    return sum(n * mixer_params(m, k) for k, n in kinds.items()) \
        + m["num_layers"] * ffn_params_per_token(m)


def mixer_flops(m: Dict, fills: Sequence[int]) -> float:
    """The sequence mixing of tokens at these fills (the positions they
    see, themselves included), all layers."""
    kinds = layer_kinds(m)
    di, n = m["ssm_expand"] * m["d_model"], m["ssm_state"]
    ssm = (4.0 * di * n + 2.0 * m["ssm_conv"] * (di + 2 * n)) * len(fills)
    attn = 4.0 * m["num_heads"] * m["head_dim"] * float(sum(fills))
    return kinds["ssm"] * ssm + kinds["attn"] * attn


def prefill_flops(m: Dict, n: int) -> float:
    """A prompt of n tokens: every layer on every token, the head on the
    last one."""
    return 2.0 * body_params_per_token(m) * n + 2.0 * head_params(m) \
        + mixer_flops(m, range(1, n + 1))


def decode_flops(m: Dict, fills: Sequence[int]) -> float:
    """One decode step of len(fills) live rows, each at its fill."""
    per_tok = 2.0 * (body_params_per_token(m) + head_params(m))
    return per_tok * len(fills) + mixer_flops(m, fills)
