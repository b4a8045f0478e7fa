"""The decoder LM, the counterpart of ``repro/models/model.py``: dense,
MoE, SSM, hybrid, vision-frontend and audio-codebook backbones.

``forward`` covers train and prefill without a cache, with the JAX remat
policies (``torch.utils.checkpoint`` per period group); ``cross_entropy``
is the chunked training loss; ``prefill`` builds the cache;
``decode_step`` advances one token against it. Layers run as a
Python loop over period groups (the JAX package's ``lax.scan``). The
dtype flow is the JAX one: the residual stream in ``cfg.dtype`` (bf16),
every product in bf16, norms, softmax and the SSD scan in f32.

An attention slot's cache is ``{"k","v"}``; an SSM slot's is the
recurrent state ``h`` (f32) and the conv inputs ``conv_x/b/c``. On the
card, attention prefill runs the CUDA flash-attention kernel, attention
decode the flash-decoding kernel, and SSM prefill the CUDA SSD-scan
kernel; SSM decode is the one-token recurrence in plain tensor ops, as
in the JAX package.

Under a mesh (``decode_step``'s ``cp_axis``/``mesh``), each rank holds
its ``S/n`` rows of every KV cache, split on the sequence over
``cp_axis``, writes a new token's K/V where its row lies, and merges
attention across the ranks (``attention.decode_attention_context_parallel``);
the rest of the step is computed whole on every rank. The projections
out of the attention, MLP and SSM blocks are ``layers.row_parallel``, as
in JAX: a plain product unless ``precision.bf16_collectives()`` and a
``model`` axis ask for the explicit tensor-parallel sum.

Unlike the JAX functions, ``decode_step`` writes the new token's K/V and
the new SSM states into the cache it is given, in place, and returns
that same cache: JAX's ``.at[].set`` builds a new array, which on the
card would copy the whole cache every step.

On a mesh (``use_mesh``) the training forward also takes each weight as
this rank's block of the train state's layout (``parallel/sharding.
place``, JAX's ``param_shardings``): d_model gathered over ``data``
(``layers.fsdp_gather``), and a block of the heads, mlp or vocab dim
computed tensor-parallel over ``model``: q/k/v column-parallel over the
rank's heads (KV heads that do not divide the axis are whole, and each
rank takes those its q heads read), ``wo`` and the MLP's ``w_out``
row-parallel (``layers.tp_product``), the embedding and the head
vocab-parallel (the lookup masked to the rank's rows and summed, the
loss's logsumexp merged over the vocab blocks by an all-reduce of the
max and of the sum). A whole weight keeps the replicated compute.

An MoE layer's FFN is ``moe.moe_ffn`` (the local dispatch; its
load-balance loss sums into ``ForwardResult.aux_loss``), with
``capacity_factor`` 1.25 in ``forward`` and lossless (``None``) in
``prefill`` and ``decode_step``, as in the JAX package; ``decode_step``
leaves the MoE metrics out, which it would throw away. A
config of the port's own (``configs/port.py::HybridMoEConfig``, read
through ``option``, whose defaults leave every other arch as it is)
adds a shared expert beside
the MoE (``_ffn``), the experts held here (``experts_held``), a bias on
the Mamba2 conv, NoPE attention, and multipliers on the embedding (in
f32, before its bf16 rounding), on each residual branch (``_branch``),
on the attention scores (K1's and K2's softmax scale, in place of
1/sqrt(hd)) and on the logits. Codebook configs
take tokens (B,S,C), embed them as the sum of the per-codebook tables
and give logits (B,S,C,V); a frontend's embeddings (B,F,D) go in front
of the token embeddings.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.port import option
from repro_torch.kernels import use_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.core.collectives import all_gather, all_reduce
from repro_torch.models.layers import (activation_fn, fsdp_gather, mlp, rmsnorm, rope,
                                       row_parallel, tp_enter, tp_product)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.params import (check_supported, layer_period,
                                       num_groups, slot_kind)
from repro_torch.parallel.sharding import current_mesh

PyTree = Any


class ForwardResult(NamedTuple):
    hidden: torch.Tensor       # (B, S, D)
    aux_loss: torch.Tensor     # MoE load-balance loss (0 for non-MoE)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _group(slot_params: dict, g: int) -> dict:
    """Layer ``g`` of a stacked per-slot tree (views, no copies)."""
    return {k: _group(v, g) if isinstance(v, dict) else v[g]
            for k, v in slot_params.items()}


def _layers(cfg: ModelConfig, params: PyTree):
    """Yield (slot, group, layer params) in layer order."""
    for g in range(num_groups(cfg)):
        for slot in range(layer_period(cfg)):
            yield slot, g, _group(params["layers"][slot], g)


# ----------------------------------------------------------------------
# embeddings
# ----------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor,
                 frontend_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings in ``cfg.dtype`` (``model.py:35-50``): tokens (B,S),
    or (B,S,C) for codebooks, summed over the per-codebook tables in f32;
    ``frontend_embeds`` (B,F,D) in front of them."""
    check_supported(cfg)
    mesh = current_mesh()
    table = fsdp_gather(params["embed"]["table"], -1, cfg.d_model, mesh)
    tokens = tokens.long()
    lo, inside = _vocab_lo(cfg, table, mesh), None
    if lo is not None:                  # this rank's vocab rows: masked, summed
        tokens = tokens - lo
        inside = (tokens >= 0) & (tokens < table.shape[-2])
        tokens = torch.where(inside, tokens, 0)
    if cfg.num_codebooks > 1:
        x = sum(_masked(table[c][tokens[..., c]], None if inside is None else inside[..., c])
                for c in range(cfg.num_codebooks))
    else:
        x = _masked(table[tokens], inside)
    if lo is not None:
        x = all_reduce(x, mesh.get_group("model"))
    if option(cfg, "embedding_multiplier") != 1.0:     # in f32, one rounding below
        x = x * option(cfg, "embedding_multiplier")
    x = x.to(_dtype(cfg))
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    return x


def _masked(rows: torch.Tensor, inside: Optional[torch.Tensor]) -> torch.Tensor:
    return rows if inside is None else rows * inside[..., None]


def _vocab_lo(cfg: ModelConfig, table: torch.Tensor, mesh) -> Optional[int]:
    """The first vocab row of a vocab-parallel table block, or None for a
    whole table."""
    rows = table.shape[-2]
    return None if rows == cfg.vocab_size else mesh.index("model") * rows


# ----------------------------------------------------------------------
# single layer
# ----------------------------------------------------------------------

def _kv_for_heads(cfg: ModelConfig, w: torch.Tensor, hq_local: int, mesh) -> torch.Tensor:
    """The KV heads of a whole ``wk``/``wv`` (D, Hkv, hd) that this
    rank's block of ``hq_local`` q heads reads, for a tensor-parallel
    attention whose KV heads do not divide ``model`` (replicated, as
    ``logical_to_spec`` leaves them): their contiguous run where the q
    heads take whole GQA groups or share one, else one KV head per q
    head. ``pvary``: each rank reads its own heads of the replicated
    weight, so its grad is summed over ``model``."""
    group = cfg.num_heads // cfg.num_kv_heads
    lo = mesh.index("model") * hq_local
    idx = [(lo + i) // group for i in range(hq_local)]
    runs = sorted(set(idx))
    w = tp_enter(w, mesh)
    if hq_local % len(runs) == 0 and \
            idx == [r for r in runs for _ in range(hq_local // len(runs))]:
        return w.narrow(1, runs[0], len(runs))
    return w.index_select(1, torch.tensor(idx, device=w.device))


def _project_qkv(cfg: ModelConfig, p: dict, h: torch.Tensor, positions):
    """bf16 q/k/v (B,S,H,hd), roped. Each is a (B·S, D) x (D, H·hd)
    product viewed as (B,S,H,hd), so it comes out contiguous. A block of
    ``wq``'s heads (a mesh's ``model`` axis) gives this rank's heads, and
    k/v the KV heads they read."""
    b, s, d = h.shape
    mesh = current_mesh()
    wq, wk, wv = (fsdp_gather(p[n], 0, d, mesh) for n in ("wq", "wk", "wv"))
    xc = h.to(torch.bfloat16).reshape(b * s, d)
    if wq.shape[1] != cfg.num_heads:            # tensor-parallel over the heads
        xc = tp_enter(xc, mesh)
        if wk.shape[1] == cfg.num_kv_heads:
            wk, wv = (_kv_for_heads(cfg, w, wq.shape[1], mesh) for w in (wk, wv))

    def proj(w):
        return (xc @ w.to(torch.bfloat16).reshape(d, -1)).view(b, s, w.shape[1], w.shape[2])

    if not option(cfg, "rope"):                 # NoPE
        return proj(wq), proj(wk), proj(wv)
    q = rope(proj(wq), positions, cfg.rope_theta, cfg.rope_fraction)
    k = rope(proj(wk), positions, cfg.rope_theta, cfg.rope_fraction)
    return q, k, proj(wv)


def _out_proj(p: dict, out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    b, s, h, hd = out.shape
    y = out.to(torch.bfloat16).reshape(b, s, h * hd) \
        @ p["wo"].to(torch.bfloat16).reshape(h * hd, -1)
    return y.to(dtype)


def _write_cache(cache: dict, k, v, pos: torch.Tensor) -> None:
    """Put this step's k/v (B,1,Hkv,hd) at ``pos`` (scalar or (B,)), in
    place. Out-of-range positions behave as in JAX: a scalar start is
    clamped to the last row (``dynamic_update_slice``), and a per-row
    write past the end is dropped (``.at[].set``). An idle slot whose
    last request filled its cache keeps ``pos == max_len``."""
    last = cache["k"].shape[1] - 1
    if pos.dim() == 0:         # aligned batch: one shared position
        idx = pos.reshape(1).long().clamp(0, last)
        cache["k"].index_copy_(1, idx, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, idx, v.to(cache["v"].dtype))
    else:                      # continuous batching: per-row positions
        bidx = torch.arange(k.shape[0], device=k.device)
        idx = pos.long().clamp(0, last)
        keep = (pos <= last)[:, None, None]
        for name, new in (("k", k), ("v", v)):
            c = cache[name]
            c[bidx, idx] = torch.where(keep, new[:, 0].to(c.dtype), c[bidx, idx])


def _write_cache_shard(cache: dict, k, v, pos: torch.Tensor, lo: int, total: int) -> None:
    """``_write_cache`` on this rank's rows [lo, lo + rows) of a cache of
    ``total`` rows split on the sequence: the rank whose rows hold a
    position writes it, the others keep their rows. Positions behave as
    in ``_write_cache`` against the whole cache (a scalar clamped to the
    last row, a per-row position past the end dropped)."""
    rows = cache["k"].shape[1]
    if pos.dim() == 0:
        g = pos.reshape(1).long().clamp(0, total - 1)
        idx = (g - lo).clamp(0, rows - 1)
        keep = ((g >= lo) & (g < lo + rows)).reshape(1, 1, 1, 1)
        for name, new in (("k", k), ("v", v)):
            c = cache[name]
            c.index_copy_(1, idx, torch.where(keep, new.to(c.dtype), c.index_select(1, idx)))
    else:
        bidx = torch.arange(k.shape[0], device=k.device)
        g = pos.long()
        idx = (g - lo).clamp(0, rows - 1)
        keep = ((g >= lo) & (g < lo + rows) & (g <= total - 1))[:, None, None]
        for name, new in (("k", k), ("v", v)):
            c = cache[name]
            c[bidx, idx] = torch.where(keep, new[:, 0].to(c.dtype), c[bidx, idx])


def _attention_mixer(cfg: ModelConfig, kind: dict, p: dict, x: torch.Tensor, *,
                     positions, impl: str, cache: Optional[dict] = None,
                     pos: Optional[torch.Tensor] = None, cp_axis: Optional[str] = None,
                     mesh=None, attend: Optional[Callable] = None):
    window = cfg.window_size if kind["local"] else None
    scale = option(cfg, "attention_multiplier")
    q, k, v = _project_qkv(cfg, p, x, positions)
    if cache is None:
        out = attn_mod.attention(q, k, v, causal=True, window=window,
                                 softcap=cfg.attn_logit_softcap, impl=impl, scale=scale)
    elif cp_axis:
        rows, n = cache["k"].shape[1], mesh.shape[cp_axis]
        _write_cache_shard(cache, k, v, pos, mesh.index(cp_axis) * rows, rows * n)
        out = attn_mod.decode_attention_context_parallel(
            q, cache["k"], cache["v"], pos + 1, mesh=mesh, axis=cp_axis,
            window=window, softcap=cfg.attn_logit_softcap, scale=scale)
    else:
        _write_cache(cache, k, v, pos)
        out = (attend or attn_mod.decode)(q, cache["k"], cache["v"], pos + 1, window=window,
                                          softcap=cfg.attn_logit_softcap, impl=impl,
                                          scale=scale)
    wo = fsdp_gather(p["wo"], 2, x.shape[-1], current_mesh())
    if wo.shape[0] != cfg.num_heads:            # row-parallel over the heads
        y = tp_product(out, wo, 2, current_mesh())
    else:
        y = row_parallel(out.to(torch.bfloat16), wo.to(torch.bfloat16), x_shard_dim=2)
    return y.to(x.dtype)


def _ssm_inputs(cfg: ModelConfig, p: dict, h: torch.Tensor):
    """The Mamba2 block's bf16 projections (``model.py:104-111``):
    x_in, z (B,S,Di), b_in, c_in (B,S,N), dt_raw (B,S,H), and A (H,) f32.
    x_in/z and b_in/c_in are views of one product each. A block of
    ``w_xz``'s inner dim (a mesh's ``model`` axis) gives this rank's
    heads of x_in, z, dt_raw and A; B and C, whole, enter its heads'
    work through ``pvary``."""
    b, s, d = h.shape
    mesh = current_mesh()
    w_xz, w_bc, w_dt = (fsdp_gather(p[n], 0, d, mesh) for n in ("w_xz", "w_bc", "w_dt"))
    din, n = w_xz.shape[2], cfg.ssm_state
    xc = h.to(torch.bfloat16).reshape(b * s, d)
    if din != cfg.d_inner:                      # tensor-parallel over the heads
        if w_dt.shape[1] * cfg.ssm_head_dim != din:
            raise ValueError(f"{cfg.name}: the model axis splits d_inner {cfg.d_inner} "
                             f"but not the {cfg.ssm_heads} SSM heads")
        xc = tp_enter(xc, mesh)
        w_bc = tp_enter(w_bc, mesh)

    def proj(w):
        return xc @ w.to(torch.bfloat16).reshape(d, -1)

    xz = proj(w_xz).view(b, s, 2, din)
    bc = proj(w_bc).view(b, s, 2, n)
    dt_raw = proj(w_dt).view(b, s, w_dt.shape[1])
    A = -torch.exp(p["A_log"].float())
    return xz[..., 0, :], xz[..., 1, :], bc[..., 0, :], bc[..., 1, :], dt_raw, A


def _ssm_scan_inputs(cfg: ModelConfig, p: dict, x_in, b_in, c_in, dt_raw):
    """Conv (with its bias where the config has one), silu and softplus
    over a whole prompt (``model.py:113-120``): the scan's xh (B,S,H,P),
    dt (B,S,H) f32, B and C (B,S,N) contiguous, and the conv states (the
    last K-1 inputs of x, B, C). H is this rank's heads where x_in is its
    block."""
    b, s, din = x_in.shape
    conv_b, conv_c = p["conv_b"], p["conv_c"]
    bias_b, bias_c = p.get("conv_b_bias"), p.get("conv_c_bias")
    if din != cfg.d_inner:
        mesh = current_mesh()
        conv_b, conv_c = tp_enter(conv_b, mesh), tp_enter(conv_c, mesh)
        if bias_b is not None:
            bias_b, bias_c = tp_enter(bias_b, mesh), tp_enter(bias_c, mesh)
    x_conv, st_x = ssm_mod.causal_conv(x_in, p["conv_x"].to(x_in.dtype))
    b_conv, st_b = ssm_mod.causal_conv(b_in, conv_b.to(b_in.dtype))
    c_conv, st_c = ssm_mod.causal_conv(c_in, conv_c.to(c_in.dtype))
    if bias_b is not None:
        x_conv, b_conv, c_conv = (y + bias.to(y.dtype) for y, bias in (
            (x_conv, p["conv_x_bias"]), (b_conv, bias_b), (c_conv, bias_c)))
    x_conv, b_conv, c_conv = F.silu(x_conv), F.silu(b_conv), F.silu(c_conv)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    xh = x_conv.view(b, s, din // cfg.ssm_head_dim, cfg.ssm_head_dim)
    return xh, dt, b_conv.contiguous(), c_conv.contiguous(), (st_x, st_b, st_c)


def _ssm_sequence(cfg: ModelConfig, p: dict, x_in, b_in, c_in, dt_raw, A, *,
                  impl: str):
    """Conv, silu, softplus and the SSD scan over a whole prompt
    (``model.py:113-126``). Returns (y (B,S,Di) f32 with the D skip, the
    final state (B,H,P,N) f32, the conv states). On the card the scan is
    the CUDA ``ssd_scan`` kernel at any length; on the CPU, or with
    ``impl="ref"``, it is ``ssd_chunked``. The kernel's y is f32, as the
    Pallas kernel's; the JAX prefill and default forward call
    ``ssd_chunked``, whose y has x's dtype (bf16), so the kernel's y is
    rounded to it as well."""
    b, s, din = x_in.shape
    xh, dt, b_conv, c_conv, states = _ssm_scan_inputs(cfg, p, x_in, b_in, c_in, dt_raw)
    if use_kernel(impl, xh):
        y, hfin = ssd_ops.ssd_scan(xh, dt, A, b_conv, c_conv, chunk=cfg.ssm_chunk)
        y = y.to(xh.dtype)
    else:
        y, hfin = ssm_mod.ssd_chunked(xh, dt, A, b_conv, c_conv, chunk=cfg.ssm_chunk)
    y = y + xh.float() * p["D"].float()[None, None, :, None]
    return y.reshape(b, s, din), hfin, states


def _ssm_step(cfg: ModelConfig, p: dict, x_in, b_in, c_in, dt_raw, A,
              cache: dict) -> torch.Tensor:
    """One decode token (``model.py:128-139``) for every row: the conv
    and SSD recurrences advance one step and their new states are
    written into ``cache`` in place (idle rows too, as JAX updates every
    row). Returns y (B,1,Di) f32 with the D skip."""
    b = x_in.shape[0]
    x_c, cs_x = ssm_mod.causal_conv_step(x_in[:, 0], p["conv_x"].to(x_in.dtype), cache["conv_x"])
    b_c, cs_b = ssm_mod.causal_conv_step(b_in[:, 0], p["conv_b"].to(b_in.dtype), cache["conv_b"])
    c_c, cs_c = ssm_mod.causal_conv_step(c_in[:, 0], p["conv_c"].to(c_in.dtype), cache["conv_c"])
    if "conv_x_bias" in p:
        x_c, b_c, c_c = (y + p[name].to(y.dtype) for y, name in (
            (x_c, "conv_x_bias"), (b_c, "conv_b_bias"), (c_c, "conv_c_bias")))
    x_c, b_c, c_c = F.silu(x_c), F.silu(b_c), F.silu(c_c)
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"].float())
    xh = x_c.view(b, cfg.ssm_heads, cfg.ssm_head_dim)
    yt, hnew = ssm_mod.ssd_decode_step(xh, dt, A, b_c, c_c, cache["h"])
    for name, new in (("h", hnew), ("conv_x", cs_x), ("conv_b", cs_b), ("conv_c", cs_c)):
        cache[name].copy_(new)
    yt = yt + xh.float() * p["D"].float()[None, :, None]
    return yt.reshape(b, 1, cfg.d_inner)


def _ssm_out(cfg: ModelConfig, p: dict, y: torch.Tensor, z: torch.Tensor,
             dtype: torch.dtype, row: bool = False) -> torch.Tensor:
    """Mamba2's gated RMSNorm ``rmsnorm(y * silu(z), norm)`` in f32 and
    the bf16 out product (``model.py:141-146``): ``row_parallel`` where
    the JAX block takes it (``row``), the plain product in ``prefill``.
    This rank's block of the inner dim (y, z, ``norm`` and ``out``'s rows)
    takes the norm's mean square over ``model`` and the out product
    row-parallel."""
    b, s, din = y.shape
    g = y.float() * F.silu(z.float())
    if din != cfg.d_inner:
        mesh = current_mesh()
        sq = all_reduce((g * g).sum(dim=-1, keepdim=True), mesh.get_group("model"))
        var = tp_enter(sq, mesh) / torch.tensor(float(cfg.d_inner), device=g.device)
        g = g * torch.rsqrt(var + cfg.norm_eps) * p["norm"].float()
        out = fsdp_gather(p["out"], 1, cfg.d_model, mesh)
        return tp_product(g, out, 2, mesh).to(dtype)
    y = rmsnorm(g, p["norm"], cfg.norm_eps)
    w_out = fsdp_gather(p["out"], 1, cfg.d_model, current_mesh())
    if row:
        return row_parallel(y.to(torch.bfloat16), w_out.to(torch.bfloat16),
                            x_shard_dim=2).to(dtype)
    out = y.to(torch.bfloat16).reshape(b * s, din) @ w_out.to(torch.bfloat16)
    return out.view(b, s, -1).to(dtype)


def _ssm_mixer(cfg: ModelConfig, p: dict, x: torch.Tensor, *, impl: str,
               cache: Optional[dict] = None) -> torch.Tensor:
    """The Mamba2 block (``model.py:99-146``). With ``cache`` (one
    layer's ``{"h","conv_x","conv_b","conv_c"}``) it is a decode step
    that writes the states in place."""
    x_in, z, b_in, c_in, dt_raw, A = _ssm_inputs(cfg, p, x)
    if cache is None:
        y, _, _ = _ssm_sequence(cfg, p, x_in, b_in, c_in, dt_raw, A, impl=impl)
    else:
        y = _ssm_step(cfg, p, x_in, b_in, c_in, dt_raw, A, cache)
    return _ssm_out(cfg, p, y, z, x.dtype, row=True)


def _branch(cfg: ModelConfig, y: torch.Tensor) -> torch.Tensor:
    """A residual branch's output times ``residual_multiplier``."""
    r = option(cfg, "residual_multiplier")
    return y if r == 1.0 else y * r


def _ffn(cfg: ModelConfig, kind: dict, p: dict, x: torch.Tensor,
         capacity_factor: Optional[float], *, metrics: bool = True,
         held_count: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The residual FFN (``model.py:163-173``): the dense gated MLP, or
    the MoE at ``capacity_factor`` plus the shared expert where the
    config has one. Returns (x, the MoE's load-balance loss, or None:
    also with ``metrics=False``, which leaves the MoE's metrics out);
    ``held_count`` as ``moe.moe_ffn``'s."""
    if not kind["has_ffn"]:
        return x, None
    h = rmsnorm(x, p["norm2"]["scale"], cfg.norm_eps)
    act = activation_fn(cfg.mlp_activation)
    if kind["moe"]:
        y, got = moe_ffn(h, p["moe"], num_experts=cfg.num_experts,
                         top_k=cfg.num_experts_per_tok, activation=act,
                         capacity_factor=capacity_factor, metrics=metrics,
                         held_count=held_count)
        if "shared" in p:
            y = y + mlp(h, p["shared"], act, d_ff=option(cfg, "shared_d_ff"))
        return x + _branch(cfg, y), None if got is None else got.aux_loss
    return x + _branch(cfg, mlp(h, p["mlp"], act, d_ff=cfg.d_ff)), None


def apply_layer(cfg: ModelConfig, slot: int, p: dict, x: torch.Tensor, *,
                positions, impl: str = "auto", cache: Optional[dict] = None,
                pos: Optional[torch.Tensor] = None, cp_axis: Optional[str] = None,
                mesh=None, capacity_factor: Optional[float] = 1.25,
                attend: Optional[Callable] = None,
                held_count: Optional[torch.Tensor] = None):
    """One layer: an attention or SSM mixer, then the dense MLP or the MoE
    where the config has an FFN. With ``cache`` (one layer's ``{"k","v"}``
    of shape (B,max_len,Hkv,hd), or its SSM states) it is a decode step
    that writes the cache in place; with ``cp_axis``, this rank's rows of
    a cache split on the sequence over that axis of ``mesh``; ``attend``
    and ``held_count`` as in ``decode_step``. Returns (x, aux): the MoE's
    load-balance loss, None for other layers and for a decode step (JAX's
    0, ``model.py:149-175``, without a device op on every decode step)."""
    kind = slot_kind(cfg, slot)
    h = rmsnorm(x, p["norm1"]["scale"], cfg.norm_eps)
    if kind["kind"] == "attn":
        mix = _attention_mixer(cfg, kind, p["attn"], h, positions=positions,
                               impl=impl, cache=cache, pos=pos, cp_axis=cp_axis,
                               mesh=mesh, attend=attend)
    else:
        mix = _ssm_mixer(cfg, p["ssm"], h, impl=impl, cache=cache)
    return _ffn(cfg, kind, p, x + _branch(cfg, mix), capacity_factor,
                metrics=cache is None, held_count=held_count)


# ----------------------------------------------------------------------
# forward (train / prefill without a cache)
# ----------------------------------------------------------------------

REMATS = ("none", "minimal", "full")


def _save_matmuls(ctx, op, *args, **kwargs):
    """``remat="minimal"``: keep the outputs of plain matrix products
    (``aten.mm``: the projections and the MLP, none with a batch dim) and
    recompute everything else, the attention's batched products
    included: JAX's ``dots_with_no_batch_dims_saveable``
    (``model.py:198-202``)."""
    return (CheckpointPolicy.MUST_SAVE if op == torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def forward(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor] = None, *,
            impl: str = "auto", remat: str = "minimal",
            capacity_factor: Optional[float] = 1.25) -> ForwardResult:
    """Hidden states (B,F+S,D) after the final norm, and the MoE layers'
    summed load-balance loss. ``remat`` applies when autograd records:
    each period group under ``torch.utils.checkpoint``, saving nothing
    inside (``"full"``), the plain matrix products' outputs
    (``"minimal"``) or everything (``"none"``). It changes memory, never
    the numbers."""
    if remat not in REMATS:
        raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")
    x = embed_tokens(cfg, params, tokens, frontend_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    period = layer_period(cfg)

    def group_body(x, aux, g):
        for slot in range(period):
            x, a = apply_layer(cfg, slot, _group(params["layers"][slot], g), x,
                               positions=positions, impl=impl,
                               capacity_factor=capacity_factor)
            aux = aux if a is None else aux + a
        return x, aux

    # no random ops in the model: the RNG state need not be replayed
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if remat == "minimal":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _save_matmuls)
    aux = torch.zeros((), device=x.device)
    for g in range(num_groups(cfg)):
        if remat == "none" or not torch.is_grad_enabled():
            x, aux = group_body(x, aux, g)
        else:
            x, aux = checkpoint(group_body, x, aux, g, **kw)
    x = rmsnorm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return ForwardResult(hidden=x, aux_loss=aux)


def _head_table(cfg: ModelConfig, params: PyTree) -> torch.Tensor:
    return (params["embed"]["table"] if cfg.tie_embeddings
            else params["lm_head"]["w"])


def _head(cfg: ModelConfig, params: PyTree, hidden: torch.Tensor):
    """(the head table in bf16, whole on d_model; hidden in bf16; the
    table's first vocab row if it is this rank's vocab block, else None).
    A vocab block's hidden enters through ``pvary``."""
    mesh = current_mesh()
    table = fsdp_gather(_head_table(cfg, params), -1, cfg.d_model, mesh)
    lo = _vocab_lo(cfg, table, mesh)
    h = hidden.to(torch.bfloat16)
    return table.to(torch.bfloat16), (h if lo is None else tp_enter(h, mesh)), lo


def _head_logits(cfg: ModelConfig, h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """f32 logits of bf16 products, divided by ``logits_scaling`` and
    soft-capped where the config says."""
    if cfg.num_codebooks > 1:
        logits = torch.einsum("bsd,cvd->bscv", h, table).float()
    else:
        logits = (h @ table.T).float()
    if option(cfg, "logits_scaling") != 1.0:
        logits = logits / option(cfg, "logits_scaling")
    if cfg.final_logit_softcap:
        logits = cfg.final_logit_softcap * torch.tanh(logits / cfg.final_logit_softcap)
    return logits


def logits_for(cfg: ModelConfig, params: PyTree, hidden: torch.Tensor) -> torch.Tensor:
    """Full f32 logits (B,S,V), or (B,S,C,V) for codebooks, from bf16
    products (``model.py:221-233``); a vocab block's logits gathered over
    ``model``."""
    table, h, lo = _head(cfg, params, hidden)
    logits = _head_logits(cfg, h, table)
    if lo is not None:
        logits = all_gather(logits, current_mesh().get_group("model"), -1)
    return logits


def _ce_chunk(cfg: ModelConfig, h: torch.Tensor, lab: torch.Tensor,
              msk: torch.Tensor, table: torch.Tensor, lo: Optional[int] = None,
              group=None):
    """One chunk of ``cross_entropy``: (sum of masked CE, sum of masked
    lse²). The head product is bf16, the logsumexp f32. With ``lo`` the
    table is this rank's vocab block from row ``lo``: the logsumexp takes
    the max and the sum of the exponentials over ``group``'s blocks, and
    the label's logit comes from the block that holds it."""
    logits = _head_logits(cfg, h, table)
    if lo is None:
        lse = torch.logsumexp(logits, dim=-1)            # (B,C) or (B,C,cb)
        ll = torch.gather(logits, -1, lab.long()[..., None])[..., 0]
    else:
        m = all_reduce(logits.detach().amax(dim=-1), group, dist.ReduceOp.MAX)
        lse = torch.log(all_reduce(torch.exp(logits - m[..., None]).sum(dim=-1), group)) + m
        lab = lab.long() - lo
        inside = (lab >= 0) & (lab < logits.shape[-1])
        ll = torch.gather(logits, -1, torch.where(inside, lab, 0)[..., None])[..., 0]
        ll = all_reduce(ll * inside, group)
    ce = lse - ll
    if cfg.num_codebooks > 1:
        ce, lse = ce.mean(-1), lse.mean(-1)
    return (ce * msk).sum(), ((lse ** 2) * msk).sum()


def cross_entropy(cfg: ModelConfig, params: PyTree, hidden: torch.Tensor,
                  labels: torch.Tensor, loss_mask: torch.Tensor, *,
                  chunk: int = 512, z_loss: float = 1e-4) -> torch.Tensor:
    """Chunked CE with z-loss (``model.py:236-283``): mean over the mask
    of ``lse - logit[label]`` plus ``z_loss`` times the mean of lse².

    hidden (B,S,D); labels (B,S) int [(B,S,C) for codebooks, averaged
    over them]; loss_mask (B,S) f32. The chunk halves while it does not
    divide S. Each chunk runs under ``torch.utils.checkpoint`` when
    autograd records, so its (B, chunk, V) logits are recomputed in the
    backward and (B, S, V) never exists at once. A vocab-parallel head
    (``_ce_chunk``'s ``lo``) gives every rank of ``model`` the same loss."""
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    table, hidden, lo = _head(cfg, params, hidden)
    zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
    tot, cnt, zacc = zero, zero, zero
    body = functools.partial(_ce_chunk, cfg, lo=lo,
                             group=None if lo is None else current_mesh().get_group("model"))
    for c0 in range(0, s, chunk):
        args = (hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
                loss_mask[:, c0:c0 + chunk], table)
        if torch.is_grad_enabled():
            ce, zz = checkpoint(body, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            ce, zz = body(*args)
        tot = tot + ce
        zacc = zacc + zz
        cnt = cnt + args[2].sum()
    cnt = torch.clamp(cnt, min=1.0)
    return tot / cnt + z_loss * zacc / cnt


# ----------------------------------------------------------------------
# KV cache + decode
# ----------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> Tuple[dict, ...]:
    """A tuple of per-slot caches, each leaf with a leading G (groups):
    ``{"k","v"}`` (G,B,max_len,Hkv,hd) for attention; for SSM the state
    ``h`` (G,B,H,P,N), always f32, and ``conv_x`` (G,B,K-1,Di),
    ``conv_b``/``conv_c`` (G,B,K-1,N) in ``dtype``
    (``model.py:288-311``)."""
    check_supported(cfg)
    device = resolve_device(device)
    g = num_groups(cfg)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    slots = []
    for slot in range(layer_period(cfg)):
        if slot_kind(cfg, slot)["kind"] == "attn":
            shp = (g, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
            slots.append({"k": zeros(*shp), "v": zeros(*shp)})
        else:
            k, n = cfg.ssm_conv, cfg.ssm_state
            slots.append({
                "h": zeros(g, batch, cfg.ssm_heads, cfg.ssm_head_dim, n, dt=torch.float32),
                "conv_x": zeros(g, batch, k - 1, cfg.d_inner),
                "conv_b": zeros(g, batch, k - 1, n),
                "conv_c": zeros(g, batch, k - 1, n)})
    return tuple(slots)


def init_cache_logical(cfg: ModelConfig) -> Tuple[dict, ...]:
    """Each cache slot's logical axes (``model.py:327-342``)."""
    slots_l = []
    for slot in range(layer_period(cfg)):
        if slot_kind(cfg, slot)["kind"] == "attn":
            lg = ("layer_group", "decode_batch", "kv_seq", "kv_heads", None)
            slots_l.append({"k": lg, "v": lg})
        else:
            slots_l.append({
                "h": ("layer_group", "decode_batch", "ssm_inner", None, None),
                "conv_x": ("layer_group", "decode_batch", None, "ssm_inner"),
                "conv_b": ("layer_group", "decode_batch", None, None),
                "conv_c": ("layer_group", "decode_batch", None, None),
            })
    return tuple(slots_l)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16):
    """(``init_cache``'s tree on the ``meta`` device, logical axes): no
    allocation (the dry-run's)."""
    return init_cache(cfg, batch, max_len, dtype, "meta"), init_cache_logical(cfg)


def shard_cache(cfg: ModelConfig, cache: Tuple[dict, ...], mesh,
                axis: str = "data") -> Tuple[dict, ...]:
    """This rank's rows of each attention cache of a whole cache, split
    on the sequence over ``axis`` (the layout ``decode_step``'s
    ``cp_axis`` takes: rank i of n holds rows [i·S/n, (i+1)·S/n), every
    head), copied so the whole cache can go. SSM states stay whole."""
    n, i = mesh.shape[axis], mesh.index(axis)

    def cut(t):
        rows = t.shape[2] // n
        return t.narrow(2, i * rows, rows).clone()
    return tuple({k: cut(t) for k, t in c.items()} if "k" in c else c for c in cache)


def decode_step(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor,
                cache: Tuple[dict, ...], pos: Union[int, torch.Tensor], *,
                cp_axis: Optional[str] = None, mesh=None, impl: str = "auto",
                attend: Optional[Callable] = None,
                held_count: Optional[torch.Tensor] = None):
    """One decode step. tokens (B,1), or (B,1,C) for codebooks; pos a
    scalar (aligned batch) or (B,) int tensor (continuous batching). MoE
    layers dispatch losslessly. Writes the cache in place. With
    ``cp_axis`` (context parallelism), ``cache`` is this rank's rows of
    each attention cache split on the sequence over that axis of
    ``mesh`` (``model.py:345-364``): rank i of n holds rows [i·S/n,
    (i+1)·S/n). ``attend`` takes ``attention.decode``'s place (and its
    arguments) after each attention layer's cache write, where the cache
    is whole: the serve engine's CUDA graph ends a piece there
    (``serve/decode_graph.py``). ``held_count`` (an int64 device scalar)
    gains the (token, k) assignments that the MoE layers' held experts
    kept, on the device. Returns (logits (B,1,V) or (B,1,C,V), cache)."""
    x = embed_tokens(cfg, params, tokens)
    pos = torch.as_tensor(pos, device=x.device)
    positions = pos[None] if pos.dim() == 0 else pos[:, None]
    for slot, g, p in _layers(cfg, params):
        c = {name: t[g] for name, t in cache[slot].items()}
        x, _ = apply_layer(cfg, slot, p, x, positions=positions, impl=impl,
                           cache=c, pos=pos, cp_axis=cp_axis, mesh=mesh,
                           capacity_factor=None, attend=attend, held_count=held_count)
    x = rmsnorm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return logits_for(cfg, params, x), cache


def prefill(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor,
            max_len: int, *, frontend_embeds: Optional[torch.Tensor] = None,
            impl: str = "auto", cache_dtype: torch.dtype = torch.bfloat16,
            length: Optional[int] = None, held_count: Optional[torch.Tensor] = None):
    """Run the whole prompt (after ``frontend_embeds``, where given) and
    build a cache for decode; MoE layers dispatch losslessly. Returns
    (logits (B,1,V) or (B,1,C,V), cache, next_pos).

    ``length`` supports right-padded prompts (the serving engine's
    power-of-two buckets): logits come from the token at ``length - 1``
    and ``next_pos`` is ``length``. Causal attention keeps the pad tail
    out of the real tokens, and decode masks cache rows ``>= pos``, so
    the pad K/V are never read. SSM state runs through every position,
    so a config with SSM layers takes exact-length prompts only.

    An SSM layer keeps the final state and the conv inputs for decode;
    where JAX runs ``ssd_chunked`` (``model.py:437``), the card runs the
    CUDA ``ssd_scan`` kernel, which returns the final state too.
    ``held_count`` as in ``decode_step``."""
    x = embed_tokens(cfg, params, tokens, frontend_embeds)
    b, s, _ = x.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    kinds = [slot_kind(cfg, slot) for slot in range(layer_period(cfg))]
    if length is not None and int(length) != s and \
            any(k["kind"] != "attn" for k in kinds):
        raise ValueError(f"{cfg.name}: SSM layers need an exact-length prompt, "
                         f"got length {length} of {s} tokens")
    positions = torch.arange(s, device=x.device)
    cache = init_cache(cfg, b, max_len, cache_dtype, x.device)
    for slot, g, p in _layers(cfg, params):
        kind, c = kinds[slot], cache[slot]
        h = rmsnorm(x, p["norm1"]["scale"], cfg.norm_eps)
        if kind["kind"] == "attn":
            q, k, v = _project_qkv(cfg, p["attn"], h, positions)
            window = cfg.window_size if kind["local"] else None
            out = attn_mod.attention(q, k, v, causal=True, window=window,
                                     softcap=cfg.attn_logit_softcap, impl=impl,
                                     scale=option(cfg, "attention_multiplier"))
            x = x + _branch(cfg, _out_proj(p["attn"], out, x.dtype))
            c["k"][g, :, :s] = k
            c["v"][g, :, :s] = v
        else:
            x_in, z, b_in, c_in, dt_raw, A = _ssm_inputs(cfg, p["ssm"], h)
            y, hfin, (st_x, st_b, st_c) = _ssm_sequence(
                cfg, p["ssm"], x_in, b_in, c_in, dt_raw, A, impl=impl)
            x = x + _branch(cfg, _ssm_out(cfg, p["ssm"], y, z, x.dtype))
            c["h"][g] = hfin
            c["conv_x"][g] = st_x
            c["conv_b"][g] = st_b
            c["conv_c"][g] = st_c
        x, _ = _ffn(cfg, kind, p, x, None, held_count=held_count)
    x = rmsnorm(x, params["final_norm"]["scale"], cfg.norm_eps)
    npos = s if length is None else int(length)
    return logits_for(cfg, params, x[:, npos - 1:npos]), cache, npos
