"""Config system: model / shape / mesh / run configs, a copy of the JAX
package's ``configs/base.py`` (the port never imports the JAX package).

Every assigned architecture gets one module in this package exporting
``CONFIG: ModelConfig``. ``repro_torch.configs.registry`` resolves ``--arch``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. Covers dense / MoE / SSM / hybrid /
    VLM-backbone / audio-backbone families with one schema."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    vocab_size: int

    # ---- attention ----
    num_heads: int = 0               # 0 => attention-free (pure SSM)
    num_kv_heads: int = 0
    head_dim: int = 0
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0       # partial rotary (GLM-4 uses 0.5)
    window_size: Optional[int] = None        # sliding-window width (local layers)
    local_global_period: int = 0     # gemma2: 2 => alternate local/global
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    qk_norm: bool = False

    # ---- MLP ----
    d_ff: int = 0
    mlp_activation: str = "silu"     # silu (SwiGLU) | gelu (GeGLU)

    # ---- MoE ----
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_period: int = 1              # apply MoE every k-th layer (jamba: 2)
    router_aux_loss: float = 0.01

    # ---- SSM (Mamba2 / SSD) ----
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # ---- hybrid (jamba) ----
    attn_period: int = 0             # attention every k-th layer (jamba: 8)

    # ---- modality frontend stub ----
    frontend: Optional[str] = None   # "vision" | "audio"
    frontend_tokens: int = 256       # prefix embeddings provided by the stub
    num_codebooks: int = 1           # musicgen: 4 EnCodec codebooks

    # ---- misc ----
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma: multiply embeddings by sqrt(D)
    source: str = ""                 # provenance tag from the assignment

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def is_attention_layer(self, layer_idx: int) -> bool:
        if self.family == "ssm":
            return False
        if self.family == "hybrid" and self.attn_period:
            # jamba: one attention layer per attn_period block, at the
            # middle slot of each period (per the released config).
            return layer_idx % self.attn_period == self.attn_period // 2
        return True

    def is_moe_layer(self, layer_idx: int) -> bool:
        if not self.num_experts:
            return False
        return (layer_idx % self.moe_period) == (self.moe_period - 1)

    def layer_kind(self, layer_idx: int) -> str:
        """'attn' | 'ssm' for the mixer of layer i."""
        return "attn" if self.is_attention_layer(layer_idx) else "ssm"

    def is_local_layer(self, layer_idx: int) -> bool:
        """Sliding-window (local) attention layer? gemma2 alternates
        local/global with period 2 starting from local."""
        if not self.local_global_period or self.window_size is None:
            return False
        return layer_idx % self.local_global_period == 0

    def param_count(self) -> int:
        """Total parameters (analytic, matches init exactly)."""
        return sum(int(x) for x in _param_tree_sizes(self).values())

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k of experts)."""
        total = 0
        for name, n in _param_tree_sizes(self).items():
            if ".moe." in name and "router" not in name:
                total += int(n * self.num_experts_per_tok / self.num_experts)
            else:
                total += int(n)
        return total

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            num_layers=max(2, min(4, self.attn_period or 2) * (2 if self.family == "hybrid" else 1)),
            d_model=64,
            vocab_size=128,
            d_ff=128 if self.d_ff else 0,
            head_dim=16 if self.num_heads else 0,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            num_experts=4 if self.num_experts else 0,
            num_experts_per_tok=min(2, self.num_experts_per_tok) if self.num_experts else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=16,
            window_size=16 if self.window_size else None,
            frontend_tokens=8 if self.frontend else 256,
            attn_period=min(self.attn_period, 4) if self.attn_period else 0,
            name=self.name + "-reduced",
        )
        if self.family == "hybrid":
            small["num_layers"] = 2 * (small["attn_period"] or 2)
        small.update(overrides)
        return dataclasses.replace(self, **small)


def _param_tree_sizes(cfg: ModelConfig) -> dict:
    """Analytic per-tensor parameter counts; mirrors models/params.py init."""
    sizes: dict = {}
    sizes["embed.table"] = cfg.vocab_size * cfg.d_model * cfg.num_codebooks
    if not cfg.tie_embeddings:
        sizes["lm_head"] = cfg.vocab_size * cfg.d_model * cfg.num_codebooks
    for i in range(cfg.num_layers):
        p = f"layer{i}"
        if cfg.is_attention_layer(i):
            sizes[f"{p}.attn.wq"] = cfg.d_model * cfg.q_dim
            sizes[f"{p}.attn.wk"] = cfg.d_model * cfg.kv_dim
            sizes[f"{p}.attn.wv"] = cfg.d_model * cfg.kv_dim
            sizes[f"{p}.attn.wo"] = cfg.q_dim * cfg.d_model
        elif cfg.ssm_state:
            d_in = cfg.d_inner
            H = cfg.ssm_heads
            sizes[f"{p}.ssm.in_proj"] = cfg.d_model * (2 * d_in + 2 * cfg.ssm_state + H)
            sizes[f"{p}.ssm.conv"] = cfg.ssm_conv * (d_in + 2 * cfg.ssm_state)
            sizes[f"{p}.ssm.A_log"] = H
            sizes[f"{p}.ssm.D"] = H
            sizes[f"{p}.ssm.dt_bias"] = H
            sizes[f"{p}.ssm.out_proj"] = d_in * cfg.d_model
            sizes[f"{p}.ssm.norm"] = d_in
        has_ffn = False
        if cfg.is_moe_layer(i):
            sizes[f"{p}.moe.router"] = cfg.d_model * cfg.num_experts
            sizes[f"{p}.moe.w_in"] = cfg.num_experts * cfg.d_model * cfg.d_ff * 2
            sizes[f"{p}.moe.w_out"] = cfg.num_experts * cfg.d_ff * cfg.d_model
            has_ffn = True
        elif cfg.d_ff:
            sizes[f"{p}.mlp.w_in"] = cfg.d_model * cfg.d_ff * 2
            sizes[f"{p}.mlp.w_out"] = cfg.d_ff * cfg.d_model
            has_ffn = True
        sizes[f"{p}.norms"] = (2 if has_ffn else 1) * cfg.d_model
    sizes["final_norm"] = cfg.d_model
    return sizes


# ----------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

#: archs allowed to run long_500k (sub-quadratic sequence mixing)
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Is this (arch, shape) cell runnable? Returns (ok, reason)."""
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, "long_500k requires sub-quadratic mixing (SSM/hybrid); " \
                      f"{cfg.name} is pure full-attention"
    return True, ""


# ----------------------------------------------------------------------
@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))


@dataclass(frozen=True)
class RunConfig:
    """Trainer/serving hyper-parameters independent of architecture."""
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatch: int = 0              # 0 => no microbatching
    remat_policy: str = "minimal"    # none | minimal | full
    # --- paper-derived knobs (the planner sets these) ---
    grad_bucket_mb: int = 64         # doorbell-batching analogue
    pod_sync: str = "auto"           # auto (XLA SPMD) | compressed (int8 ring)
    moments_int8: bool = False       # blockwise-int8 AdamW moments
    collective_chunk_mb: int = 0     # 0 => unchunked (Advice #2/#3 analogue)
    ckpt_every: int = 0              # steps between checkpoints (0 = off)
    ckpt_dir: str = ""
    ckpt_replicas: int = 0           # chain-replication targets (LineFS)
    ckpt_compress: bool = True
    seed: int = 0
