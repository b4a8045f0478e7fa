"""granite-4.0-h-small's pieces in the port, at a tiny size on the CPU,
against the benchmark's plain reference (``portbench/reference/hybrid.py``)
on the same seeded weights (``portbench/weights.py``).

- the port-only config: ``get_config`` resolves it, ``list_archs`` stays
  the JAX package's ten; its layer pattern; ``param_count`` is what
  ``params.py`` builds, at the tiny size and at the published one with
  18 of 72 experts held (on the ``meta`` device);
- prefill logits, and prefill then decode through the cache, against
  the reference's full forward;
- each of the four multipliers, NoPE, the conv bias and the shared
  expert: the same comparison fails when the piece is left out of the
  program;
- the shares of the experts: the MoE's outputs of every share of
  ``experts_held`` experts, and the shared expert once, add up to the
  reference's uncut layer;
- ``held_count``: the assignments the held experts kept, counted on the
  device through prefill and decode.

The program computes its products, its residual stream and the conv in
bf16 and the reference in f32, so their logits agree to bf16's rounding:
rel 6e-2. Over seeds 0-9 the program reads 0.015-0.042, the reference
with bf16 operands and a bf16 stream 0.008-0.031, the reference in fp8
0.13-0.39, and each piece left out 0.15 or more. A routing decision
near a tie can fall the other way under that rounding and move a
token's layer output by a whole expert, so the comparisons route the
reference as the program routed (``_Pinned``): what is compared is the
arithmetic, not the tie-breaking.
"""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))   # the benchmark's package

from portbench import weights  # noqa: E402
from portbench.harness import program_config  # noqa: E402
from portbench.reference import common, hybrid  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs.port import HybridMoEConfig  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import activation_fn  # noqa: E402
from repro_torch.models.params import abstract_params, init_params, param_count_tree  # noqa: E402

#: two periods of four layers (attention at slot 2), 3 of 8 experts held,
#: top-2, a shared expert, and every multiplier away from 1; the
#: attention multiplier is 1/hd, as the published 0.0078125 is 1/128
TINY = {"family": "hybrid", "num_layers": 8, "d_model": 64, "num_heads": 4,
        "num_kv_heads": 2, "head_dim": 16, "d_ff": 32, "vocab_size": 128,
        "num_experts": 8, "num_experts_per_tok": 2, "experts_held": 3, "moe_period": 1,
        "attn_period": 4, "ssm_state": 16, "ssm_expand": 2, "ssm_head_dim": 16,
        "ssm_conv": 4, "ssm_chunk": 16, "norm_eps": 1e-5, "tie_embeddings": True,
        "shared_d_ff": 48, "embedding_multiplier": 12.0, "residual_multiplier": 0.22,
        "attention_multiplier": 0.0625, "logits_scaling": 16.0, "rope": False,
        "ssm_conv_bias": True, "mlp_activation": "silu", "dtype": "bfloat16"}
REL = 6e-2
SEEDS = [0, 1, 2]


def _cfg(model=TINY):
    return program_config({"registry": "granite-4.0-h-small", "model": model})


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def _tokens(seed: int, n: int = 37) -> torch.Tensor:
    return torch.randint(0, TINY["vocab_size"], (n,), generator=torch.Generator().manual_seed(seed))


class _Pinned:
    """The program's top-k choices, recorded call by call (one call an
    MoE layer and forward), then replayed as the reference's routing, its
    weights a softmax over the reference's own logits of those experts."""

    def __init__(self, monkeypatch):
        self.calls = []
        self.mp = monkeypatch
        orig = moe.router_topk

        def record(x2d, w_router, k):
            out = orig(x2d, w_router, k)
            self.calls.append(out[1])
            return out
        monkeypatch.setattr(moe, "router_topk", record)

    def replay(self, layers: int):
        """Replay to the reference, whose each layer's call sees the
        tokens of all the program's calls of that layer, in call order."""
        per_layer = [torch.cat(self.calls[i::layers]) for i in range(layers)]
        it = iter(per_layer)

        def route(logits, k):
            idx = next(it)
            return torch.softmax(logits.gather(-1, idx), dim=-1), idx
        self.mp.setattr(hybrid, "route", route)


def _prefill_rel(cfg, params, seed, monkeypatch, ref_params=None) -> float:
    """The last prompt row's logits, the program's (on ``params``) against
    the reference's (on ``ref_params``, else the same)."""
    pin = _Pinned(monkeypatch)
    toks = _tokens(seed)
    with torch.no_grad():
        prog, _, _ = M.prefill(cfg, params, toks[None], 64)
    pin.replay(TINY["num_layers"])
    ref = hybrid.logits_rows(TINY, params if ref_params is None else ref_params, toks,
                             [len(toks) - 1])
    return _rel(prog[0, -1], ref[0])


# ----------------------------------------------------------------------
# the config
# ----------------------------------------------------------------------

def test_port_only_arch():
    cfg = get_config("granite-4.0-h-small")
    assert isinstance(cfg, HybridMoEConfig) and cfg.name not in list_archs()
    assert len(list_archs()) == 10
    assert [i for i in range(cfg.num_layers) if cfg.is_attention_layer(i)] == [5, 15, 25, 35]
    assert all(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    assert (cfg.experts_held, cfg.rope, cfg.ssm_heads, cfg.shared_d_ff) == (0, False, 128, 1536)


@pytest.mark.parametrize("held", [0, 18])
def test_param_count_is_what_params_builds(held):
    cfg = dataclasses.replace(get_config("granite-4.0-h-small"), experts_held=held)
    tree, _ = abstract_params(cfg)
    assert param_count_tree(tree) == cfg.param_count()
    if held == 18:                      # the benchmark's share: 11.82B
        assert round(cfg.param_count() / 1e9, 2) == 11.82
    tiny = _cfg()
    params = init_params(tiny, torch.Generator().manual_seed(0), "cpu")
    assert param_count_tree(params) == tiny.param_count() == \
        param_count_tree(weights.make(TINY, 0, "cpu"))


# ----------------------------------------------------------------------
# against the reference
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_prefill_logits_match_the_reference(seed, monkeypatch):
    cfg, params = _cfg(), weights.make(TINY, seed, "cpu")
    rel = _prefill_rel(cfg, params, seed, monkeypatch)
    print(f"[hybrid] seed {seed}: prefill logits rel {rel:.4f}")
    assert rel < REL


@pytest.mark.parametrize("seed", SEEDS)
def test_prefill_then_decode_match_the_full_forward(seed, monkeypatch):
    """30 tokens prefilled, then 7 decode steps through the cache, each
    step's logits against the reference's full forward at that row."""
    cfg, params = _cfg(), weights.make(TINY, seed, "cpu")
    toks = _tokens(seed)
    pin = _Pinned(monkeypatch)
    steps = []
    with torch.no_grad():
        logits, cache, pos = M.prefill(cfg, params, toks[None, :30], 64)
        steps.append(logits[0, -1])
        for t in range(30, len(toks) - 1):
            logits, cache = M.decode_step(cfg, params, toks[None, t:t + 1], cache,
                                          torch.tensor([t], dtype=torch.int32))
            steps.append(logits[0, -1])
    pin.replay(TINY["num_layers"])
    ref = hybrid.logits_rows(TINY, params, toks[:-1], range(29, len(toks) - 1))
    rels = [_rel(s, r) for s, r in zip(steps, ref)]
    print(f"[hybrid] seed {seed}: prefill + decode logits rel, largest {max(rels):.4f}")
    assert max(rels) < REL


def _no_conv_bias(params):
    return {**params, "layers": tuple(
        {k: ({n: t for n, t in v.items() if not (n.startswith("conv_") and n.endswith("_bias"))}
             if k == "ssm" else v) for k, v in slot.items()} for slot in params["layers"])}


def _no_shared(params):
    return {**params, "layers": tuple({k: v for k, v in slot.items() if k != "shared"}
                                      for slot in params["layers"])}


#: each piece left out of the program: (config, params) -> (config, params)
DROPPED = {
    "embedding_multiplier": lambda c, p: (dataclasses.replace(c, embedding_multiplier=1.0), p),
    "residual_multiplier": lambda c, p: (dataclasses.replace(c, residual_multiplier=1.0), p),
    "attention_multiplier": lambda c, p: (dataclasses.replace(c, attention_multiplier=None), p),
    "logits_scaling": lambda c, p: (dataclasses.replace(c, logits_scaling=1.0), p),
    "nope": lambda c, p: (dataclasses.replace(c, rope=True), p),
    "conv_bias": lambda c, p: (c, _no_conv_bias(p)),
    "shared_expert": lambda c, p: (c, _no_shared(p)),
}


def _attention_rel(cfg, params) -> float:
    """The first attention layer's mixer on a normed stream of 37 rows,
    program against reference."""
    slot = TINY["attn_period"] // 2
    x = torch.randn(37, TINY["d_model"], generator=torch.Generator().manual_seed(5))
    h = common.rmsnorm(x, params["layers"][slot]["norm1"]["scale"][0], TINY["norm_eps"])
    p = M._group(params["layers"][slot], 0)["attn"]
    kind = {"local": False}
    with torch.no_grad():
        prog = M._attention_mixer(cfg, kind, p, h[None].to(torch.bfloat16),
                                  positions=torch.arange(37), impl="ref")
    return _rel(prog[0], hybrid.attention(TINY, params["layers"][slot]["attn"], 0, h))


@pytest.mark.parametrize("piece", list(DROPPED))
def test_a_dropped_piece_fails_the_comparison(piece, monkeypatch):
    """The comparison that passes above fails with the piece left out.
    The attention's pieces (its multiplier, NoPE) are held on the
    attention layer's output, where they act whole; the others on the
    logits."""
    cfg, params = _cfg(), weights.make(TINY, 0, "cpu")
    dcfg, dparams = DROPPED[piece](cfg, params)
    if piece in ("attention_multiplier", "nope"):
        sound, dropped = _attention_rel(cfg, params), _attention_rel(dcfg, dparams)
    else:
        sound = _prefill_rel(cfg, params, 0, monkeypatch)
        monkeypatch.undo()
        dropped = _prefill_rel(dcfg, dparams, 0, monkeypatch, ref_params=params)
    print(f"[hybrid] {piece}: rel {sound:.4f} with it, {dropped:.4f} without")
    assert sound < REL < dropped


def test_expert_shares_add_up_to_the_uncut_layer():
    """Every share of 3 experts of 8 (the last share 2), each computed as
    the program computes its held experts, plus the shared expert once:
    the reference's MoE and shared expert over all 8 experts."""
    uncut = dict(TINY, experts_held=0)
    params = weights.make(uncut, 4, "cpu")
    p = {k: v[0] for k, v in params["layers"][0]["moe"].items()}
    x = torch.randn(1, 29, TINY["d_model"], generator=torch.Generator().manual_seed(6))
    e, n = TINY["num_experts"], TINY["experts_held"]
    total = torch.zeros(29, TINY["d_model"])
    for lo in range(0, e, n):
        # the program holds experts [0, n): the share [lo, lo + n) is that
        # layer with the router's columns turned by lo (routing does not
        # depend on the experts' order)
        share = {"router": p["router"].roll(-lo, dims=1),
                 "w_in": p["w_in"][lo:lo + n], "w_out": p["w_out"][lo:lo + n]}
        y, metrics = moe.moe_ffn(x, share, num_experts=e, top_k=TINY["num_experts_per_tok"],
                                 activation=activation_fn("silu"), capacity_factor=None)
        assert float(metrics.dropped_frac) == 0.0      # lossless over the held experts
        total += y[0].float()
    shared = params["layers"][0]["shared"]
    from repro_torch.models.layers import mlp
    total += mlp(x, {k: v[0] for k, v in shared.items()}, activation_fn("silu"))[0].float()
    want = hybrid.moe(uncut, params["layers"][0]["moe"], 0, x[0]) + hybrid.swiglu(
        x[0], shared["w_in"][0], shared["w_out"][0])
    assert _rel(total, want) < REL


def test_held_count_counts_the_kept_assignments(monkeypatch):
    """Through a prefill and a decode step: the (token, k) assignments to
    experts [0, experts_held), on the device, the same as the routing
    the program took."""
    cfg, params = _cfg(), weights.make(TINY, 1, "cpu")
    pin = _Pinned(monkeypatch)
    toks = _tokens(1)
    held = torch.zeros((), dtype=torch.int64)
    with torch.no_grad():
        _, cache, pos = M.prefill(cfg, params, toks[None, :20], 32, held_count=held)
        M.decode_step(cfg, params, toks[None, 20:21], cache,
                      torch.tensor([pos], dtype=torch.int32), held_count=held)
    assert len(pin.calls) == 2 * TINY["num_layers"]
    want = sum(int((idx < TINY["experts_held"]).sum()) for idx in pin.calls)
    assert int(held) == want > 0


def _chip_smoke():
    """``chip_smoke.py`` as a module (its ``moe_prefill_metrics``)."""
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["granite-4.0-h-small", "granite-moe-1b-a400m",
                                  "moonshot-v1-16b-a3b"])
def test_prefill_keeps_the_moe_metrics(arch):
    """``chip_smoke.py``'s zoo phase records every MoE layer's metrics in
    a prefill and holds the lossless dispatch to ``dropped_frac`` 0: the
    prefill computes them (only a decode step leaves them out), for held
    experts too."""
    if arch == "granite-4.0-h-small":
        cfg, params = _cfg(), weights.make(TINY, 1, "cpu")
    else:
        cfg = get_config(arch).reduced()
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = _tokens(2, 29).tolist()
    with torch.no_grad():
        seen = _chip_smoke().moe_prefill_metrics(torch, "cpu", cfg, params, prompt)
    assert len(seen) == sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers)) > 0
    assert all(m is not None and float(m.dropped_frac) == 0.0 for m in seen)
    assert all(float(m.expert_load.sum()) == pytest.approx(1.0) for m in seen)
