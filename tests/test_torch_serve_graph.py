"""The serve engine's decode step as CUDA graphs (``serve/decode_graph.py``).

On the CPU:

- ``decode_step(..., attend=attention.decode)`` gives the logits and the
  cache of ``decode_step`` without it, bit for bit, and calls ``attend``
  once for each attention layer (the graph's split point);
- the rule (``decode_graph.applies``): a CUDA device, ``impl="auto"``,
  and for a config with MoE layers the local dispatch (no mesh); an
  engine it leaves out has no ``decode_graph_replays`` in its ``stats``
  (which stay the JAX engine's) and its ``serve.decode`` spans say
  ``graphed=False``;
- K2's ``out=`` takes only a buffer of q's shape, the cache dtype and q's
  device, and is written in place.

On a card (``-m gpu``): the engine graphed and eager side by side, on
reduced internlm2, reduced mamba2 and a reduced granite-4.0-h-small
(Mamba2 and NoPE attention layers over 6 held of 16 experts and a
shared expert), 8 slots, requests admitted and retired mid-run over
more than 40 decode steps, prompts long enough for K2's split merge:
the same greedy tokens, the same logits, every decode step a replay, K2
launched once an attention layer a step, as eager, and its counters
left 0; for the MoE config also the same MoE counters, the host's rows
as the buffers' shapes make them.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as k2_ops
from repro_torch.kernels.decode_attention.ops import decode_attention_kernel
from repro_torch.models import attention as attn_mod
from repro_torch.models import model as M
from repro_torch.models.params import init_params, layer_period, num_groups, slot_kind
from repro_torch.obs.host import HostTracer
from repro_torch.serve import decode_graph
from repro_torch.serve.engine import Request, ServeEngine


def _params(cfg, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return init_params(cfg, gen, device)


def _attn_layers(cfg) -> int:
    return num_groups(cfg) * sum(slot_kind(cfg, s)["kind"] == "attn"
                                 for s in range(layer_period(cfg)))


# ----------------------------------------------------------------------
# the split point
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["internlm2-1.8b", "jamba-1.5-large-398b"])
def test_attend_is_decode(arch):
    """The hook in ``decode`` 's place changes nothing, on a dense and on
    a hybrid (attention, SSM and MoE layers) config."""
    cfg = get_config(arch).reduced()
    params = _params(cfg, "cpu")
    gen = torch.Generator()
    gen.manual_seed(1)
    cache = M.init_cache(cfg, 3, 16, torch.float32, "cpu")
    for c in cache:
        for t in c.values():
            t.copy_(torch.randn(t.shape, generator=gen) * 0.5)
    tokens = torch.randint(0, cfg.vocab_size, (3, 1), generator=gen)
    pos = torch.tensor([0, 5, 15], dtype=torch.int32)
    calls = []

    def attend(*a, **kw):
        calls.append(1)
        return attn_mod.decode(*a, **kw)

    c0 = tuple({k: t.clone() for k, t in c.items()} for c in cache)
    c1 = tuple({k: t.clone() for k, t in c.items()} for c in cache)
    with torch.no_grad():
        l0, _ = M.decode_step(cfg, params, tokens, c0, pos)
        l1, _ = M.decode_step(cfg, params, tokens, c1, pos, attend=attend)
    assert torch.equal(l0, l1)
    for a, b in zip(c0, c1):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert len(calls) == _attn_layers(cfg) > 0


# ----------------------------------------------------------------------
# the rule
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch,device,impl,want", [
    ("internlm2-1.8b", "cuda", "auto", True),
    ("mamba2-2.7b", "cuda", "auto", True),
    ("internlm2-1.8b", "cpu", "auto", False),
    ("internlm2-1.8b", "cuda", "ref", False),
    ("internlm2-1.8b", "cuda", "blocked", False),
    ("granite-moe-1b-a400m", "cuda", "auto", True),
    ("jamba-1.5-large-398b", "cuda", "auto", True),
])
def test_rule(arch, device, impl, want):
    cfg = get_config(arch).reduced()
    assert decode_graph.applies(cfg, torch.device(device), impl) is want


@pytest.mark.parametrize("arch,want", [("internlm2-1.8b", True), ("mamba2-2.7b", True),
                                       ("granite-moe-1b-a400m", False),
                                       ("granite-4.0-h-small", False)])
def test_rule_under_a_mesh(arch, want, monkeypatch):
    """Under a mesh an MoE layer may take the expert-parallel dispatch,
    whose collectives no graph holds: left eager. The other configs'
    rule does not look at the mesh."""
    monkeypatch.setattr(decode_graph, "current_mesh", lambda: object())
    assert decode_graph.applies(get_config(arch), torch.device("cuda"), "auto") is want
    monkeypatch.undo()
    assert decode_graph.applies(get_config(arch), torch.device("cuda"), "auto") is True


@pytest.mark.parametrize("arch,impl", [("internlm2-1.8b", "auto"), ("internlm2-1.8b", "ref"),
                                       ("granite-moe-1b-a400m", "auto")])
def test_engine_left_eager(arch, impl):
    """The CPU and ``impl="ref"``: no replay, no key (nor the MoE
    counters, which an engine keeps on the card only)."""
    cfg = get_config(arch).reduced()
    tracer = HostTracer()
    eng = ServeEngine(cfg, _params(cfg, "cpu"), slots=2, max_len=32, impl=impl,
                      device="cpu", host_tracer=tracer)
    rng = np.random.default_rng(0)
    for i in range(3):
        eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 6).astype(np.int32),
                           max_new_tokens=3))
    eng.run()
    assert eng.stats["decode_steps"] > 0
    assert eng.stats.get("decode_graph_replays", 0) == 0
    assert "decode_graph_replays" not in eng.stats
    assert "moe_rows_computed" not in eng.stats and "moe_assignments_held" not in eng.stats
    spans = [s for s in tracer.spans if s.name == "serve.decode"]
    assert len(spans) == eng.stats["decode_steps"]
    assert all(s.meta["graphed"] is False and s.meta["pieces"] == 0 for s in spans)


# ----------------------------------------------------------------------
# K2's out=
# ----------------------------------------------------------------------

def _k2_inputs():
    gen = torch.Generator()
    gen.manual_seed(2)
    q = torch.randn((2, 1, 4, 16), generator=gen)
    k, v = (torch.randn((2, 8, 2, 16), generator=gen) for _ in range(2))
    return q, k, v, torch.tensor([3, 8])


@pytest.mark.parametrize("bad", ["shape", "dtype", "device"])
def test_k2_out_refuses_wrong_buffer(bad):
    q, k, v, clen = _k2_inputs()
    out = {"shape": torch.empty((2, 1, 4, 8)),
           "dtype": torch.empty(q.shape, dtype=torch.bfloat16),
           "device": torch.empty(q.shape, device="meta")}[bad]
    with pytest.raises(ValueError, match="out must be"):
        decode_attention_kernel(q, k, v, clen, out=out)


def test_k2_out_written_in_place():
    q, k, v, clen = _k2_inputs()
    out = torch.full(q.shape, float("nan"))
    got = decode_attention_kernel(q, k, v, clen, window=4, out=out)
    assert got is out
    assert torch.equal(out, decode_attention_kernel(q, k, v, clen, window=4))


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

# (submitted before step, prompt length, new tokens): more requests than
# slots, arriving while others decode and retire. A 2048-row cache at 8
# slots is 4 splits of 512 rows in K2 (``split_rows``), so the prompts
# past 512 tokens take its split merge, through the scratch and counters
SCHEDULE = [(0, 7, 30), (0, 900, 6), (0, 12, 44), (0, 1300, 9), (2, 33, 12), (3, 640, 25),
            (5, 26, 4), (5, 1100, 18), (8, 40, 10), (11, 700, 28), (14, 21, 7), (17, 1500, 22),
            (21, 17, 15), (26, 800, 9), (30, 29, 12)]


def _serve(cfg, params, graphed: bool, monkeypatch):
    """Run SCHEDULE; returns (tokens per request, per-step (rows, logits),
    engine, K2 launches, serve.decode spans). K2's counters are made anew
    by the run's first launch, as in a fresh process, and must be 0 after
    it (every launch leaves them 0)."""
    with monkeypatch.context() as mp:
        if not graphed:
            mp.setattr(decode_graph, "applies", lambda *a: False)
        tracer = HostTracer()
        eng = ServeEngine(cfg, params, slots=8, max_len=2048, device="cuda",
                          host_tracer=tracer)
    k2_ops._counter_cache.clear()
    steps = []
    compute = eng._decode_compute

    def recorded(act):
        logits = compute(act)
        steps.append((list(act), logits[act].float().cpu()))
        return logits

    eng._decode_compute = recorded
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=m) for i, (_, n, m) in enumerate(SCHEDULE)]
    k2 = decode_attention_kernel.launches
    step = 0
    while step < 1000:
        for r, (at, _, _) in zip(reqs, SCHEDULE):
            if at == step:
                eng.submit(r)
        if step > SCHEDULE[-1][0] and not eng.queue and not any(eng.active):
            break
        eng.step()
        step += 1
    torch.cuda.synchronize()
    assert all(int(c.abs().sum()) == 0 for c in k2_ops._counter_cache.values())
    spans = [s for s in tracer.spans if s.name == "serve.decode"]
    return ([r.out_tokens for r in reqs], steps, eng,
            decode_attention_kernel.launches - k2, spans)


def _hybrid_moe():
    """granite-4.0-h-small cut to two periods of four layers at small
    widths, its pieces kept: NoPE attention with 4 q heads to a kv head
    and the published score scale, Mamba2 with the conv bias (K3's
    tensor-core shapes: P 64, N 64), 6 held of 16 experts top-4 beside a
    shared expert, the four multipliers."""
    return dataclasses.replace(
        get_config("granite-4.0-h-small"), name="granite-4.0-h-small-reduced",
        num_layers=8, attn_period=4, d_model=256, num_heads=4, num_kv_heads=1, head_dim=64,
        d_ff=128, num_experts=16, num_experts_per_tok=4, experts_held=6, ssm_state=64,
        ssm_head_dim=64, vocab_size=512, shared_d_ff=256)


def _config(arch):
    return _hybrid_moe() if arch == "granite-4.0-h-small" else get_config(arch).reduced()


def test_hybrid_moe_config_is_graphed_on_the_card():
    cfg = _hybrid_moe()
    assert decode_graph.applies(cfg, torch.device("cuda"), "auto")
    assert _attn_layers(cfg) == 2 and cfg.experts_held == 6


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-2.7b", "granite-4.0-h-small"])
def test_graphed_matches_eager_on_card(arch, monkeypatch):
    """Run with ``-m gpu`` on a machine with a card and nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    cfg = _config(arch)
    params = _params(cfg, torch.device("cuda"))
    t_g, s_g, e_g, k2_g, sp_g = _serve(cfg, params, True, monkeypatch)
    t_e, s_e, e_e, k2_e, sp_e = _serve(cfg, params, False, monkeypatch)
    n = e_g.stats["decode_steps"]
    assert n >= 40 and e_e.stats["decode_steps"] == n
    assert t_g == t_e
    assert all(len(t) == m for t, (_, _, m) in zip(t_g, SCHEDULE))
    assert [a for a, _ in s_g] == [a for a, _ in s_e]
    gap = max((lg - le).abs().max().item() for (_, lg), (_, le) in zip(s_g, s_e))
    print(f"[graph] {arch}: {n} decode steps, largest logit gap graphed - eager {gap}")
    # the same kernels on the same inputs in the same order: equal to the bit
    assert gap == 0.0
    assert e_g.stats["decode_graph_replays"] == n
    assert "decode_graph_replays" not in e_e.stats
    layers = _attn_layers(cfg)
    assert k2_g == k2_e == layers * n
    assert all(s.meta["graphed"] and s.meta["pieces"] == layers + 1 for s in sp_g)
    assert all(not s.meta["graphed"] for s in sp_e)
    if arch == "granite-4.0-h-small":
        moe_layers, held = cfg.num_layers, cfg.experts_held
        prompts = sum(n for _, n, _ in SCHEDULE)
        for e in (e_g, e_e):
            assert e.stats["moe_rows_computed"] == moe_layers * held * (prompts + 8 * n)
        assert e_g.stats["moe_assignments_held"] == e_e.stats["moe_assignments_held"] > 0
        print(f"[graph] {arch}: MoE rows computed {e_g.stats['moe_rows_computed']}, "
              f"assignments held {e_g.stats['moe_assignments_held']}")
        assert all(s.meta["moe_layers"] == moe_layers and s.meta["moe_rows"] == moe_layers * held * 8
                   for s in sp_g)
