"""A tiny hybrid cell (Mamba2 and NoPE attention over held experts and a
shared expert, ``reference/hybrid.py``) run whole through the harness
on the CPU, as ``test_portbench_cells.py`` runs the dense and SSM ones:
the comparison passes on the program as it is and fails with a piece
of the layer taken out of the program underneath; the traced run reads
``mfu.serve.hybrid``, which finds nothing to read in the other
families."""
import json

import pytest

from portbench import tiny

#: ``tests/test_torch_hybrid.py``'s tiny model: two periods of four
#: layers, 3 of 8 experts held, top-2, every multiplier away from 1
HYBRID = {"family": "hybrid", "num_layers": 8, "d_model": 64, "num_heads": 4,
          "num_kv_heads": 2, "head_dim": 16, "d_ff": 32, "vocab_size": 128,
          "num_experts": 8, "num_experts_per_tok": 2, "experts_held": 3, "moe_period": 1,
          "attn_period": 4, "ssm_state": 16, "ssm_expand": 2, "ssm_head_dim": 16,
          "ssm_conv": 4, "ssm_chunk": 16, "norm_eps": 1e-5, "tie_embeddings": True,
          "shared_d_ff": 48, "embedding_multiplier": 12.0, "residual_multiplier": 0.22,
          "attention_multiplier": 0.0625, "logits_scaling": 16.0, "rope": False,
          "ssm_conv_bias": True, "mlp_activation": "silu", "dtype": "bfloat16"}
CELL = "tiny-hybrid.serve"
#: the tiny hybrid's limit, from CPU readings: the logits are divided by
#: 16 (``logits_scaling``) and the table drawn 12 times narrower, so its
#: gaps are smaller than the other tiny cells'. The program's widest gap
#: reads 2e-5-5.1e-4 over 12 seeds, a stale SSM state 3.4e-3-4.2e-3
#: over 6, the shared expert left out 3.0e-3-3.8e-3 over 4
LIMITS = {"logit_gap": 0.0015}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("portbench"))
    tiny.write(root / "configs" / "tiny-hybrid.json",
               {"name": "tiny-hybrid", "registry": "granite-4.0-h-small", "reduced": [],
                "model": HYBRID})
    tiny.write(root / "limits" / f"{CELL}.json", {"limits": LIMITS})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": "tiny-hybrid", "traffic": "tiny.serve",
                               "chips": 1, "why": "test"})
    tiny.write(root / "BENCHMARK.json", bench)
    return root


def test_sound_hybrid_run_is_correct_and_reads_its_mfu(root):
    out = tiny.run(root, CELL, trace=True)
    assert out["correct"], out["checks"]
    assert out["numbers"]["tokens"] > 0
    assert 0 < out["metrics"]["mfu.serve.hybrid"]["value"] < 100


def test_other_families_read_no_hybrid_mfu(root):
    out = tiny.run(root, "tiny-dense.serve", trace=True)
    assert "mfu.serve" in out["metrics"] and "mfu.serve.hybrid" not in out["metrics"]


def _no_shared_expert(monkeypatch):
    from repro_torch.models import model as M
    orig = M._ffn

    def ffn(cfg, kind, p, x, capacity_factor, **kw):
        return orig(cfg, kind, {k: v for k, v in p.items() if k != "shared"}, x,
                    capacity_factor, **kw)
    monkeypatch.setattr(M, "_ffn", ffn)


def _stale_ssm_state(monkeypatch):
    from repro_torch.models import model as M
    orig = M._ssm_step

    def step(cfg, p, x_in, b_in, c_in, dt_raw, A, cache):
        return orig(cfg, p, x_in, b_in, c_in, dt_raw, A,
                    {k: v.clone() for k, v in cache.items()})
    monkeypatch.setattr(M, "_ssm_step", step)


@pytest.mark.parametrize("fault", [_no_shared_expert, _stale_ssm_state],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_planted_fault_in_the_hybrid_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    out = tiny.run(root, CELL)
    assert not out["correct"], out["checks"]
    assert out["numbers"]["tokens"] > 0
