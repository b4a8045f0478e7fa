"""Whole runs of tiny cells on the CPU through the harness: the
comparison passes on the program as it is and fails on each fault a
cell can have, planted in the program underneath; the controls read
further off than the program; a cell, configuration, traffic mix and
per-layer metric added as new files are found by name."""
import json

import pytest

from portbench import spec, tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("portbench"))


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_sound_runs_are_correct(root, cell):
    out = tiny.run(root, cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"] for m in spec.end_to_end(spec.load_benchmark(root / "BENCHMARK.json"),
                                               cell)}
    assert "setup_s" in out["metrics"] and set(out["metrics"]) <= want


def test_traced_run_reports_per_layer_metrics(root):
    out = tiny.run(root, "tiny-dense.serve", trace=True)
    assert {"engine.decode_step_ms", "engine.prefill_ms"} <= set(out["metrics"])
    assert not set(out["metrics"]) & {"serve_tokens_per_s", "setup_s"}
    assert "window_s" in out["device"] and "breakdown" in out


@pytest.mark.parametrize("cell", ["tiny-dense.serve", "tiny-ssm.serve"])
def test_fp8_control_reads_further_off_than_the_program(root, cell):
    """The control in the program's place, judged by the cell's limits
    file through the harness's own comparison, is not correct."""
    out = tiny.run(root, cell, controls=["fp8"])
    assert out["correct"]
    fp8 = out["controls"]["fp8"]
    assert fp8["correct"] is False, fp8
    assert fp8["checks"]["logit_gap"]["value"] > out["checks"]["logit_gap"]["value"]
    assert fp8["checks"]["logit_gap"]["limit"] == tiny.LIMITS["serve"]["logit_gap"]


def test_train_controls_fail_a_limit(root):
    out = tiny.run(root, "tiny-dense.train", controls=["fp8", "half_batch"])
    assert out["correct"]
    for c in ("fp8", "half_batch"):
        assert out["controls"][c]["correct"] is False, (c, out["controls"][c])
        assert set(out["controls"][c]["checks"]) == set(tiny.LIMITS["train"])


def _altered_token(monkeypatch):
    from repro_torch.serve import engine as E
    orig = E._EngineCore._finish_decode

    def finish(self, act, logits):
        out = orig(self, act, logits)
        req = next((r for r in (self.active[s] for s in act) if r is not None), None)
        if req is not None and len(req.out_tokens) == 3:
            req.out_tokens[-1] = (req.out_tokens[-1] + 1) % self.cfg.vocab_size
        return out
    monkeypatch.setattr(E._EngineCore, "_finish_decode", finish)


def _stale_cache(monkeypatch):
    from repro_torch.models import model as M
    monkeypatch.setattr(M, "_write_cache", lambda cache, k, v, pos: None)


def _stale_ssm_state(monkeypatch):
    from repro_torch.models import model as M
    orig = M._ssm_step

    def step(cfg, p, x_in, b_in, c_in, dt_raw, A, cache):
        return orig(cfg, p, x_in, b_in, c_in, dt_raw, A,
                    {k: v.clone() for k, v in cache.items()})
    monkeypatch.setattr(M, "_ssm_step", step)


def _unchanged_state(monkeypatch):
    import repro_torch.train.train_step as TS
    monkeypatch.setattr(TS, "adamw_update",
                        lambda grads, state, params, **kw: (params, state, {"grad_norm": 0.0}))


def _half_batch(monkeypatch):
    import repro_torch.train.train_step as TS
    orig = TS._split_microbatches
    monkeypatch.setattr(TS, "_split_microbatches", lambda b, k: [orig(b, k)[0]] * k)


@pytest.mark.parametrize("cell,fault", [
    ("tiny-dense.serve", _altered_token), ("tiny-dense.serve", _stale_cache),
    ("tiny-ssm.serve", _altered_token), ("tiny-ssm.serve", _stale_ssm_state),
    ("tiny-dense.train", _unchanged_state), ("tiny-dense.train", _half_batch),
], ids=lambda x: x if isinstance(x, str) else x.__name__.strip("_"))
def test_a_planted_fault_is_not_correct(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = tiny.run(root, cell)
    assert not out["correct"], out["checks"]
    if cell.endswith(".serve"):                       # judged on served tokens, not none
        assert out["numbers"]["tokens"] > 0


def test_a_window_that_finishes_nothing_is_not_correct():
    from portbench import check
    out = check.serve(tiny.DENSE, {}, [], "cpu")
    assert out["tokens"] == 0 and out["logit_gap"] is None
    assert not check.passed(check.judge(out, tiny.LIMITS["serve"]))


def test_new_files_are_found_by_name(tmp_path):
    root = tiny.make_root(tmp_path)
    tiny.write(root / "configs" / "tiny-wide.json",
               {"name": "tiny-wide", "registry": "internlm2-1.8b", "reduced": [],
                "model": dict(tiny.DENSE, d_ff=192)})
    tiny.write(root / "traffic" / "tiny.burst.json", dict(tiny.SERVE, clients=6))
    tiny.write(root / "limits" / "tiny-wide.burst.json", {"limits": tiny.LIMITS["serve"]})
    (root / "metrics" / "requests_done.py").write_text(
        "def read(run):\n    return sum('out' in r for r in run['reqs'].values())\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny-wide.burst", "config": "tiny-wide",
                               "traffic": "tiny.burst", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "requests_done", "unit": "requests", "better": "higher",
                               "source": "host_clock", "layer": "engine",
                               "moves": "serve_tokens_per_s", "workloads": ["tiny-wide.burst"]})
    tiny.write(root / "BENCHMARK.json", bench)
    out = tiny.run(root, "tiny-wide.burst", trace=True)
    assert out["correct"]
    assert out["metrics"]["requests_done"]["value"] > 0
    assert spec.config("tiny-wide", root)["model"]["d_ff"] == 192
