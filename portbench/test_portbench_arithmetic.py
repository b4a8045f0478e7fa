"""The benchmark's arithmetic against hand counts: percentiles over all
samples, rates over the whole window, kernel and model counts from
shapes, and the stratified length draws."""
import math

import numpy as np
import pytest

from portbench import flops, stats, traffic


def test_percentile_is_linear_between_ranks_over_all_samples():
    xs = list(range(1, 101))                      # 1..100
    assert stats.percentile(xs, 90) == pytest.approx(90.1)
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([], 50) is None
    rng = np.random.default_rng(0)
    ys = rng.normal(size=1001).tolist()
    for q in (50, 90, 95, 99):
        assert stats.percentile(ys, q) == pytest.approx(float(np.percentile(ys, q)))


def _serve_run():
    # two requests; the window is [10, 20]
    return {"kind": "serve", "t0": 10.0, "t1": 20.0,
            "reqs": {0: {"sent": 9.0, "times": [9.5, 10.5, 11.5]},      # first token before
                     1: {"sent": 12.0, "times": [12.25, 13.0, 21.0]}}}  # last token after


def test_serve_samples_are_those_of_the_window():
    run = _serve_run()
    assert stats.ttfts(run) == [0.25]                       # request 1 only
    assert sorted(stats.itls(run)) == [0.75, 1.0, 1.0]      # gaps ending in the window
    assert len(stats.token_times(run)) == 4
    from portbench import spec
    rate = spec.reader("serve_tokens_per_s")(run)
    assert rate == pytest.approx(4 / 10.0)


def test_train_rate_is_over_the_steps_wall_time():
    run = {"kind": "train", "steps": [(1.0, 3.0), (3.0, 5.5), (5.5, 8.0)],
           "tokens_per_step": 1000, "flops_per_step": 989e12}
    from portbench import spec
    assert spec.reader("train_tokens_per_s")(run) == pytest.approx(3000 / 7.0)
    assert spec.reader("mfu.train")(run) == pytest.approx(100 * 3 / 7.0)


def test_k1_counts_the_causal_pairs():
    f, nb, pk = flops.k1(2, 8, 4, 2, 16, 2)
    assert f == 4 * 2 * 4 * 16 * 36                  # 36 = 8 * 9 / 2 visible pairs
    assert nb == 2 * 2 * 8 * 16 * (4 + 4 + 2 + 2)     # q, o (4 heads), k, v (2 heads)
    assert pk == flops.PEAK_BF16


def test_k2_reads_each_cache_up_to_its_fill():
    f, nb, pk = flops.k2(3, 4, 2, 16, [1, 5, 10], q_elsize=2, cache_elsize=4)
    assert f == 4 * 4 * 16 * 16
    assert nb == 2 * 4 * 2 * 16 * 16 + 2 * 3 * 4 * 16 + 4 * 3 * 4 * 16
    assert pk == flops.PEAK_F32                       # f32 cache operands


def test_k3_and_k4_counts():
    f, nb, pk = flops.k3(1, 64, 2, 8, 4, 2, 2)
    assert f == 4 * 64 * 2 * 8 * 4
    assert nb == 2 * 64 * 16 + 4 * 64 * 2 + 4 * 2 + 2 * 2 * 64 * 4 + 4 * 64 * 16 + 4 * 2 * 8 * 4
    assert flops.k4_quantize(512)[1] == 4 * 512 + 512 + 4 * 2
    assert flops.k4_dequantize(300)[1] == 300 + 4 * 2 + 4 * 300
    t, term = flops.bound_s(989e12, 1.0, flops.PEAK_BF16)
    assert (t, term) == (pytest.approx(1.0), "operations")
    t, term = flops.bound_s(1.0, 3.35e12, flops.PEAK_BF16)
    assert (t, term) == (pytest.approx(1.0), "bytes")


def test_model_flops_by_hand():
    m = {"family": "dense", "num_layers": 2, "d_model": 8, "num_heads": 2, "num_kv_heads": 1,
         "head_dim": 4, "d_ff": 16, "vocab_size": 10}
    per_layer = 8 * 4 * (2 * 2 + 2 * 1) + 3 * 8 * 16
    assert flops.layer_matmul_params(m) == per_layer
    att = 2 * 4 * 2 * 4 * (1 + 2 + 3)                 # layers, 4·hd, heads, pairs of 3 tokens
    assert flops.prefill_flops(m, 3) == 2 * per_layer * 2 * 3 + 2 * 80 + att
    assert flops.decode_flops(m, [5]) == 2 * (per_layer * 2 + 80) + 2 * 4 * 2 * 4 * 5
    assert flops.train_step_flops(m, 1, 3) == 3 * (2 * (per_layer * 2 + 80) * 3 + att)


def test_internlm2_train_step_flops():
    m = {"family": "dense", "num_layers": 24, "d_model": 2048, "num_heads": 16,
         "num_kv_heads": 8, "head_dim": 128, "d_ff": 8192, "vocab_size": 92544}
    # 6 x 1.70e9 matrix params x 32768 tokens plus causal attention
    assert flops.train_step_flops(m, 8, 4096) == pytest.approx(3.738e14, rel=1e-3)


@pytest.mark.parametrize("law", [
    {"law": "uniform", "lo": 128, "hi": 480},
    {"law": "loguniform", "lo": 256, "hi": 1536},
    {"law": "lognormal", "median": 300, "sigma": 0.6, "lo": 8, "hi": 4096},
])
def test_every_seed_draws_the_same_lengths(law):
    a = traffic.lengths(law, 500, traffic.rng(1))
    b = traffic.lengths(law, 500, traffic.rng(2 ** 31 + 5))
    assert sorted(a) == sorted(b) and list(a) != list(b)
    assert min(a) >= law["lo"] and max(a) <= law["hi"]
    if law["law"] == "loguniform":
        mid = math.exp((math.log(law["lo"]) + math.log(law["hi"])) / 2)
        assert np.median(a) == pytest.approx(mid, rel=0.02)
