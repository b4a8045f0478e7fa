"""The port's reduced internlm2 and mamba2 against the JAX model, from
bridged params.

The JAX params are made with ``jax.random`` and handed to the port as
numpy; tokens and caches are made with numpy from a seed. Model outputs
are compared at rel < 4e-2 of their largest magnitude, the tolerance of
``tests/test_models.py``: bf16 products round at different places in
the two frameworks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.params import init_params as jax_init_params
from repro_torch.bridge import cache_from_numpy, params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.params import compute_copy, init_params

REL = 4e-2


@pytest.fixture(scope="module")
def lm():
    cfg = get_config("internlm2-1.8b").reduced()
    jcfg = jax_get_config("internlm2-1.8b").reduced()
    jparams = jax.jit(lambda k: jax_init_params(jcfg, k)[0])(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jcfg, jparams, tparams


def _rel(j, t):
    j = np.asarray(jnp.asarray(j, jnp.float32))
    t = t.float().numpy()
    return float(np.abs(j - t).max()) / (float(np.abs(j).max()) + 1e-9)


def _check(what, err, tol):
    """Hold an error to its tolerance and print it (``-s`` shows the
    parity table that PERF.md quotes)."""
    print(f"[parity] {what}: err {err:.3g} (tol {tol})")
    assert err < tol


def test_bridge_keeps_layout(lm):
    cfg, _, jparams, tparams = lm
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(tparams["layers"]) == 1
    attn = tparams["layers"][0]["attn"]
    assert attn["wq"].shape == (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.head_dim)
    assert tparams["layers"][0]["mlp"]["w_in"].shape == (cfg.num_layers, cfg.d_model, 2, cfg.d_ff)
    np.testing.assert_array_equal(attn["wo"].numpy(),
                                  np.asarray(jparams["layers"][0]["attn"]["wo"]))
    assert sum(int(np.prod(x.shape)) for _, x in jflat) == \
        sum(t.numel() for t in jax.tree.leaves(tparams))


def test_forward_hidden(lm):
    cfg, jcfg, jparams, tparams = lm
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    ref = JM.forward(jcfg, jparams, jnp.asarray(tokens), impl="ref", remat="none").hidden
    out = TM.forward(cfg, tparams, torch.from_numpy(tokens)).hidden
    assert out.dtype == torch.bfloat16 and out.shape == (2, 24, cfg.d_model)
    _check("forward hidden, rel", _rel(ref, out), REL)


@pytest.mark.parametrize("impl", ["pallas", "ref"])
def test_prefill_bucketed(lm, impl):
    """A prompt of 11 tokens right-padded to the 16 bucket (``length=``)."""
    cfg, jcfg, jparams, tparams = lm
    n, bucket, max_len = 11, 16, 32
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :n] = np.random.default_rng(1).integers(0, cfg.vocab_size, n)
    jl, jcache, jpos = JM.prefill(jcfg, jparams, jnp.asarray(tokens), max_len,
                                  impl=impl, cache_dtype=jnp.float32,
                                  length=jnp.asarray(n, jnp.int32))
    tl, tcache, tpos = TM.prefill(cfg, tparams, torch.from_numpy(tokens), max_len,
                                  cache_dtype=torch.float32, length=n)
    assert tpos == int(jpos) == n
    assert tl.shape == (1, 1, cfg.vocab_size)
    _check(f"prefill logits vs impl={impl}, rel", _rel(jl, tl), REL)
    for js, ts in zip(jcache, tcache):
        for name in ("k", "v"):
            assert ts[name].shape == js[name].shape
            _check(f"prefill cache {name} vs impl={impl}, rel",
                   _rel(js[name][:, :, :n], ts[name][:, :, :n]), REL)


@pytest.mark.parametrize("pos", [13, (5, 30, 0), (31, 32, 4)],
                         ids=["scalar", "per_row", "per_row_past_end"])
def test_decode_step(lm, pos):
    cfg, jcfg, jparams, tparams = lm
    b, max_len = (2 if isinstance(pos, int) else len(pos)), 32
    rng = np.random.default_rng(2)
    jcache, _ = JM.init_cache(jcfg, b, max_len, jnp.float32)
    cache_np = jax.tree.map(
        lambda x: (rng.standard_normal(x.shape) * 0.5).astype(np.float32), jcache)
    tokens = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    pos_np = np.asarray(pos, np.int32)
    jl, jnew = JM.decode_step(jcfg, jparams, jnp.asarray(tokens),
                              jax.tree.map(jnp.asarray, cache_np), jnp.asarray(pos_np))
    tcache = cache_from_numpy(cache_np, device="cpu")
    tl, tnew = TM.decode_step(cfg, tparams, torch.from_numpy(tokens), tcache,
                              torch.from_numpy(pos_np))
    assert tnew is tcache                       # written in place
    assert tl.shape == (b, 1, cfg.vocab_size)
    _check(f"decode_step logits pos={pos}, rel", _rel(jl, tl), REL)
    for js, ts in zip(jnew, tnew):
        for name in ("k", "v"):
            _check(f"decode_step cache {name} pos={pos}, rel", _rel(js[name], ts[name]), REL)


def test_rmsnorm_rope_mlp_f32():
    """The layer primitives at f32 inputs: 1e-5 for rmsnorm and rope. The
    MLP rounds to bf16 inside (as in JAX), so it is held to one bf16 step
    of its output's magnitude."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    out = TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)).numpy()
    ref = np.asarray(JL.rmsnorm(jnp.asarray(x), jnp.asarray(scale)))
    _check("rmsnorm f32, max abs", float(np.abs(out - ref).max()), 1e-5)
    for positions in (np.arange(8), rng.integers(0, 500, (2, 8))):
        for frac in (1.0, 0.5):
            out = TL.rope(torch.from_numpy(x), torch.from_numpy(positions), 1e6, frac).numpy()
            ref = np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(positions), 1e6, frac))
            _check(f"rope f32 positions {positions.shape} fraction {frac}, max abs",
                   float(np.abs(out - ref).max()), 1e-5)
    h = rng.standard_normal((2, 8, 32)).astype(np.float32)
    p = {"w_in": (rng.standard_normal((32, 2, 64)) / 6).astype(np.float32),
         "w_out": (rng.standard_normal((64, 32)) / 8).astype(np.float32)}
    ref = np.asarray(JL.mlp(jnp.asarray(h), jax.tree.map(jnp.asarray, p),
                            JL.activation_fn("silu")))
    out = TL.mlp(torch.from_numpy(h), {k: torch.from_numpy(v) for k, v in p.items()},
                 TL.activation_fn("silu")).numpy()
    _check("mlp (bf16 inside), max abs / max |ref|",
           float(np.abs(out - ref).max() / np.abs(ref).max()), 2 ** -7 + 1e-9)


# ----------------------------------------------------------------------
# reduced mamba2-2.7b: attention-free SSM layers
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def ssm_lm():
    cfg = get_config("mamba2-2.7b").reduced()
    jcfg = jax_get_config("mamba2-2.7b").reduced()
    jparams = jax.jit(lambda k: jax_init_params(jcfg, k)[0])(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jcfg, jparams, tparams


def test_ssm_params_layout_and_init(ssm_lm):
    """The port's own init draws the JAX distributions in the JAX layout;
    ``compute_copy`` keeps A_log, D, dt_bias and norm in f32."""
    cfg, _, jparams, tparams = ssm_lm
    jssm = jparams["layers"][0]["ssm"]
    own = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tssm = own["layers"][0]["ssm"]
    assert set(tssm) == set(jssm)
    for name, leaf in jssm.items():
        assert tuple(tssm[name].shape) == leaf.shape, name
    assert sum(t.numel() for t in jax.tree.leaves(own)) == cfg.param_count()
    a = torch.exp(tssm["A_log"])
    assert bool(((a >= 1) & (a <= 16)).all())
    dt = torch.nn.functional.softplus(tssm["dt_bias"])
    assert bool(((dt >= 1e-3 * (1 - 1e-5)) & (dt <= 0.1 * (1 + 1e-5))).all())
    assert bool((tssm["D"] == 1).all() and (tssm["norm"] == 1).all())
    for name, fan_in in (("conv_x", cfg.ssm_conv), ("w_xz", cfg.d_model),
                         ("out", cfg.d_inner)):
        std = float(tssm[name].std())
        assert abs(std * fan_in ** 0.5 - 1) < 0.2, (name, std)
    copy = compute_copy(own)["layers"][0]["ssm"]
    assert {n for n, t in copy.items() if t.dtype == torch.float32} == \
        {"A_log", "D", "dt_bias", "norm"}


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_ssm_forward_hidden(ssm_lm, impl):
    """S = 32, a multiple of the reduced chunk (16), so JAX's
    ``impl="pallas"`` runs the Pallas SSD kernel (interpret mode)."""
    cfg, jcfg, jparams, tparams = ssm_lm
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    ref = JM.forward(jcfg, jparams, jnp.asarray(tokens), impl=impl, remat="none").hidden
    out = TM.forward(cfg, tparams, torch.from_numpy(tokens)).hidden
    assert out.dtype == torch.bfloat16 and out.shape == (2, 32, cfg.d_model)
    _check(f"mamba2 forward hidden vs impl={impl}, rel", _rel(ref, out), REL)


@pytest.mark.parametrize("s", [21, 32, 2])
def test_ssm_prefill(ssm_lm, s):
    """Exact-length prompts (ragged, a chunk multiple, shorter than the
    conv): logits, the final state h and the conv states."""
    cfg, jcfg, jparams, tparams = ssm_lm
    max_len = 64
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    jl, jcache, jpos = JM.prefill(jcfg, jparams, jnp.asarray(tokens), max_len,
                                  impl="ref", cache_dtype=jnp.float32)
    tl, tcache, tpos = TM.prefill(cfg, tparams, torch.from_numpy(tokens), max_len,
                                  cache_dtype=torch.float32)
    assert tpos == int(jpos) == s
    _check(f"mamba2 prefill S={s} logits, rel", _rel(jl, tl), REL)
    for js, ts in zip(jcache, tcache):
        assert set(ts) == {"h", "conv_x", "conv_b", "conv_c"} == set(js)
        for name in ts:
            assert ts[name].shape == js[name].shape and ts[name].dtype == torch.float32
            _check(f"mamba2 prefill S={s} cache {name}, rel", _rel(js[name], ts[name]), REL)
    with pytest.raises(ValueError, match="exact-length"):
        TM.prefill(cfg, tparams, torch.from_numpy(tokens), max_len, length=s - 1)


@pytest.mark.parametrize("pos", [13, (5, 30, 0)], ids=["scalar", "per_row"])
def test_ssm_decode_step(ssm_lm, pos):
    """One token against random states: logits and every new state, the
    states written in place in every row (JAX advances idle rows too)."""
    cfg, jcfg, jparams, tparams = ssm_lm
    b, max_len = (2 if isinstance(pos, int) else len(pos)), 32
    rng = np.random.default_rng(6)
    jcache, _ = JM.init_cache(jcfg, b, max_len, jnp.float32)
    cache_np = jax.tree.map(
        lambda x: (rng.standard_normal(x.shape) * 0.5).astype(np.float32), jcache)
    tokens = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    pos_np = np.asarray(pos, np.int32)
    jl, jnew = JM.decode_step(jcfg, jparams, jnp.asarray(tokens),
                              jax.tree.map(jnp.asarray, cache_np), jnp.asarray(pos_np))
    tcache = cache_from_numpy(cache_np, device="cpu")
    tl, tnew = TM.decode_step(cfg, tparams, torch.from_numpy(tokens), tcache,
                              torch.from_numpy(pos_np))
    assert tnew is tcache                       # written in place
    _check(f"mamba2 decode_step logits pos={pos}, rel", _rel(jl, tl), REL)
    for js, ts, old in zip(jnew, tnew, cache_np):
        for name in ("h", "conv_x", "conv_b", "conv_c"):
            assert not np.array_equal(ts[name].numpy(), old[name])
            _check(f"mamba2 decode_step state {name} pos={pos}, rel",
                   _rel(js[name], ts[name]), REL)
