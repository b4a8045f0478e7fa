"""The whole model zoo: every arch of the registry, reduced
(``cfg.reduced()``), in the port against the JAX package on the CPU.

The JAX params are made with ``jax.random`` and bridged to the port
(``bridge.params_from_numpy``); tokens, frontend embeddings, hidden
states and labels are made with numpy from a seed. Tolerances, stated
per test: model outputs and grads rel 4e-2 of their largest magnitude
or by norm (``tests/test_models.py:59``: bf16 products round at other
places in the two frameworks), the f32 CE on the same bf16 hidden
states rel 1e-5 (as ``tests/test_torch_train.py``), the loss of a
train step rel 1e-3; bridged leaves, served tokens and routing metrics
that count exactly equal."""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.configs.base import RunConfig as JRunConfig
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.models.params import init_params as jax_init_params
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.train import train_step as JT
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import RunConfig, get_config, list_archs
from repro_torch.configs.registry import all_configs
from repro_torch.models import model as TM
from repro_torch.models.params import check_supported, init_params
from repro_torch.optim import adamw as TO
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import train_step as TT

REL = 4e-2


def _chip_smoke():
    """``chip_smoke.py`` as a module (its ``PinnedRouting``)."""
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ARCHS = jax_list_archs()
#: tests/test_models.py:62-65's train archs that this slice adds, and
#: reduced mamba2-2.7b, the pure SSM model (its Mamba grads alone)
TRAIN_ARCHS = ["granite-moe-1b-a400m", "musicgen-large", "gemma2-9b", "jamba-1.5-large-398b",
               "mamba2-2.7b"]
ENGINE_ARCHS = ["musicgen-large", "granite-moe-1b-a400m", "gemma2-9b"]


def _check(what, err, tol):
    """Hold an error to its tolerance and print it (``-s`` shows the
    parity table)."""
    print(f"[parity] {what}: err {err:.3g} (tol {tol})")
    assert err < tol


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(j, t):
    j, t = _np(j), _np(t)
    return float(np.abs(j - t).max()) / (float(np.abs(j).max()) + 1e-9)


def _rel_norm(j, t):
    j, t = _np(j), _np(t)
    return float(np.linalg.norm(j - t) / (np.linalg.norm(j) + 1e-30))


@pytest.fixture(scope="module")
def lms():
    """Reduced (cfg, JAX cfg, JAX params, bridged params) per arch, built
    once per module on first use."""
    built = {}

    def get(arch):
        if arch not in built:
            cfg = get_config(arch).reduced()
            jcfg = jax_get_config(arch).reduced()
            jparams = jax.jit(lambda k: jax_init_params(jcfg, k)[0])(jax.random.PRNGKey(0))
            tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
            built[arch] = cfg, jcfg, jparams, tparams
        return built[arch]
    return get


def _tokens(cfg, rng, b, s):
    shape = (b, s, cfg.num_codebooks) if cfg.num_codebooks > 1 else (b, s)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


def _frontend(cfg, rng, b):
    if not cfg.frontend:
        return None
    return (rng.standard_normal((b, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def test_registry_is_the_jax_registry():
    """The ten archs in the JAX order, each config field for field the
    JAX package's, and every one runnable (``check_supported``)."""
    assert list_archs() == ARCHS and len(ARCHS) == 10
    for arch, cfg in all_configs().items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_config(arch)), arch
        check_supported(cfg)
        check_supported(cfg.reduced())


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_and_init_keep_every_leaf(lms, arch):
    """MoE slots (router, w_in (E,D,2,F), w_out (E,F,D)), codebook tables
    (C,V,D) and every other leaf cross the bridge unchanged, bit for bit;
    the port's own ``init_params`` gives the same tree, shapes and dtypes."""
    cfg, _, jparams, tparams = lms(arch)
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tflat = jax.tree_util.tree_flatten_with_path(tparams)[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (path, j), (_, t) in zip(jflat, tflat):
        assert t.shape == j.shape and t.dtype == torch.float32, path
        assert np.array_equal(np.asarray(j), t.numpy()), path
    own = jax.tree_util.tree_flatten_with_path(init_params(cfg, torch.Generator(), "cpu"))[0]
    assert [(p, tuple(t.shape)) for p, t in own] == [(p, tuple(t.shape)) for p, t in tflat]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_vs_jax(lms, arch):
    """``forward`` (capacity 1.25, frontend embeddings in front) against
    JAX's ``impl="ref"`` forward: hidden rel 4e-2; the MoE load-balance
    loss rel 4e-2 (its router reads the bf16 hidden stream), 0 without
    MoE."""
    cfg, jcfg, jparams, tparams = lms(arch)
    rng = np.random.default_rng(0)
    tokens, fe = _tokens(cfg, rng, 2, 24), _frontend(cfg, rng, 2)
    ref = JM.forward(jcfg, jparams, jnp.asarray(tokens), _j(fe), impl="ref", remat="none")
    out = TM.forward(cfg, tparams, torch.from_numpy(tokens), _t(fe))
    assert out.hidden.shape == ref.hidden.shape and out.hidden.dtype == torch.bfloat16
    _check(f"{arch} forward hidden, rel", _rel(ref.hidden, out.hidden), REL)
    if cfg.num_experts:
        _check(f"{arch} forward aux_loss, rel",
               abs(float(ref.aux_loss) - out.aux_loss.item()) / float(ref.aux_loss), REL)
    else:
        assert float(ref.aux_loss) == out.aux_loss.item() == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_entropy_vs_jax(lms, arch):
    """Chunked CE with z-loss on the same bf16 hidden states through the
    arch's own head (tied or not, (C,V,D) codebook tables, final
    softcap), labels (B,S[,C]) with the frontend positions masked out as
    the token pipeline masks them: rel 1e-5."""
    cfg, jcfg, jparams, tparams = lms(arch)
    rng = np.random.default_rng(1)
    b, s = 2, 32
    ft = cfg.frontend_tokens if cfg.frontend else 0
    hidden = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    labels = _tokens(cfg, rng, b, s)
    mask = (rng.random((b, s)) < 0.8).astype(np.float32)
    mask[:, :ft] = 0.0
    ref = JM.cross_entropy(jcfg, jparams, jnp.asarray(hidden, jnp.bfloat16),
                           jnp.asarray(labels), jnp.asarray(mask), chunk=16)
    out = TM.cross_entropy(cfg, tparams, torch.from_numpy(hidden).to(torch.bfloat16),
                           torch.from_numpy(labels), torch.from_numpy(mask), chunk=16)
    _check(f"{arch} cross_entropy (frontend {ft}, codebooks {cfg.num_codebooks}), rel",
           abs(float(ref) - out.item()) / abs(float(ref)), 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_vs_jax(lms, arch):
    """Prefill of 23 tokens (after the frontend's) and one decode step,
    as ``tests/test_models.py:44``: the prefill and decode logits against
    JAX's ``prefill`` and ``decode_step`` on the same cache, and the
    decode logits against the port's own lossless forward over all 24
    tokens, each rel 4e-2; logits (B,1,V), or (B,1,C,V) for codebooks."""
    cfg, jcfg, jparams, tparams = lms(arch)
    rng = np.random.default_rng(2)
    b, s, maxlen = 2, 24, 32
    tokens, fe = _tokens(cfg, rng, b, s), _frontend(cfg, rng, b)
    total = maxlen + (cfg.frontend_tokens if cfg.frontend else 0)
    jl, jcache, jpos = JM.prefill(jcfg, jparams, jnp.asarray(tokens[:, :s - 1]), total,
                                  frontend_embeds=_j(fe), impl="ref", cache_dtype=jnp.float32)
    jstep, _ = JM.decode_step(jcfg, jparams, jnp.asarray(tokens[:, s - 1:s]), jcache, jpos,
                              impl="ref")
    tl, tcache, tpos = TM.prefill(cfg, tparams, torch.from_numpy(tokens[:, :s - 1]), total,
                                  frontend_embeds=_t(fe), cache_dtype=torch.float32)
    assert tpos == int(jpos)
    tstep, _ = TM.decode_step(cfg, tparams, torch.from_numpy(tokens[:, s - 1:s]), tcache,
                              tpos)
    assert tl.shape == jl.shape and tstep.shape == jstep.shape
    _check(f"{arch} prefill logits vs JAX, rel", _rel(jl, tl), REL)
    _check(f"{arch} decode_step logits vs JAX, rel", _rel(jstep, tstep), REL)
    hidden = TM.forward(cfg, tparams, torch.from_numpy(tokens), _t(fe),
                        capacity_factor=None).hidden
    full = TM.logits_for(cfg, tparams, hidden[:, -1:])
    _check(f"{arch} decode_step logits vs the port's forward, rel", _rel(full, tstep), REL)


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_engine_tokens_equal_jax_engine(lms, arch):
    """One ``ServeEngine`` pass (2 slots, bucketed prefill, continuous
    batching) against the JAX engine on the same requests: the same
    retirement order, stats and tokens, token for token. For musicgen
    the (S, C) prompts of the JAX launcher and JAX's codebook quirk: the
    prefill keeps codebook 0 of its token, the first decode step feeds it
    to every codebook, later tokens are lists of C."""
    cfg, jcfg, jparams, tparams = lms(arch)
    rng = np.random.default_rng(3)
    spec = [(8, 4), (13, 3), (5, 5)]
    prompts = [_tokens(cfg, rng, 1, n)[0] for n, _ in spec]
    jeng = JaxServeEngine(jcfg, jparams, slots=2, max_len=64, impl="ref")
    teng = ServeEngine(cfg, tparams, slots=2, max_len=64, device="cpu")
    jreqs, treqs = [], []
    for i, (p, (_, new)) in enumerate(zip(prompts, spec)):
        jreqs.append(JaxRequest(rid=i, prompt=p, max_new_tokens=new))
        treqs.append(Request(rid=i, prompt=p, max_new_tokens=new))
        jeng.submit(jreqs[-1])
        teng.submit(treqs[-1])
    jdone, tdone = jeng.run(), teng.run()
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert teng.stats == jeng.stats
    for jr, tr in zip(jreqs, treqs):
        print(f"[parity] {arch} engine rid {jr.rid}: {tr.out_tokens}")
        assert tr.out_tokens == jr.out_tokens
        if cfg.num_codebooks > 1:
            assert isinstance(tr.out_tokens[0], int)
            assert all(len(t) == cfg.num_codebooks for t in tr.out_tokens[1:])


def _train_batch(cfg, b, s, seed):
    """A masked batch of ``s`` positions in all, the frontend's first:
    the token pipeline's layout (labels padded and masked over them)."""
    rng = np.random.default_rng(seed)
    ft = cfg.frontend_tokens if cfg.frontend else 0
    tokens = _tokens(cfg, rng, b, s - ft)
    labels = _tokens(cfg, rng, b, s - ft)
    mask = (rng.random((b, s - ft)) < 0.8).astype(np.float32)
    batch = {"tokens": tokens, "labels": labels, "loss_mask": mask}
    if ft:
        batch["frontend_embeds"] = _frontend(cfg, rng, b)
        batch["labels"] = np.concatenate(
            [np.zeros((b, ft) + labels.shape[2:], labels.dtype), labels], axis=1)
        batch["loss_mask"] = np.concatenate([np.zeros((b, ft), np.float32), mask], axis=1)
    return batch


def _jax_grads_and_noise(jcfg, jparams, jb):
    """JAX's ``loss_fn`` grads, and its own bf16 noise: the worst leaf's
    move (rel by norm) of those grads when the f32 masters are rounded to
    bf16."""
    jgrad_fn = jax.jit(jax.value_and_grad(
        lambda p, bt: JT.loss_fn(jcfg, p, bt, impl="ref", remat="none"), has_aux=True))
    _, jgrads = jgrad_fn(jparams, jb)
    _, jnoisy = jgrad_fn(jax.tree.map(lambda x: x.astype(jnp.bfloat16).astype(jnp.float32),
                                      jparams), jb)
    return jgrads, max(_rel_norm(j, n) for j, n in zip(jax.tree.leaves(jgrads),
                                                       jax.tree.leaves(jnoisy)))


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_vs_jax(lms, arch):
    """One train step (step 1, f32 moments) of 2 x 32 positions against
    JAX's ``make_train_step`` (``impl="ref"``, jitted): loss rel 1e-3,
    the CE part rel 1e-3 and the MoE aux part rel 4e-2, the grad norm rel
    4e-2; and ``loss_fn``'s grads against ``jax.value_and_grad``'s, by
    norm per leaf, the worst leaf within rel 4e-2 or within twice the JAX
    model's own bf16 noise, whichever is larger. That noise is the worst
    leaf's move of JAX's grads when its f32 masters are rounded to bf16
    (a perturbation of the size the two frameworks' bf16 roundings
    make). It is 0.013-0.021 for granite-moe, musicgen and gemma2, so
    they are held to 4e-2; reduced jamba (8 hybrid layers, f32 routers
    over top-2 of 4 experts) is chaotic, 0.21, and is held to twice that."""
    cfg, jcfg, jparams, tparams = lms(arch)
    batch = _train_batch(cfg, 2, 32, seed=4)
    jrun = JRunConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    run = RunConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    jb = jax.tree.map(jnp.asarray, batch)
    _, _, jm = jax.jit(JT.make_train_step(jcfg, jrun, impl="ref"))(
        jparams, jax_adamw_init(jparams), jb, jnp.asarray(1))
    own = jax.tree.map(lambda t: t.clone(), tparams)            # updated in place
    _, _, tm = TT.make_train_step(cfg, run)(own, TO.adamw_init(own), {
        k: torch.from_numpy(v) for k, v in batch.items()}, 1)
    _check(f"{arch} train step loss, rel", abs(float(jm["loss"]) - float(tm["loss"]))
           / float(jm["loss"]), 1e-3)
    _check(f"{arch} train step ce, rel", abs(float(jm["ce"]) - float(tm["ce"]))
           / float(jm["ce"]), 1e-3)
    if cfg.num_experts:
        _check(f"{arch} train step aux, rel", abs(float(jm["aux"]) - float(tm["aux"]))
               / float(jm["aux"]), REL)
    _check(f"{arch} train step grad_norm, rel", abs(float(jm["grad_norm"])
           - float(tm["grad_norm"])) / float(jm["grad_norm"]), REL)
    jgrads, floor = _jax_grads_and_noise(jcfg, jparams, jb)
    leaves = [p.clone().requires_grad_() for p in TO.tree_leaves(tparams)]
    loss, _ = TT.loss_fn(cfg, TO.tree_unflatten(tparams, leaves),
                         {k: torch.from_numpy(v) for k, v in batch.items()}, remat="none")
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    jl = jax.tree.leaves(jgrads)
    assert len(jl) == len(grads)
    worst = max(_rel_norm(j, t) for j, t in zip(jl, grads))
    _check(f"{arch} loss_fn grads, worst leaf rel by norm (JAX's own bf16 noise "
           f"{floor:.3g})", worst, max(REL, 2 * floor))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "jamba-1.5-large-398b"])
def test_train_grads_with_jax_routing(lms, monkeypatch, arch):
    """``loss_fn``'s grads against ``jax.value_and_grad``'s with the port's
    tokens routed to JAX's experts: JAX's top-k of every MoE layer is
    recorded (``repro.models.moe.router_topk`` wrapped here, an ordered
    callback) in the same jitted grad run, and replayed in the port
    (``chip_smoke.PinnedRouting``, weights renormalized from the port's
    own router probabilities). The same 2 x 32 positions as
    ``test_train_step_vs_jax``. A router's top-k is discrete: an unpinned
    near-tie that flips moves a token's FFN output by its whole size.
    Pinned, the worst leaf by norm is held to rel 4e-2 for granite-moe.
    Reduced jamba pinned reads 0.143, its worst leaves all in the Mamba
    layers (printed here), so it keeps ``test_train_step_vs_jax``'s
    limit, twice JAX's own bf16 noise. That gap is bf16 noise: all in
    f32, the same grads agree within 1e-5
    (``tests/test_torch_ssm_grads.py``)."""
    cfg, jcfg, jparams, tparams = lms(arch)
    batch = _train_batch(cfg, 2, 32, seed=4)
    jb = jax.tree.map(jnp.asarray, batch)
    _, floor = _jax_grads_and_noise(jcfg, jparams, jb)
    recorded = []
    router_topk = JMoE.router_topk

    def recording(x2d, w, k):
        weights, idx, probs = router_topk(x2d, w, k)
        jax.debug.callback(lambda i: recorded.append(np.asarray(i)), idx, ordered=True)
        return weights, idx, probs
    monkeypatch.setattr(JMoE, "router_topk", recording)
    _, jgrads = jax.jit(jax.value_and_grad(
        lambda p, bt: JT.loss_fn(jcfg, p, bt, impl="ref", remat="none"), has_aux=True))(
        jparams, jb)
    jax.effects_barrier()
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    assert len(recorded) == moe_layers
    leaves = [p.clone().requires_grad_() for p in TO.tree_leaves(tparams)]
    with _chip_smoke().PinnedRouting() as pin:
        pin.calls = [torch.from_numpy(i).long() for i in recorded]
        pin.start("replay")
        loss, _ = TT.loss_fn(cfg, TO.tree_unflatten(tparams, leaves),
                             {k: torch.from_numpy(v) for k, v in batch.items()}, remat="none")
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    assert pin.at == moe_layers
    paths = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_leaves_with_path(jgrads)]
    jl = jax.tree.leaves(jgrads)
    assert len(jl) == len(grads)
    errs = sorted(((_rel_norm(j, t), k) for k, j, t in zip(paths, jl, grads)), reverse=True)
    for e, k in errs[:5]:
        print(f"[parity] {arch} pinned grads, leaf {k}: rel by norm {e:.4f}")
    tol = REL if arch == "granite-moe-1b-a400m" else max(REL, 2 * floor)
    _check(f"{arch} loss_fn grads with JAX's routing, worst leaf rel by norm (JAX's own bf16 "
           f"noise {floor:.3g})", errs[0][0], tol)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in ("internlm2-1.8b", "mamba2-2.7b")])
def test_launchers_run_every_arch_on_cpu(capsys, arch):
    """``python -m repro_torch.launch.serve`` and ``launch.train`` take every
    arch the JAX registry has, at the reduced size on the CPU: every
    request finishes (musicgen with (S, C) prompts, its tokens an int and
    then lists of C, as the JAX launcher's), two finite train steps on
    the token pipeline's batches (frontend embeddings and codebook
    labels included), and the plain versions launch no kernel."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    cfg = get_config(arch)
    reqs = launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "2",
                              "--max-new", "3", "--slots", "2"])
    assert [len(r.out_tokens) for r in reqs] == [3, 3]
    if cfg.num_codebooks > 1:
        assert reqs[0].prompt.shape[1] == cfg.num_codebooks
        assert all(len(t) == cfg.num_codebooks for r in reqs for t in r.out_tokens[1:])
    tr = launch_train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2"])
    assert len(tr.history) == 2 and all(np.isfinite(h["loss"]) for h in tr.history)
    out = capsys.readouterr().out
    assert "flash_attention=0 decode_attention=0 ssd_scan=0" in out
    assert "quantize=0 dequantize=0" in out
