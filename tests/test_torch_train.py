"""The port's training path against the JAX package, on the CPU, at a
reduced internlm2: ``lr_at``, ``adamw_update`` (f32 and int8 moments),
``cross_entropy``, ``loss_fn`` and its grads, ``attention_blocked``, the
train step's microbatches and node shares, the token pipeline, the
``Trainer`` and the launcher.

The JAX params are made with ``jax.random`` and bridged to the port as
numpy; grads, tokens and activations are made with numpy from a seed.
JAX steps are jitted once per module. Tolerances are stated per test:
elementwise f32 arithmetic is held to a few ulp or to 0, model outputs
and grads to rel 4e-2 (``tests/test_models.py:59``: bf16 products round
at other places in the two frameworks)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRunConfig
from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models import attention as JA
from repro.models import model as JM
from repro.models.params import init_params as jax_init_params
from repro.optim import adamw as JO
from repro.optim.schedule import lr_at as jax_lr_at
from repro.train import train_step as JT
from repro.train.trainer import Trainer as JTrainer
from repro_torch.bridge import opt_state_from_numpy, params_from_numpy, to_numpy
from repro_torch.configs import RunConfig, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.compression import Quantized
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models.params import init_params
from repro_torch.optim import adamw as TO
from repro_torch.optim.schedule import lr_at
from repro_torch.train import train_step as TT
from repro_torch.train.trainer import Trainer

REL = 4e-2


def _check(what, err, tol):
    """Hold an error to its tolerance and print it (``-s`` shows the
    parity table that PERF.md quotes)."""
    print(f"[parity] {what}: err {err:.3g} (tol {tol})")
    assert err <= tol


def _rel_norm(j, t):
    j = np.asarray(jnp.asarray(j, jnp.float32))
    t = t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)
    return float(np.linalg.norm(j - t) / (np.linalg.norm(j) + 1e-30))


@pytest.fixture(scope="module")
def lm():
    cfg = get_config("internlm2-1.8b").reduced()
    jcfg = jax_get_config("internlm2-1.8b").reduced()
    jparams = jax.jit(lambda k: jax_init_params(jcfg, k)[0])(jax.random.PRNGKey(0))
    return cfg, jcfg, jax.tree.map(np.asarray, jparams)


def _batch(cfg, b, s, seed=0, mask=True):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    loss_mask = ((rng.random((b, s)) < 0.8) if mask else np.ones((b, s))).astype(np.float32)
    return {"tokens": tokens, "labels": labels, "loss_mask": loss_mask}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("kw", [dict(base_lr=3e-4, warmup_steps=100, total_steps=1000),
                                dict(base_lr=1.0, warmup_steps=10, total_steps=100),
                                dict(base_lr=3e-4, warmup_steps=2, total_steps=3)])
def test_lr_at_sweep(kw):
    """f32 schedule, step by step: rel 1e-6 (cos rounds differently by an
    ulp or two in the two libraries)."""
    steps = list(range(0, kw["total_steps"] + 20, max(1, kw["total_steps"] // 50)))
    j = np.array([float(jax_lr_at(s, **kw)) for s in steps])
    t = np.array([float(lr_at(s, **kw)) for s in steps])
    assert lr_at(0, **kw).dtype == torch.float32
    _check(f"lr_at {kw}, {len(steps)} steps, max rel",
           float((np.abs(j - t) / np.maximum(np.abs(j), 1e-30)).max()), 1e-6)


def _grads(jparams, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32),
                        jparams)


@pytest.mark.parametrize("moments,gscale", [("f32", 1e-4), ("int8", 1e-4), ("f32", 1e-2),
                                            ("int8", 1e-2)])
def test_adamw_update_vs_jax(lm, moments, gscale):
    """Three AdamW steps from bridged params on identical bridged grads
    (new grads each step). At grad scale 1e-4 the global norm stays
    under the clip of 1.0 (scale exactly 1); at 1e-2 it clips, and the
    clip factor may differ by an ulp (the norm sums in another order).
    Params within 1e-6 abs, f32 moments within 1e-6 rel, int8 moments
    bit-equal (q and scales) unclipped and within one quantization step
    clipped."""
    _, _, jp = lm
    jparams = jax.tree.map(jnp.asarray, jp)
    tparams = params_from_numpy(jp, device="cpu")
    jstate = JO.adamw_init(jparams, moments=moments)
    tstate = TO.adamw_init(tparams, moments=moments)
    for step in range(3):
        g = _grads(jp, step, gscale)
        jparams, jstate, jm = JO.adamw_update(jax.tree.map(jnp.asarray, g), jstate,
                                              jparams, lr=1e-3, moments=moments)
        tparams, tstate, tm = TO.adamw_update(params_from_numpy(g, device="cpu"), tstate,
                                              tparams, lr=1e-3, moments=moments)
        _check(f"adamw {moments} g*{gscale} step {step} grad_norm rel",
               abs(float(jm["grad_norm"]) - float(tm["grad_norm"])) / float(jm["grad_norm"]),
               1e-6)
    perr = max(float(np.abs(np.asarray(a) - b).max()) for a, b in
               zip(jax.tree.leaves(jparams), TO.tree_leaves(to_numpy(tparams))))
    _check(f"adamw {moments} g*{gscale} params after 3 steps, max abs", perr, 1e-6)
    assert tstate.step == int(jstate.step) == 3
    tm_np, tv_np = to_numpy(tstate).m, to_numpy(tstate).v
    flips = 0
    for jtree, ttree in ((jstate.m, tm_np), (jstate.v, tv_np)):
        jl = jax.tree.leaves(jtree, is_leaf=lambda x: isinstance(x, tuple) and hasattr(x, "q"))
        tl = TO.tree_leaves(ttree)
        assert len(jl) == len(tl) == 11
        for a, b in zip(jl, tl):
            if moments == "f32":
                err = float(np.abs(np.asarray(a) - b).max() / (np.abs(np.asarray(a)).max() + 1e-30))
                assert err <= 1e-6, err
                continue
            assert isinstance(b, Quantized)
            dq = np.abs(np.asarray(a.q).astype(np.int32) - b.q.astype(np.int32))
            flips += int((dq != 0).sum())
            if gscale < 1e-3:
                assert (dq == 0).all() and np.array_equal(np.asarray(a.scale), b.scale)
            else:
                assert dq.max() <= 1
                assert np.allclose(np.asarray(a.scale), b.scale, rtol=1e-6, atol=0)
    if moments == "int8":
        n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jp))
        print(f"[parity] adamw int8 g*{gscale} q of m and v after 3 steps: {flips} of "
              f"{2 * n} one step off (tol {0 if gscale < 1e-3 else 'one step'})")


def test_adamw_decays_stacked_matrices_only(lm):
    """Decay is decided on the stacked leaf: the stacked norm scales (L, D)
    decay, ``final_norm`` (D,) does not (``adamw.py:88``)."""
    _, _, jp = lm
    tparams = params_from_numpy(jp, device="cpu")
    zero = TO.tree_map(torch.zeros_like, tparams)
    before = TO.tree_map(torch.clone, tparams)
    TO.adamw_update(zero, TO.adamw_init(tparams), tparams, lr=1e-2, weight_decay=0.5)
    assert not torch.equal(tparams["layers"][0]["norm1"]["scale"],
                           before["layers"][0]["norm1"]["scale"])
    assert torch.equal(tparams["final_norm"]["scale"], before["final_norm"]["scale"])


@pytest.mark.parametrize("softcap,mask,codebooks", [(None, False, 1), (30.0, True, 1),
                                                    (None, True, 2)])
def test_cross_entropy_vs_jax(softcap, mask, codebooks):
    """Chunked CE with z-loss on random bf16-rounded hidden states and
    head: rel 1e-5 (the bf16 head product may round an element
    differently; f32 sums in another order; measured at most 1e-7). S=48 with chunk 32 halves the
    chunk to 16."""
    base = dict(final_logit_softcap=softcap, num_codebooks=codebooks, tie_embeddings=False)
    cfg = get_config("internlm2-1.8b").reduced(**base)
    jcfg = jax_get_config("internlm2-1.8b").reduced(**base)
    rng = np.random.default_rng(3)
    b, s, d, v = 2, 48, cfg.d_model, cfg.vocab_size
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((codebooks, v, d) if codebooks > 1 else (v, d)) * 0.1
         ).astype(np.float32)
    lab = rng.integers(0, v, (b, s, codebooks) if codebooks > 1 else (b, s)).astype(np.int32)
    msk = ((rng.random((b, s)) < 0.7) if mask else np.ones((b, s))).astype(np.float32)
    ref = JM.cross_entropy(jcfg, {"lm_head": {"w": jnp.asarray(w)}},
                           jnp.asarray(hidden, jnp.bfloat16), jnp.asarray(lab),
                           jnp.asarray(msk), chunk=32)
    out = TM.cross_entropy(cfg, {"lm_head": {"w": torch.from_numpy(w)}},
                           torch.from_numpy(hidden).to(torch.bfloat16),
                           torch.from_numpy(lab), torch.from_numpy(msk), chunk=32)
    _check(f"cross_entropy softcap={softcap} mask={mask} codebooks={codebooks}, rel",
           abs(float(ref) - float(out)) / abs(float(ref)), 1e-5)


@pytest.fixture(scope="module")
def jax_grads(lm):
    """JAX's loss and grads (``jax.value_and_grad`` of ``loss_fn``,
    jitted once) on one masked batch of 2 x 32."""
    _, jcfg, jp = lm
    batch = _batch(get_config("internlm2-1.8b").reduced(), 2, 32, seed=5)
    fn = jax.jit(jax.value_and_grad(
        lambda p, bt: JT.loss_fn(jcfg, p, bt, impl="auto", remat="minimal", loss_chunk=16),
        has_aux=True))
    (loss, parts), grads = fn(jax.tree.map(jnp.asarray, jp),
                              jax.tree.map(jnp.asarray, batch))
    return batch, float(loss), float(parts["ce"]), jax.tree.leaves(grads)


@pytest.mark.parametrize("remat", ["none", "minimal", "full"])
def test_loss_fn_grads_vs_jax(lm, jax_grads, remat):
    """Loss within rel 1e-3 and each leaf's grad within rel 4e-2 by norm of
    ``jax.value_and_grad``; the three remat policies give the same
    numbers bit for bit (they change memory only)."""
    cfg, _, jp = lm
    batch, jloss, jce, jgrads = jax_grads
    tparams = params_from_numpy(jp, device="cpu")
    leaves = [p.requires_grad_() for p in TO.tree_leaves(tparams)]
    loss, parts = TT.loss_fn(cfg, tparams, _tb(batch), impl="auto", remat=remat,
                             loss_chunk=16)
    grads = torch.autograd.grad(loss, leaves)
    _check(f"loss_fn remat={remat} loss rel", abs(loss.item() - jloss) / jloss, 1e-3)
    assert abs(parts["ce"].item() - jce) / jce <= 1e-3 and parts["aux"].item() == 0.0
    worst = max(_rel_norm(j, t) for j, t in zip(jgrads, grads))
    _check(f"loss_fn remat={remat} grads, worst leaf rel by norm", worst, REL)
    if remat != "none":
        ref = TT.loss_fn(cfg, tparams, _tb(batch), remat="none", loss_chunk=16)[0]
        assert torch.equal(torch.autograd.grad(ref, leaves)[0], grads[0])


@pytest.mark.parametrize("case", [(64, 16, 16, None, None), (64, 16, 32, 24, None),
                                  (64, 32, 16, None, 30.0), (40, 16, 16, None, None)])
def test_attention_blocked_vs_jax(case):
    """Blocked online-softmax attention, f32, GQA 4/2: max abs 2e-5 (the
    kernels' f32 tolerance, ``tests/test_kernels.py``). S=40 is no block
    multiple and falls back to the reference, as in JAX. Its gradient
    matches ``attention_ref``'s (2e-5 abs)."""
    s, qb, kb, win, cap = case
    rng = np.random.default_rng(s + qb)
    q, k, v = (rng.standard_normal((2, s, h, 16)).astype(np.float32) for h in (4, 2, 2))
    ref = JA.attention_blocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=win,
                               softcap=cap, q_block=qb, kv_block=kb)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = TA.attention_blocked(tq, tk, tv, window=win, softcap=cap, q_block=qb, kv_block=kb)
    _check(f"attention_blocked {case} vs JAX, max abs",
           float(np.abs(np.asarray(ref) - out.detach().numpy()).max()), 2e-5)
    gb = torch.autograd.grad(out.square().sum(), (tq, tk, tv))
    gr = torch.autograd.grad(TA.attention_ref(tq, tk, tv, window=win, softcap=cap)
                             .square().sum(), (tq, tk, tv))
    _check(f"attention_blocked {case} grads vs attention_ref, max abs",
           max(float((a - b).abs().max()) for a, b in zip(gb, gr)), 2e-5)


def test_train_impl_follows_jax_auto_rule(lm, monkeypatch):
    """The training forward takes JAX's ``auto`` rule: the plain reference
    below 2048 tokens, the blocked scan from 2048, never a kernel."""
    cfg, _, jp = lm
    assert TA.train_impl(2047) == "ref" and TA.train_impl(2048) == "blocked"
    seen = []
    real = TA.attention_blocked
    monkeypatch.setattr(TA, "attention_blocked",
                        lambda *a, **k: seen.append(a[0].shape[1]) or real(*a, **k))
    tparams = params_from_numpy(jp, device="cpu")
    with torch.no_grad():
        TT.loss_fn(cfg, tparams, _tb(_batch(cfg, 1, 2048)))
        assert seen == [2048] * cfg.num_layers
        TT.loss_fn(cfg, tparams, _tb(_batch(cfg, 1, 64)))
        assert seen == [2048] * cfg.num_layers


@pytest.fixture(scope="module")
def step_setup(lm):
    cfg, jcfg, jp = lm
    return cfg, jcfg, jp, _batch(cfg, 4, 16, seed=1, mask=False)


def _run_step(cfg, jp, batch, microbatch=0, shares=None, step=1):
    run = RunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                    microbatch=microbatch)
    tparams = params_from_numpy(jp, device="cpu")
    step_fn = TT.make_train_step(cfg, run)
    p2, opt2, m = step_fn(tparams, TO.adamw_init(tparams), _tb(batch), step,
                          node_shares=shares)
    return p2, m


def test_microbatch_equivalence(step_setup):
    """2 microbatches of B/2 give the same step as one batch of B: loss
    and params within 1e-4 at step 0 (as ``tests/test_models.py::
    test_microbatch_equivalence``), and the mean grads' norm within rel
    1e-5 (f32 sums in another order). Adam's first step with a learning
    rate is sign-like and flips on near-zero grads, so params are
    compared where JAX's test compares them. The grad norm is held to
    rel 1e-4: the bf16 products of a half batch round differently."""
    cfg, _, jp, batch = step_setup
    p0, m0 = _run_step(cfg, jp, batch, microbatch=0, step=0)
    p2, m2 = _run_step(cfg, jp, batch, microbatch=2, step=0)
    _check("microbatch 2 vs 1 loss, abs", abs(float(m0["loss"]) - float(m2["loss"])), 1e-4)
    _check("microbatch 2 vs 1 grad_norm, rel",
           abs(float(m0["grad_norm"]) - float(m2["grad_norm"])) / float(m0["grad_norm"]), 1e-4)
    _check("microbatch 2 vs 1 params, max abs",
           max(float((a - b).abs().max()) for a, b in
               zip(TO.tree_leaves(p0), TO.tree_leaves(p2))), 1e-4)


def test_equal_shares_are_bit_identical_to_none(step_setup):
    cfg, _, jp, batch = step_setup
    pa, ma = _run_step(cfg, jp, batch, microbatch=4)
    pb, mb = _run_step(cfg, jp, batch, microbatch=4, shares=(2, 2))
    assert float(ma["loss"]) == float(mb["loss"])
    assert all(torch.equal(a, b) for a, b in zip(TO.tree_leaves(pa), TO.tree_leaves(pb)))


def test_skewed_shares_vs_jax_and_plain(step_setup):
    """Shares (1, 3) run each node's sub-batch; the global mean is the
    plain step's (loss within 1e-4 abs, grad norm within rel 1e-4) and
    JAX's skewed step's (rel 1e-3 loss, rel 4e-2 grad norm)."""
    cfg, jcfg, jp, batch = step_setup
    _, m_plain = _run_step(cfg, jp, batch, microbatch=4)
    _, m_skew = _run_step(cfg, jp, batch, microbatch=4, shares=(1, 3))
    _check("skewed shares vs plain, loss abs",
           abs(float(m_plain["loss"]) - float(m_skew["loss"])), 1e-4)
    _check("skewed shares vs plain, grad_norm rel",
           abs(float(m_plain["grad_norm"]) - float(m_skew["grad_norm"]))
           / float(m_plain["grad_norm"]), 1e-4)
    jrun = JRunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, microbatch=4)
    jparams = jax.tree.map(jnp.asarray, jp)
    jstep = jax.jit(JT.make_train_step(jcfg, jrun, impl="ref"),
                    static_argnames=("node_shares",))
    _, _, jm = jstep(jparams, JO.adamw_init(jparams), jax.tree.map(jnp.asarray, batch),
                     jnp.asarray(1), node_shares=(1, 3))
    _check("skewed shares vs JAX, loss rel",
           abs(float(jm["loss"]) - float(m_skew["loss"])) / float(jm["loss"]), 1e-3)
    _check("skewed shares vs JAX, grad_norm rel",
           abs(float(jm["grad_norm"]) - float(m_skew["grad_norm"])) / float(jm["grad_norm"]),
           REL)


def test_split_by_shares():
    batch = {"tokens": torch.arange(24).view(12, 2), "loss_mask": torch.ones(12, 2)}
    subs = TT.split_by_shares(batch, (1, 2, 3))
    assert [s["tokens"].shape[0] for s in subs] == [2, 4, 6]
    assert torch.equal(torch.cat([s["tokens"] for s in subs]), batch["tokens"])
    jsubs = JT.split_by_shares({k: v.numpy() for k, v in batch.items()}, (1, 2, 3))
    assert all(np.array_equal(np.asarray(j["tokens"]), t["tokens"].numpy())
               for j, t in zip(jsubs, subs))
    for bad, msg in (((0, 2), ">= 1"), ((5,), "does not split")):
        with pytest.raises(ValueError, match=msg):
            TT.split_by_shares(batch, bad)


def test_pod_sync_compressed_raises(lm):
    """The int8 ring across pods is ported (``tests/test_torch_distributed.py``
    holds it against JAX on 8 ranks). What still raises: a batch that does
    not split over the pods, before any collective. Without a mesh the
    compressed step is the plain one, as JAX's."""
    cfg = lm[0]

    class TwoPods:
        shape = {"pod": 2}
    step = TT.make_train_step(cfg, RunConfig(pod_sync="compressed"), mesh=TwoPods())
    tok = torch.zeros((3, 8), dtype=torch.long)
    batch = {"tokens": tok, "labels": tok, "loss_mask": torch.ones((3, 8))}
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="does not split over 2 pods"):
        step(params, TO.adamw_init(params), batch, 0)
    losses = []
    for mode in ("auto", "compressed"):
        own = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        _, _, m = TT.make_train_step(cfg, RunConfig(pod_sync=mode))(
            own, TO.adamw_init(own), batch, 1)
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1]


@pytest.mark.parametrize("over", [{}, dict(num_codebooks=2),
                                  dict(frontend="vision", frontend_tokens=8)])
@pytest.mark.parametrize("seed", [0, 3])
def test_pipeline_batch_at_equal(over, seed):
    cfg = get_config("internlm2-1.8b").reduced(**over)
    jcfg = jax_get_config("internlm2-1.8b").reduced(**over)
    tp = TokenPipeline(cfg, ShapeConfig("t", 32, 4, "train"), seed=seed)
    jpipe = JTokenPipeline(jcfg, JShapeConfig("t", 32, 4, "train"), seed=seed)
    for step in (0, 1, 17):
        a, b = tp.batch_at(step), jpipe.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("moments", ["f32", "int8"])
def test_trainer_losses_vs_jax_trainer(lm, tmp_path, moments):
    """Three steps of the ``Trainer`` from bridged params against the JAX
    ``Trainer`` with a jitted step: losses within rel 1e-3. f32 moments
    at lr 1e-2 (warmup 1); int8 moments at the launcher's settings (lr
    3e-4, warmup 2). Int8 v, as JAX stores it, rounds the small second
    moments of a block to 0, so where a later grad is small the update
    m / (sqrt(v) + eps) grows large in both packages: a larger lr makes
    both runs, and their difference, blow up (JAX's own loss reaches 25
    at step 2 with lr 1e-2). Each record is floats, and the JSONL log
    holds every record."""
    cfg, jcfg, jp = lm
    shape = ShapeConfig("tiny", 32, 4, "train")
    int8 = moments == "int8"
    kw = dict(learning_rate=3e-4 if int8 else 1e-2, warmup_steps=2 if int8 else 1,
              total_steps=3, moments_int8=int8)
    run, jrun = RunConfig(**kw), JRunConfig(**kw)
    jparams = jax.tree.map(jnp.asarray, jp)
    jtr = JTrainer(jcfg, jrun, JShapeConfig("tiny", 32, 4, "train"),
                   step_fn=jax.jit(JT.make_train_step(jcfg, jrun, impl="ref")),
                   params=jparams, opt_state=JO.adamw_init(jparams, moments=moments))
    jtr.run_steps(3)
    tparams = params_from_numpy(jp, device="cpu")
    log = tmp_path / "train.jsonl"
    tr = Trainer(cfg, run, shape, step_fn=TT.make_train_step(cfg, run), params=tparams,
                 opt_state=TO.adamw_init(tparams, moments=moments), log_path=str(log))
    last = tr.run_steps(3)
    assert last is tr.history[-1] and tr.start_step == 3
    assert all(type(v) is float for h in tr.history for k, v in h.items() if k != "step")
    assert len(log.read_text().splitlines()) == 3
    for j, t in zip(jtr.history, tr.history):
        _check(f"Trainer {moments} step {t['step']} loss rel",
               abs(j["loss"] - t["loss"]) / j["loss"], 1e-3)
    assert isinstance(TO.tree_leaves(tr.opt_state.m)[0], Quantized) == int8


def test_trainer_refuses_what_is_not_ported(lm, tmp_path):
    """Checkpoints, simulated time and failure injection are ported: the
    ``Trainer`` takes ``ckpt=``, ``runtime=``, ``time_model=`` and
    ``fail_at=``. Since the multi-device slice nothing of the trainer's is
    left to refuse: ``--multi-pod`` trains on 2 spawned gloo ranks, rank
    0's loss the one-process run's (rel 1e-5: the ranks run fewer CPU
    threads, so the sums may round otherwise)."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.core.runtime import FabricRuntime
    from repro_torch.ft.manager import NodeFailure
    from repro_torch.train.cluster import ClusterTimeModel, train_fabric
    cfg, _, _ = lm
    kw = dict(step_fn=None, params={}, opt_state=None)
    tr = Trainer(cfg, RunConfig(), ShapeConfig("t", 8, 2, "train"), **kw,
                 ckpt=CheckpointManager(str(tmp_path)), runtime=FabricRuntime(train_fabric(1)),
                 time_model=ClusterTimeModel(compute_s=0.1, grad_bytes=0.0))
    assert tr.start_step == 0 and tr.runtime is not None
    with pytest.raises(NodeFailure):
        tr.run_steps(1, fail_at=0)
    base = ["--arch", "internlm2-1.8b", "--reduced", "--device", "cpu", "--steps", "1"]
    losses = launch_train.main(base + ["--multi-pod", "--ranks", "2"])
    one = launch_train.main(base).history[0]["loss"]
    assert len(losses) == 1 and abs(losses[0] - one) <= 1e-5 * abs(one)


def test_opt_state_bridge(lm):
    """A JAX int8 ``AdamWState`` bridges to the port's and back unchanged."""
    _, _, jp = lm
    jstate = jax.tree.map(np.asarray, JO.adamw_init(jax.tree.map(jnp.asarray, jp),
                                                    moments="int8"))
    tstate = opt_state_from_numpy(jstate, device="cpu")
    assert tstate.step == 0 and isinstance(TO.tree_leaves(tstate.m)[0], Quantized)
    back = to_numpy(tstate)
    jl = jax.tree.leaves(jstate.m)
    tl = [x for qt in TO.tree_leaves(back.m) for x in qt]
    assert len(jl) == len(tl) and all(np.array_equal(a, b) for a, b in zip(jl, tl))


def test_launcher_trains_on_cpu(capsys, monkeypatch):
    """``--reduced --device cpu --moments-int8`` trains 3 finite steps on
    the plain versions; without ``--device`` it raises with no card."""
    tr = launch_train.main(["--arch", "internlm2-1.8b", "--reduced", "--device", "cpu",
                            "--steps", "3", "--moments-int8"])
    out = capsys.readouterr().out
    assert len(tr.history) == 3 and all(np.isfinite(h["loss"]) for h in tr.history)
    assert out.count("[train] step") == 3 and "[train] done" in out
    assert tr.run.moments_int8 and tr.run.warmup_steps == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "internlm2-1.8b", "--reduced", "--steps", "1"])
