"""The port's ServeEngine on the CPU against the JAX ServeEngine, on the
request sets of ``tests/test_serve.py``, from bridged params, for
reduced internlm2 (bucketed prefill) and reduced mamba2 (exact-length
prefill of SSM layers).

Greedy tokens must be identical wherever the choice is clear: where the
two engines part, the JAX model's margin between its top two logits at
that step must be within the logits tolerance (rel 4e-2 of the largest
logit, as in ``tests/test_models.py``). Teacher-forced logits along the
JAX tokens are held to that tolerance at every step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro.models.params import init_params as jax_init_params
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.serve.engine import Request, ServeEngine

REL = 4e-2

# (slots, rng seed, [(prompt_len, max_new), ...]) as in tests/test_serve.py
REQUEST_SETS = {
    "all_requests": (3, 0, [(8, 5)] * 7),
    "mixed_lengths": (4, 2, [(4, 3), (12, 6), (8, 2), (16, 4), (6, 5)]),
    "run_returns_completed": (2, 3, [(8, 3)] * 5),
}


ARCHS = ("internlm2-1.8b", "mamba2-2.7b")


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


@pytest.fixture(scope="module")
def lm(lms):
    return lms("internlm2-1.8b")


def _prompts(cfg, seed, spec):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, plen).astype(np.int32) for plen, _ in spec]


def _serve_both(lm, slots, seed, spec):
    cfg, jcfg, jparams, tparams = lm
    prompts = _prompts(cfg, seed, spec)
    jeng = JaxServeEngine(jcfg, jparams, slots=slots, max_len=64, impl="ref")
    teng = ServeEngine(cfg, tparams, slots=slots, max_len=64, device="cpu")
    jreqs, treqs = [], []
    for i, (p, (_, new)) in enumerate(zip(prompts, spec)):
        jreqs.append(JaxRequest(rid=i, prompt=p, max_new_tokens=new))
        treqs.append(Request(rid=i, prompt=p, max_new_tokens=new))
        jeng.submit(jreqs[-1])
        teng.submit(treqs[-1])
    jdone, tdone = jeng.run(), teng.run()
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert teng.stats == jeng.stats
    return jreqs, treqs, teng.stats


def _teacher_forced(lm, reqs):
    """Per-request logits (steps, V) of both models along prompt +
    out_tokens[:-1]. All sequences go in one right-padded batch: causal
    attention, and the SSM's causal conv and recurrence, keep the pad
    after a sequence's last real token out of the positions read."""
    cfg, jcfg, jparams, tparams = lm
    seqs = [np.concatenate([r.prompt, np.asarray(r.out_tokens[:-1], np.int32)])
            for r in reqs]
    full = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
    for i, seq in enumerate(seqs):
        full[i, :len(seq)] = seq
    jl = np.asarray(jax.jit(lambda p, t: JM.logits_for(
        jcfg, p, JM.forward(jcfg, p, t, impl="ref", remat="none").hidden))(
            jparams, jnp.asarray(full)))
    th = TM.forward(cfg, tparams, torch.from_numpy(full)).hidden
    tl = TM.logits_for(cfg, tparams, th).numpy()
    return [(jl[i, len(r.prompt) - 1:len(seq)], tl[i, len(r.prompt) - 1:len(seq)])
            for i, (r, seq) in enumerate(zip(reqs, seqs))]


@pytest.mark.parametrize(
    "arch,name", [(a, n) for a in ARCHS for n in REQUEST_SETS],
    ids=[n if a == ARCHS[0] else f"{a}-{n}" for a in ARCHS for n in REQUEST_SETS])
def test_engine_matches_jax_engine(lms, arch, name):
    """Same retirement order and stats (for mamba2: no padded tokens, one
    prefill "compilation" per distinct prompt length), tokens and
    teacher-forced logits within the tolerance."""
    lm = lms(arch)
    slots, seed, spec = REQUEST_SETS[name]
    jreqs, treqs, stats = _serve_both(lm, slots, seed, spec)
    if arch == "mamba2-2.7b":
        assert stats["prefill_padded_tokens"] == 0
        assert stats["prefill_compilations"] == len({plen for plen, _ in spec})
    forced = _teacher_forced(lm, jreqs)
    for jr, tr, (_, new), (jl, tl) in zip(jreqs, treqs, spec, forced):
        assert tr.done and len(tr.out_tokens) == new == len(jr.out_tokens)
        scale = np.abs(jl).max(axis=-1)
        err = float((np.abs(jl - tl).max(axis=-1) / scale).max())
        print(f"[parity] engine {arch} {name} rid {jr.rid} teacher-forced logits, rel: "
              f"err {err:.3g} (tol {REL})")
        assert err < REL
        parted = [i for i, (a, b) in enumerate(zip(jr.out_tokens, tr.out_tokens)) if a != b]
        if parted:
            top2 = np.sort(jl[parted[0]])[-2:]
            assert top2[1] - top2[0] < REL * scale[parted[0]], (jr.rid, parted[0])


def test_engine_greedy_matches_offline(lm):
    """The port's own check of test_serve.py:33-44: the last served token
    is the argmax of a full forward over prompt + earlier tokens."""
    cfg, _, _, tparams = lm
    eng = ServeEngine(cfg, tparams, slots=2, max_len=64, device="cpu")
    r = Request(rid=0, prompt=_prompts(cfg, 1, [(8, 4)])[0], max_new_tokens=4)
    eng.submit(r)
    eng.run()
    full = np.concatenate([r.prompt, np.asarray(r.out_tokens[:-1], np.int32)])[None]
    h = TM.forward(cfg, tparams, torch.from_numpy(full)).hidden
    assert int(TM.logits_for(cfg, tparams, h[:, -1:])[0, 0].argmax()) == r.out_tokens[-1]


def test_engine_run_returns_and_drains(lm):
    cfg, _, _, tparams = lm
    eng = ServeEngine(cfg, tparams, slots=2, max_len=64, device="cpu")
    for i, p in enumerate(_prompts(cfg, 3, [(8, 3)] * 5)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=3))
    assert sorted(r.rid for r in eng.run()) == [0, 1, 2, 3, 4]
    assert eng.run() == []
    eng.submit(Request(rid=99, prompt=_prompts(cfg, 4, [(8, 2)])[0], max_new_tokens=2))
    assert [r.rid for r in eng.run()] == [99]


def test_launcher_serves_on_cpu(capsys):
    """``python -m repro_torch.launch.serve`` at the reduced size on the
    CPU: every request finishes, and the plain versions launch no kernel."""
    from repro_torch.launch import serve as launch_serve
    for arch in ARCHS:
        reqs = launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                                  "--requests", "3", "--max-new", "3", "--slots", "2"])
        assert [len(r.out_tokens) for r in reqs] == [3, 3, 3]
        out = capsys.readouterr().out
        assert "[serve] 3 requests, 9 tokens" in out
        assert "flash_attention=0 decode_attention=0 ssd_scan=0" in out


def test_engine_sampling_uses_its_generator(lm):
    """temperature > 0 draws from the engine's seeded torch.Generator:
    the same seed gives the same tokens (not jax.random's)."""
    cfg, _, _, tparams = lm
    outs = []
    for _ in range(2):
        eng = ServeEngine(cfg, tparams, slots=2, max_len=64, seed=7, device="cpu")
        r = Request(rid=0, prompt=_prompts(cfg, 5, [(8, 6)])[0], max_new_tokens=6,
                    temperature=1.0)
        eng.submit(r)
        eng.run()
        outs.append(r.out_tokens)
    assert outs[0] == outs[1] and len(outs[0]) == 6
