"""The SSM backward on its own, in f32, against the JAX package.

``tests/test_torch_zoo.py`` holds reduced jamba's ``loss_fn`` grads
with the routing pinned to JAX's, in bf16, to twice JAX's own bf16
noise; its worst leaves are all Mamba leaves. These tests settle
whether that gap is noise or a wrong gradient, where no bf16 rounding
can hide one:

- the VJPs of ``ssd_chunked`` and ``causal_conv`` in f32 against
  ``jax.vjp`` of the JAX functions, at reduced mamba2's and jamba's
  shapes, S a multiple of the chunk and not (rel 1e-5 by norm per
  input);
- reduced jamba's ``loss_fn`` grads with JAX's routing pinned, all in
  f32, worst leaf by norm within 1e-3. ``dtype="float32"`` alone keeps
  the residual stream, the norms and the scan in f32, but both packages
  still round every product's inputs to bf16 (``repro/models/model.py:
  59-62``, ``layers.py:94-98``, ``moe.py:64-68`` and their ports), and
  reduced jamba's grads then part by 0.224 on the worst leaf, as far
  as in bf16. So the test also reads ``bfloat16`` as ``float32`` in the
  model modules of both packages (their module globals ``jnp`` and
  ``torch``, replaced for this test only; no file changes).

Inputs are made with numpy from a seed; cotangents too."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.models import ssm as JS
from repro.models.params import init_params as jax_init_params
from repro.train import train_step as JT
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models import ssm as TS
from repro_torch.optim import adamw as TO
from repro_torch.train import train_step as TT

from test_torch_zoo import _chip_smoke, _rel_norm, _train_batch

VJP_TOL = 1e-5
F32_GRAD_TOL = 1e-3
SSM_ARCHS = ["mamba2-2.7b", "jamba-1.5-large-398b"]
LENGTHS = [32, 37, 5]        # two chunks of 16; ragged past a chunk; inside one


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _vjp_check(what, jfn, tfn, inputs, cotangents):
    """``jax.vjp`` of ``jfn`` against ``torch.autograd.grad`` of ``tfn`` on
    the same numpy inputs and cotangents; rel by norm per input."""
    jout, jvjp = jax.vjp(jfn, *(jnp.asarray(x) for x in inputs))
    jgrads = jvjp(tuple(jnp.asarray(c) for c in cotangents))
    tin = [torch.from_numpy(x).requires_grad_() for x in inputs]
    tout = tfn(*tin)
    for j, t in zip(jout, tout):
        assert _rel_norm(j, t) < VJP_TOL, f"{what}: forward"
    total = sum((t * torch.from_numpy(c)).sum() for t, c in zip(tout, cotangents))
    tgrads = torch.autograd.grad(total, tin)
    errs = [_rel_norm(j, t) for j, t in zip(jgrads, tgrads)]
    print(f"[parity] {what}: VJP rel by norm per input {[f'{e:.3g}' for e in errs]} "
          f"(tol {VJP_TOL})")
    assert max(errs) < VJP_TOL


@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssd_chunked_vjp_vs_jax(arch, s):
    """x, dt (post-softplus), A (negative), B and C, and the initial
    state's absence: d/d of y and of the final state."""
    cfg = get_config(arch).reduced()
    b, h, p, n, chunk = 2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    rng = np.random.default_rng(11 + s)
    x = _f32(rng, b, s, h, p)
    dt = np.log1p(np.exp(_f32(rng, b, s, h) - 1.0)).astype(np.float32)
    a = -np.exp(_f32(rng, h, scale=0.5)).astype(np.float32)
    bm, c = _f32(rng, b, s, n), _f32(rng, b, s, n)
    gy, gh = _f32(rng, b, s, h, p), _f32(rng, b, h, p, n)
    _vjp_check(f"{arch} ssd_chunked S={s} chunk={chunk}",
               lambda *t: JS.ssd_chunked(*t, chunk=chunk),
               lambda *t: TS.ssd_chunked(*t, chunk=chunk),
               [x, dt, a, bm, c], [gy, gh])


@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_causal_conv_vjp_vs_jax(arch, s):
    """The x, B and C streams' depthwise conv (left zero pad of K-1) and
    its state output: d/dx and d/dw, for each stream's width."""
    cfg = get_config(arch).reduced()
    k = cfg.ssm_conv
    rng = np.random.default_rng(23 + s)
    for ch in (cfg.d_inner, cfg.ssm_state):
        x, w = _f32(rng, 2, s, ch), _f32(rng, k, ch)
        gy, gs = _f32(rng, 2, s, ch), _f32(rng, 2, k - 1, ch)
        _vjp_check(f"{arch} causal_conv S={s} channels={ch}", JS.causal_conv,
                   TS.causal_conv, [x, w], [gy, gs])


class _F32Products:
    """A module (``jax.numpy`` or ``torch``) whose ``bfloat16`` is
    ``float32``."""

    def __init__(self, module, f32):
        self._module, self.bfloat16 = module, f32

    def __getattr__(self, name):
        return getattr(self._module, name)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "mamba2-2.7b"])
def test_f32_grads_with_jax_routing(monkeypatch, arch):
    """``test_train_grads_with_jax_routing[jamba-1.5-large-398b]`` again,
    all in f32 (both configs ``dtype="float32"``, every product in f32 in
    both packages: module docstring): the same params (PRNGKey(0)), the
    same 2 x 32 positions of seed 4, ``remat="none"``, every MoE call
    pinned to JAX's recorded top-k (mamba2 has none). The worst leaf by
    norm within 1e-3, the losses within rel 1e-5."""
    for mod in (JM, JL, JMoE):
        monkeypatch.setattr(mod, "jnp", _F32Products(jnp, jnp.float32))
    for mod in (TM, TL, TMoE):
        monkeypatch.setattr(mod, "torch", _F32Products(torch, torch.float32))
    cfg = get_config(arch).reduced(dtype="float32")
    jcfg = jax_get_config(arch).reduced(dtype="float32")
    jparams = jax.jit(lambda key: jax_init_params(jcfg, key)[0])(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    batch = _train_batch(cfg, 2, 32, seed=4)
    jb = jax.tree.map(jnp.asarray, batch)
    recorded = []
    router_topk = JMoE.router_topk

    def recording(x2d, w, k):
        weights, idx, probs = router_topk(x2d, w, k)
        jax.debug.callback(lambda i: recorded.append(np.asarray(i)), idx, ordered=True)
        return weights, idx, probs
    monkeypatch.setattr(JMoE, "router_topk", recording)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
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
        print(f"[parity] {arch} f32 pinned grads, leaf {k}: rel by norm {e:.3g}")
    print(f"[parity] {arch} f32 losses: JAX {float(jloss):.7f} port {float(loss):.7f}")
    assert abs(float(jloss) - float(loss)) / abs(float(jloss)) < 1e-5
    assert errs[0][0] < F32_GRAD_TOL
