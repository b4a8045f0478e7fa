"""The port's MoE (``repro_torch.models.moe``, the local dispatch) against
the JAX package's ``repro.models.moe``, on the CPU: every case of
``tests/test_moe.py``, and the pieces one by one.

The setup is ``tests/test_moe.py``'s (made with ``jax.random`` and handed
to the port as numpy); other inputs are made with numpy from a seed.
Tolerances: routing indices, kept masks, slots and the dropped fraction
are exactly JAX's (the router product and softmax are f32 in both, and
ties break alike); f32 router weights, probabilities, the load-balance
loss and the expert load within rel 1e-5 (f32 sums in another order);
MoE outputs, whose expert products are bf16 in both frameworks, within
rel 2e-2 of their largest magnitude (a bf16 step is 2^-8 = 3.9e-3: two
rounded products and a rounded activation each may land one step apart);
the dense f32 oracle within ``tests/test_moe.py``'s abs 5e-2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import moe as JMoE
from repro_torch.models import moe as TMoE

BF16_REL = 2e-2
F32_REL = 1e-5


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _rel(j, t):
    j, t = _np(j), _np(t)
    return float(np.abs(j - t).max()) / (float(np.abs(j).max()) + 1e-30)


def _check(what, err, tol):
    """Hold an error to its tolerance and print it (``-s`` shows the
    parity table)."""
    print(f"[parity] {what}: err {err:.3g} (tol {tol})")
    assert err < tol


@pytest.fixture(scope="module")
def setup():
    """``tests/test_moe.py::setup``: B=2, S=128, D=32, E=8, top-2, F=64."""
    k0 = jax.random.PRNGKey(2)
    B, S, D, E, K, Fd = 2, 128, 32, 8, 2, 64
    ks = jax.random.split(k0, 4)
    params = {"router": jax.random.normal(ks[1], (D, E)) * 0.02,
              "w_in": jax.random.normal(ks[2], (E, D, 2, Fd)) * 0.05,
              "w_out": jax.random.normal(ks[3], (E, Fd, D)) * 0.05}
    x_uniform = jax.random.normal(ks[0], (B, S, D)) * 0.5
    x_skewed = (jax.random.normal(ks[0], (B, S, D)) * 0.1
                + params["router"][:, 0][None, None, :] * 1.5)
    tparams = {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}
    return (params, tparams, x_uniform, x_skewed, E, K)


def _both(setup, x, **kw):
    """moe_ffn of JAX and of the port on the same input."""
    params, tparams, _, _, E, K = setup
    jy, jm = JMoE.moe_ffn(x, params, num_experts=E, top_k=K, activation=jax.nn.silu, **kw)
    ty, tm = TMoE.moe_ffn(torch.from_numpy(np.asarray(x)), tparams, num_experts=E,
                          top_k=K, activation=F.silu, **kw)
    return jy, jm, ty, tm


def _same_metrics(what, jm, tm):
    _check(f"{what} aux_loss, rel", _rel(jm.aux_loss, tm.aux_loss), F32_REL)
    assert float(jm.dropped_frac) == float(tm.dropped_frac), what
    _check(f"{what} expert_load, rel", _rel(jm.expert_load, tm.expert_load), F32_REL)


def test_lossless_matches_dense(setup):
    """``tests/test_moe.py:24``: capacity None drops nothing and matches
    the dense oracle (abs 5e-2), in the port and against JAX."""
    params, tparams, x, _, E, K = setup
    jy, jm, ty, tm = _both(setup, x, capacity_factor=None)
    yref = TMoE.moe_ffn_dense_ref(torch.from_numpy(np.asarray(x)), tparams, num_experts=E,
                                  top_k=K, activation=F.silu)
    jref = JMoE.moe_ffn_dense_ref(x, params, num_experts=E, top_k=K, activation=jax.nn.silu)
    _check("lossless vs the port's dense oracle, max abs",
           float((ty.float() - yref.float()).abs().max()), 5e-2)
    _check("dense oracle vs JAX's, rel", _rel(jref, yref), F32_REL)
    _check("lossless moe_ffn vs JAX, rel", _rel(jy, ty), BF16_REL)
    assert float(tm.dropped_frac) == 0.0
    _same_metrics("lossless", jm, tm)


def test_tight_capacity_drops(setup):
    """``tests/test_moe.py:34``: skewed routing at capacity 0.8 drops some
    but not all assignments, the same ones as JAX."""
    _, _, _, x_skew, _, _ = setup
    jy, jm, ty, tm = _both(setup, x_skew, capacity_factor=0.8)
    assert 0.0 < float(tm.dropped_frac) < 1.0
    _same_metrics("capacity 0.8 skewed", jm, tm)
    _check("capacity 0.8 skewed y vs JAX, rel", _rel(jy, ty), BF16_REL)


@pytest.mark.parametrize("which", ["uniform", "skewed"])
def test_capacity_1_25(setup, which):
    """The training forward's capacity factor: output and metrics against
    JAX; the skewed input drops assignments at 1.25 too."""
    _, _, x_uni, x_skew, _, _ = setup
    jy, jm, ty, tm = _both(setup, x_uni if which == "uniform" else x_skew,
                           capacity_factor=1.25)
    _same_metrics(f"capacity 1.25 {which}", jm, tm)
    _check(f"capacity 1.25 {which} y vs JAX, rel", _rel(jy, ty), BF16_REL)
    if which == "skewed":
        assert float(tm.dropped_frac) > 0.0


def test_hot_expert_replication_reduces_drops(setup):
    """``tests/test_moe.py:41``: Advice #1, replicating the hottest
    experts' queues tames skew; the same drops as JAX."""
    _, _, _, x_skew, _, _ = setup
    _, jm0, _, tm0 = _both(setup, x_skew, capacity_factor=0.8)
    jy3, jm3, ty3, tm3 = _both(setup, x_skew, capacity_factor=0.8, hot_expert_replicas=3)
    assert float(tm3.dropped_frac) < float(tm0.dropped_frac)
    _same_metrics("capacity 0.8 skewed, 3 replicas", jm3, tm3)
    _check("3 replicas y vs JAX, rel", _rel(jy3, ty3), BF16_REL)


def test_replication_is_output_lossless(setup):
    """``tests/test_moe.py:52``: with lossless capacity, replicas do not
    change the math (abs 5e-3)."""
    _, _, _, x_skew, _, _ = setup
    _, _, y0, _ = _both(setup, x_skew, capacity_factor=None)
    _, _, y3, _ = _both(setup, x_skew, capacity_factor=None, hot_expert_replicas=3)
    _check("lossless, 3 replicas vs none, max abs",
           float((y0.float() - y3.float()).abs().max()), 5e-3)


def test_replicate_hot_experts_mapping():
    """``tests/test_moe.py:63``: expert 0 is hottest; its replica is
    virtual expert 4 -> parent 0; non-hot assignments untouched; all of
    it equal to JAX's."""
    idx = np.asarray([[0, 1], [0, 2], [0, 3], [0, 1]])
    virt, parents = TMoE.replicate_hot_experts(torch.from_numpy(idx), None, num_experts=4,
                                               replicas=2, num_hot=1)
    jvirt, jparents = JMoE.replicate_hot_experts(jnp.asarray(idx), None, num_experts=4,
                                                 replicas=2, num_hot=1)
    assert parents.shape[0] == 5 and int(parents[4]) == 0
    assert set(virt[:, 0].tolist()) == {0, 4}
    assert torch.equal(virt[:, 1], torch.from_numpy(idx[:, 1]))
    assert np.array_equal(np.asarray(jvirt), virt.numpy())
    assert np.array_equal(np.asarray(jparents), parents.numpy())


@pytest.mark.parametrize("num_hot,replicas", [(1, 2), (2, 3), (3, 2)])
def test_replicate_hot_experts_ties(num_hot, replicas):
    """Equal counts: experts 1, 3 and 5 are each named 3 times, 0 and 2
    twice. ``jax.lax.top_k`` takes the lower index first among equal
    counts, and so must the port: the virtual idx and the parent map
    equal JAX's exactly."""
    idx = np.asarray([[1, 3], [5, 0], [1, 3], [5, 2], [1, 3], [5, 0], [2, 4]])
    virt, parents = TMoE.replicate_hot_experts(torch.from_numpy(idx), None, num_experts=6,
                                               replicas=replicas, num_hot=num_hot)
    jvirt, jparents = JMoE.replicate_hot_experts(jnp.asarray(idx), None, num_experts=6,
                                                 replicas=replicas, num_hot=num_hot)
    assert np.array_equal(np.asarray(jparents), parents.numpy())
    assert np.array_equal(np.asarray(jvirt), virt.numpy())
    assert parents[6:].tolist() == [1, 3, 5][:num_hot] * (replicas - 1)


@pytest.mark.parametrize("tie", [False, True])
def test_router_topk_and_load_balance_loss(tie):
    """Routing weights, indices and probabilities, and the Switch aux
    loss, against JAX. With ``tie`` the router has two equal columns, so
    every token's top-2 is a tie and the lower index must come first."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 6)) * 0.3).astype(np.float32)
    if tie:
        w[:, 4] = w[:, 1] = w[:, 1] * 5.0
    jw, jidx, jp = JMoE.router_topk(jnp.asarray(x), jnp.asarray(w), 2)
    tw, tidx, tp = TMoE.router_topk(torch.from_numpy(x), torch.from_numpy(w), 2)
    assert np.array_equal(np.asarray(jidx), tidx.numpy())
    if tie:
        assert (tidx[:, 0] == 1).sum() > 0 and not ((tidx[:, 0] == 4) & (tidx[:, 1] == 1)).any()
    _check(f"router weights tie={tie}, rel", _rel(jw, tw), F32_REL)
    _check(f"router probs tie={tie}, rel", _rel(jp, tp), F32_REL)
    _check(f"load_balance_loss tie={tie}, rel",
           _rel(JMoE.load_balance_loss(jp, jidx, 6), TMoE.load_balance_loss(tp, tidx, 6)),
           F32_REL)


@pytest.mark.parametrize("lo,e_local,cap", [(0, 8, 40), (0, 8, 13), (2, 3, 20), (5, 3, 7)])
def test_dispatch_compute_combine(setup, lo, e_local, cap):
    """One expert shard's dispatch (experts [lo, lo + e_local), as the
    JAX EP path calls it) at capacities with and without drops: the kept
    and is_mine masks exactly JAX's, y within the bf16 tolerance."""
    params, tparams, x, _, E, K = setup
    x2d = np.asarray(x).reshape(-1, x.shape[-1])
    jw, jidx, _ = JMoE.router_topk(jnp.asarray(x2d), params["router"], K)
    w_in, w_out = params["w_in"][lo:lo + e_local], params["w_out"][lo:lo + e_local]
    jy, jkeep, jmine = JMoE._dispatch_compute_combine(
        jnp.asarray(x2d), jw, jidx, lo=lo, e_local=e_local, cap=cap, w_in=w_in,
        w_out=w_out, activation=jax.nn.silu)
    ty, tkeep, tmine = TMoE._dispatch_compute_combine(
        torch.from_numpy(x2d), torch.from_numpy(np.asarray(jw)),
        torch.from_numpy(np.asarray(jidx)).long(), lo=lo, e_local=e_local, cap=cap,
        w_in=torch.from_numpy(np.asarray(w_in)), w_out=torch.from_numpy(np.asarray(w_out)),
        activation=F.silu)
    assert np.array_equal(np.asarray(jkeep), tkeep.numpy())
    assert np.array_equal(np.asarray(jmine), tmine.numpy())
    assert ty.dtype == torch.float32
    _check(f"dispatch lo={lo} e_local={e_local} cap={cap} y vs JAX, rel", _rel(jy, ty), BF16_REL)


def _jax_slots(flat_e, lo, e_local, cap):
    """``moe.py:79-85``'s slot formula in jnp: (is_mine, pos, keep, slot)."""
    flat_e = jnp.asarray(flat_e)
    is_mine = (flat_e >= lo) & (flat_e < lo + e_local)
    eff = jnp.where(is_mine, flat_e - lo, e_local)
    onehot = jax.nn.one_hot(eff, e_local + 1, dtype=jnp.int32)[:, :e_local]
    pos = (jnp.cumsum(onehot, axis=0) * onehot).sum(-1) - 1
    keep = is_mine & (pos < cap) & (pos >= 0)
    slot = jnp.where(keep, eff * cap + pos, e_local * cap)
    return is_mine, pos, keep, slot


def _routing(kind, t, k, e, seed=0):
    """(T*k,) experts in (token, k) order, k distinct a token: ``uniform``
    random scores, ``skewed`` Zipf-weighted scores (expert 0 hottest)."""
    rng = np.random.default_rng(seed)
    scores = rng.random((t, e))
    if kind == "skewed":
        scores = scores ** (1.0 / (np.arange(1, e + 1) ** -1.2))
    return np.argsort(-scores, axis=-1, kind="stable")[:, :k].reshape(-1)


@pytest.mark.parametrize("kind,t,k,e,lo,e_local,cap", [
    ("uniform", 256, 2, 8, 0, 8, 256),      # small, lossless
    ("skewed", 256, 2, 8, 0, 8, 256),
    ("skewed", 256, 2, 8, 0, 8, 7),         # capacity drops
    ("uniform", 256, 2, 8, 0, 8, 13),
    ("skewed", 256, 2, 8, 0, 8, 40),
    ("uniform", 256, 2, 8, 2, 3, 20),       # test_dispatch_compute_combine's EP shards
    ("skewed", 256, 2, 8, 5, 3, 7),
    ("uniform", 256, 2, 8, 8, 4, 13),       # every assignment in the trash bucket
    ("uniform", 7680, 10, 72, 0, 18, 7680),  # the rag cell's longest prefill, lossless
])
def test_slots_match_jax(kind, t, k, e, lo, e_local, cap):
    """``_slots`` (one flat scan of an expert-major one-hot) gives JAX's
    is_mine, position, kept mask and slot exactly, on routings with and
    without drops, on expert shards, and at the rag cell's T*k = 76,800
    over 18 held of 72 experts."""
    flat_e = _routing(kind, t, k, e)
    want = [np.asarray(v) for v in _jax_slots(flat_e, lo, e_local, cap)]
    got = TMoE._slots(torch.from_numpy(flat_e), lo=lo, e_local=e_local, cap=cap)
    for name, w, g in zip(("is_mine", "pos", "keep", "slot"), want, got):
        assert np.array_equal(w, g.numpy()), name
    if lo >= e:
        assert (want[1] == -1).all()
    print(f"[parity] slots {kind} T*k={t * k} lo={lo} e_local={e_local} cap={cap}: "
          f"kept {int(want[2].sum())} of {int(want[0].sum())} held, equal")


@pytest.mark.parametrize("t,k,e,cf", [(256, 2, 8, 1.25), (256, 2, 8, None), (7, 6, 64, 1.25),
                                      (3, 2, 4, 0.1)])
def test_capacity(t, k, e, cf):
    assert TMoE._capacity(t, k, e, cf) == JMoE._capacity(t, k, e, cf)


def test_moe_ffn_grads_vs_jax(setup):
    """The training path: grads of a loss through the MoE at capacity
    1.25 with respect to x and every expert weight, each within rel 4e-2
    by norm of ``jax.grad`` (``tests/test_models.py``'s model tolerance:
    bf16 products in the backward too)."""
    params, tparams, x, _, E, K = setup

    def jloss(p, xx):
        y, m = JMoE.moe_ffn(xx, p, num_experts=E, top_k=K, activation=jax.nn.silu)
        return jnp.sum(y.astype(jnp.float32) ** 2) + m.aux_loss

    jg = jax.grad(jloss, argnums=(0, 1))(params, x)
    tp = {k: v.clone().requires_grad_() for k, v in tparams.items()}
    tx = torch.from_numpy(np.asarray(x)).requires_grad_()
    y, m = TMoE.moe_ffn(tx, tp, num_experts=E, top_k=K, activation=F.silu)
    (y.float().pow(2).sum() + m.aux_loss).backward()
    for name in ("router", "w_in", "w_out"):
        j, t = _np(jg[0][name]), _np(tp[name].grad)
        _check(f"moe_ffn grad {name}, rel by norm",
               float(np.linalg.norm(j - t) / np.linalg.norm(j)), 4e-2)
    j, t = _np(jg[1]), _np(tx.grad)
    _check("moe_ffn grad x, rel by norm", float(np.linalg.norm(j - t) / np.linalg.norm(j)), 4e-2)
