"""The port's multi-device path on 8 gloo CPU ranks against the JAX
package's on 8 host devices, the same inputs and meshes as
``scripts/dist_checks.py``.

Two subprocesses, each with its own timeout: ``JAX_SCRIPT`` runs the JAX
functions under ``--xla_force_host_platform_device_count=8`` on inputs
made with numpy from a seed and writes them and the outputs to an
``.npz``; ``PORT_SCRIPT`` reads those inputs, runs the port on 8 ranks
(``repro_torch.parallel.ranks.spawn``: one process per mesh position,
gloo, a file rendezvous) and writes its outputs, assembled in global
order. The tests compare the two:

- all-gather (bidirectional and one-way rings): exact;
- hierarchical all-reduce: the port within 1e-5 of 8y and of JAX;
- compressed ring: the port within one int8 step of the final scale of
  JAX, and each within 0.02 (relative) of 2y;
- ``row_parallel`` under ``bf16_collectives`` at model 2 (the MLP and
  the attention-output forms): within one bf16 step of JAX's output, and
  its grads (of x and w, a seeded cotangent) within one bf16 step of
  ``jax.grad``'s through JAX's ``shard_map``;
- context-parallel decode: 1e-4 of JAX's and of the local decode; at
  the model level (reduced internlm2, ``decode_step`` with ``cp_axis``,
  the cache's rows split 4 ways, 3 teacher-forced steps) the logits
  within rel 4e-2 (``tests/test_models.py:59``) of JAX's CP decode and
  1e-5 of the port's one-rank decode, a scalar and a per-row position
  alike;
- expert-parallel MoE: 5e-2 of JAX's ``moe_ffn`` and of the dense
  oracle, dropped fraction 0, aux loss and expert load of JAX's (1e-5);
  its backward (x, router, w_in, w_out; a seeded cotangent of y and a
  weight of 4 on the aux loss, so that the load-balance term's grads
  show): each leaf within ``EP_GRAD_TOL`` of its largest |grad| of
  ``jax.grad``'s through JAX's ``shard_map``;
- a reduced granite-moe train step on (pod 2, data 2, model 2) under
  ``use_mesh`` (the EP branch, capacity None), with ``UserWarning`` an
  error (torch warns when it backprops through a collective with no
  autograd kernel): every rank's synced grads the same, within rel
  ``EP_STEP_TOL`` by norm of the one-rank step in 4 microbatches (each a
  mesh shard: the same objective) at an aux weight of 1, and of JAX's
  one-device step in 4 microbatches at granite's own;
- compressed pod sync on reduced internlm2 (bridged params, step 1):
  JAX's ``"compressed"`` against the port's, loss relative 1e-3 and
  params 5e-3, and the port's ``"auto"`` against its ``"compressed"`` at
  the same limits; every rank ends with the same params. The synced
  grads themselves (each side's step hands them to its wrapped
  ``adamw_update``), with a loss mask of ones and a ragged one whose
  shards' counts differ: the port's exact mean against its one-rank step
  on the whole batch (also in two microbatches) and against JAX's, its
  ring against JAX's, each leaf rel 4e-2 by norm; its ring against its
  exact mean within 2 int8 steps, the grad norm rel 1e-2;
- elastic reshard from ``best_mesh_for(8, model=2)`` to
  ``best_mesh_for(4, model=2)``: bit-equal.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 420       # seconds for each subprocess; the port's ranks get 300
# the pod sync's synced grads: "rel" each leaf's relative difference by
# norm where bf16 compute copies round at other places (the port against
# JAX, the mesh's 2-row shards against one rank's 8-row batch), the limit
# of every grad held to JAX's (REL of tests/test_torch_train.py); "int8"
# in int8 steps of a leaf's largest |grad|; "norm" the grad norm's
# relative difference
POD_SYNC_TOL = dict(rel=4e-2, int8=2.0, norm=1e-2)
# the EP backward against JAX's, in each leaf's largest |grad|: both
# round y to bf16 before its sum over model (a bf16 step is 2^-8 of a
# value) and round the bf16 expert products at other places, a few bf16
# steps in all (CPU 0.0018-0.0074); a grad that misses the other model
# rank's experts or takes a wrong share of the aux loss's is off by tenths
EP_GRAD_TOL = 2e-2
# the EP train step's worst leaf, rel by norm: against the port's own
# one-rank step of the same objective (bf16 roundings at other places,
# here 0.0092 at aux weight 1, where a wrong aux backward reads 0.6-0.74;
# on a reduced MoE a rounding that flips a near-tied route moves every
# grad by a few percent, so chip_smoke.py's 4-rank twin holds (d)'s 4e-2)
# and against JAX's (REL of tests/test_torch_zoo.py; CPU 0.016)
EP_STEP_TOL = dict(port=2e-2, jax=4e-2)

JAX_SCRIPT = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import RunConfig, get_config
from repro.core.collectives import (all_gather_bidirectional, all_reduce_compressed,
                                    all_reduce_hierarchical)
from repro.models import precision
from repro.models.attention import decode_attention, decode_attention_context_parallel
from repro.models.layers import row_parallel
from repro.models.moe import moe_ffn, moe_ffn_dense_ref
from repro.models.params import init_params
from repro.optim.adamw import adamw_init
from repro.train.train_step import make_train_step

assert len(jax.devices()) == 8
rng = np.random.default_rng(0)
rng1 = np.random.default_rng(1)     # the backward's inputs: rng's sequence stays
out = {}
AUTO = (jax.sharding.AxisType.Auto,)


def mesh(shape, names):
    return jax.make_mesh(shape, names, axis_types=AUTO * len(names))


# collectives, dist_checks.py:24-42
m = mesh((2, 4), ("pod", "data"))
out["x"] = x = rng.standard_normal((16, 8)).astype(np.float32)
out["y"] = y = rng.standard_normal((12, 5)).astype(np.float32)
with jax.set_mesh(m):
    xs = jax.device_put(x, NamedSharding(m, P("data", None)))
    out["ag"] = np.asarray(jax.jit(lambda a: all_gather_bidirectional(a, m, "data"))(xs))
    out["hier"] = np.asarray(jax.jit(lambda a: all_reduce_hierarchical(a, m, "data", "pod"))(y))
    out["comp"] = np.asarray(jax.jit(lambda a: all_reduce_compressed(a, m, "pod"))(y))

# row_parallel under bf16 collectives at model 2
m = mesh((4, 2), ("data", "model"))
out["rp_h"] = rng.standard_normal((2, 8, 64)).astype(np.float32)
out["rp_w"] = (rng.standard_normal((64, 32)) * 0.1).astype(np.float32)
out["rp_o"] = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
out["rp_wo"] = (rng.standard_normal((4, 16, 32)) * 0.1).astype(np.float32)
with jax.set_mesh(m), precision.bf16_collectives():
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    f = jax.jit(lambda a, b: row_parallel("bsf,fd->bsd", a, b, x_shard_dim=2, w_shard_dim=0))
    out["rp_mlp"] = np.asarray(f(bf(out["rp_h"]), bf(out["rp_w"])).astype(jnp.float32))
    f = jax.jit(lambda a, b: row_parallel("bshk,hkd->bsd", a, b, x_shard_dim=2, w_shard_dim=0))
    out["rp_attn"] = np.asarray(f(bf(out["rp_o"]), bf(out["rp_wo"])).astype(jnp.float32))
    # the backward through shard_map: grads of sum(y * ct)
    out["rp_ct"] = ct = rng1.standard_normal((2, 8, 32)).astype(np.float32)
    for form, sub, xa, wa in (("rp_mlp", "bsf,fd->bsd", "rp_h", "rp_w"),
                              ("rp_attn", "bshk,hkd->bsd", "rp_o", "rp_wo")):
        g = jax.jit(jax.grad(lambda a, b, sub=sub: jnp.sum(row_parallel(
            sub, a, b, x_shard_dim=2, w_shard_dim=0).astype(jnp.float32) * ct), argnums=(0, 1)))
        gx, gw = g(bf(out[xa]), bf(out[wa]))
        out[form + "_gx"] = np.asarray(gx.astype(jnp.float32))
        out[form + "_gw"] = np.asarray(gw.astype(jnp.float32))

# context-parallel decode, dist_checks.py:72-92
m = mesh((2, 4), ("data", "model"))
out["cp_q"] = q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
out["cp_k"] = kc = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
out["cp_v"] = vc = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
out["cp_ref"] = np.asarray(decode_attention(q, kc, vc, jnp.asarray(40)))
with jax.set_mesh(m):
    qs = jax.device_put(q, NamedSharding(m, P("data", None, None, None)))
    kcs = jax.device_put(kc, NamedSharding(m, P("data", "model", None, None)))
    vcs = jax.device_put(vc, NamedSharding(m, P("data", "model", None, None)))
    out["cp"] = np.asarray(jax.jit(lambda a, b, c: decode_attention_context_parallel(
        a, b, c, jnp.asarray(40), mesh=m, axis="model", batch_axes=("data",)))(qs, kcs, vcs))

# expert-parallel MoE, dist_checks.py:45-69
m = mesh((2, 2, 2), ("pod", "data", "model"))
B, S, D, E, K, F = 4, 8, 32, 8, 2, 64
out["moe_x"] = xm = (rng.standard_normal((B, S, D)) * 0.5).astype(np.float32)
out["moe_router"] = (rng.standard_normal((D, E)) * 0.02).astype(np.float32)
out["moe_w_in"] = (rng.standard_normal((E, D, 2, F)) * 0.05).astype(np.float32)
out["moe_w_out"] = (rng.standard_normal((E, F, D)) * 0.05).astype(np.float32)
params = {k: jnp.asarray(out["moe_" + k]) for k in ("router", "w_in", "w_out")}
out["moe_dense"] = np.asarray(moe_ffn_dense_ref(jnp.asarray(xm), params, num_experts=E,
                                                top_k=K, activation=jax.nn.silu))
with jax.set_mesh(m):
    xs = jax.device_put(xm, NamedSharding(m, P(("pod", "data"), None, None)))
    ps = {"router": jax.device_put(params["router"], NamedSharding(m, P("data", None))),
          "w_in": jax.device_put(params["w_in"], NamedSharding(m, P("model", "data", None, None))),
          "w_out": jax.device_put(params["w_out"], NamedSharding(m, P("model", None, "data")))}
    y, mt = jax.jit(lambda a, b: moe_ffn(a, b, num_experts=E, top_k=K, activation=jax.nn.silu,
                                         capacity_factor=None))(xs, ps)
    # the backward: grads of sum(y * ct) + 4 aux_loss w.r.t. x and the weights
    out["moe_ct"] = ct = rng1.standard_normal((B, S, D)).astype(np.float32)

    def moe_obj(a, p):
        yy, mm = moe_ffn(a, p, num_experts=E, top_k=K, activation=jax.nn.silu,
                         capacity_factor=None)
        return jnp.sum(yy.astype(jnp.float32) * ct) + 4.0 * mm.aux_loss
    gx, gp = jax.jit(jax.grad(moe_obj, argnums=(0, 1)))(xs, ps)
out["moe_y"] = np.asarray(y, np.float32)
out["moe_dropped"] = np.asarray(mt.dropped_frac)
out["moe_aux"] = np.asarray(mt.aux_loss)
out["moe_load"] = np.asarray(mt.expert_load)
out["moe_g_x"] = np.asarray(gx)
for k in ("router", "w_in", "w_out"):
    out["moe_g_" + k] = np.asarray(gp[k])

# compressed pod sync, dist_checks.py:95-126, at step 1 (step 0's lr is 0).
# The step's synced grads come out in its metrics: the optimizer that the
# step calls is wrapped here (no file of the JAX package changes).
import repro.train.train_step as JT
_adamw = JT.adamw_update


def _adamw_keeping_grads(grads, *a, **k):
    p2, o2, om = _adamw(grads, *a, **k)
    return p2, o2, dict(om, grads=grads)


JT.adamw_update = _adamw_keeping_grads
cfg = get_config("internlm2-1.8b").reduced()
m = mesh((2, 2, 2), ("pod", "data", "model"))
params, _ = init_params(cfg, jax.random.PRNGKey(0))
b, s = 8, 32
tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
out["ps_tokens"] = tokens
for i, leaf in enumerate(jax.tree.leaves(params)):
    out[f"ps_p0_{i}"] = np.asarray(leaf)
# "ragged": each row's loss covers a prefix of its own length, so the
# shards' mask counts differ
out["ps_mask_ones"] = np.ones((b, s), np.float32)
out["ps_mask_ragged"] = (np.arange(s)[None] < rng.integers(1, s + 1, (b, 1))).astype(np.float32)
for mask in ("ones", "ragged"):
    batch = {"tokens": tokens, "labels": tokens, "loss_mask": out[f"ps_mask_{mask}"]}
    for mode in ("auto", "compressed"):
        with jax.set_mesh(m):
            run = RunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, pod_sync=mode)
            step = jax.jit(make_train_step(cfg, run, impl="ref", mesh=m))
            bput = {k: jax.device_put(jnp.asarray(v), NamedSharding(m, P(("pod", "data"),)))
                    for k, v in batch.items()}
            p2, _, met = step(params, adamw_init(params), bput, jnp.asarray(1))
        out[f"ps_{mask}_{mode}_loss"] = np.asarray(met["loss"])
        out[f"ps_{mask}_{mode}_grad_norm"] = np.asarray(met["grad_norm"])
        for i, g in enumerate(jax.tree.leaves(met["grads"])):
            out[f"ps_{mask}_{mode}_g{i}"] = np.asarray(g, np.float32)
        if (mask, mode) == ("ones", "compressed"):
            out["ps_loss"] = out[f"ps_{mask}_{mode}_loss"]
            out["ps_grad_norm"] = out[f"ps_{mask}_{mode}_grad_norm"]
            for i, leaf in enumerate(jax.tree.leaves(p2)):
                out[f"ps_p1_{i}"] = np.asarray(leaf)

# reduced granite-moe, one step on one device in 4 microbatches (the
# objective of the port's step on (pod 2, data 2, model 2)), capacity None
gcfg = get_config("granite-moe-1b-a400m").reduced()
gparams, _ = init_params(gcfg, jax.random.PRNGKey(1))
for i, leaf in enumerate(jax.tree.leaves(gparams)):
    out[f"ep_p0_{i}"] = np.asarray(leaf)
out["ep_tokens"] = gtok = rng1.integers(0, gcfg.vocab_size, (8, 32)).astype(np.int32)
run = RunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, microbatch=4)
_, _, met = jax.jit(make_train_step(gcfg, run, impl="ref", capacity_factor=None))(
    gparams, adamw_init(gparams), {"tokens": gtok, "labels": gtok,
                                   "loss_mask": np.ones(gtok.shape, np.float32)},
    jnp.asarray(1))
out["ep_jax_loss"] = np.asarray(met["loss"])
for i, g in enumerate(jax.tree.leaves(met["grads"])):
    out[f"ep_jax_g{i}"] = np.asarray(g, np.float32)
JT.adamw_update = _adamw

# the launcher's sharded train state on (pod 2, data 2, model 2): JAX's
# build (param_shardings, _opt_logical, jit with in/out shardings) from
# PRNGKey(0) (the "ps" params), each device's shards (shape, index), one
# step at step 1 on the ps batch, and the one-device step's grads
import json
from repro.configs.base import ShapeConfig
from repro.launch import train as JL
m = mesh((2, 2, 2), ("pod", "data", "model"))
order = list(np.asarray(m.devices).reshape(-1))          # mesh order = the port's ranks
sh_batch = {"tokens": tokens, "labels": tokens, "loss_mask": np.ones((b, s), np.float32)}
JT.adamw_update = _adamw_keeping_grads
for mom in ("f32", "int8"):
    run = RunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                    moments_int8=mom == "int8")
    ps_, os_, step, put = JL.build(cfg, run, ShapeConfig("sh", s, b, "train"), m, impl="ref")
    assert np.array_equal(np.asarray(jax.tree.leaves(ps_)[0]), out["ps_p0_0"])
    out[f"sh_{mom}_whole_bytes"] = np.asarray(sum(
        leaf.nbytes for leaf in jax.tree.leaves((ps_, os_.m, os_.v))))
    for r, d in enumerate(order):
        held = [(leaf.shape, next(x for x in leaf.addressable_shards if x.device == d))
                for leaf in jax.tree.leaves((ps_, os_.m, os_.v))]
        out[f"sh_{mom}_held_{r}"] = np.array(json.dumps(
            [[list(x.data.shape), x.data.dtype.itemsize,
              [[sl.start or 0, n if sl.stop is None else sl.stop]
               for sl, n in zip(x.index, whole)]] for whole, x in held]))
    with jax.set_mesh(m):
        p2, _, met = step(ps_, os_, put(sh_batch), jnp.asarray(1))
    out[f"sh_{mom}_loss"] = np.asarray(met["loss"])
    for r, d in enumerate(order):
        for i, leaf in enumerate(jax.tree.leaves(p2)):
            out[f"sh_{mom}_p1_{r}_{i}"] = np.asarray(
                next(x for x in leaf.addressable_shards if x.device == d).data)
run = RunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
_, _, met = jax.jit(make_train_step(cfg, run, impl="ref"))(params, adamw_init(params), sh_batch,
                                                          jnp.asarray(1))
for i, g in enumerate(jax.tree.leaves(met["grads"])):
    out[f"sh_one_g{i}"] = np.asarray(g, np.float32)
JT.adamw_update = _adamw

# model-level context-parallel decode on (data 4, model 2)
from repro.models import model as JM
m = mesh((4, 2), ("data", "model"))
out["cpm_prompt"] = prompt = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
out["cpm_forced"] = forced = rng.integers(0, cfg.vocab_size, (3, 2)).astype(np.int32)
_, cache, npos = JM.prefill(cfg, params, jnp.asarray(prompt), 64, impl="ref")
with jax.set_mesh(m):
    cache = jax.tree.map(lambda c: jax.device_put(
        c, NamedSharding(m, P(None, None, "data", None, None))), cache)
    dstep = jax.jit(lambda p, tk, c, pos: JM.decode_step(cfg, p, tk, c, pos, cp_axis="data",
                                                         mesh=m))
    logits = []
    for i in range(3):
        lg, cache = dstep(params, jnp.asarray(forced[i][:, None]), cache,
                          jnp.asarray(int(npos) + i, jnp.int32))
        logits.append(np.asarray(lg))
out["cpm_logits"] = np.stack(logits)
np.savez(sys.argv[1], **out)
print("JAX DONE")
'''

PORT_SCRIPT = r'''
import dataclasses
import json
import sys
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.bridge import params_from_numpy
from repro_torch.ckpt.checkpoint import CheckpointManager, _named_leaves
from repro_torch.configs import RunConfig, get_config
from repro_torch.core import collectives as C
from repro_torch.ft.elastic import best_mesh_for, make_mesh, reshard
from repro_torch.models import precision
from repro_torch.models import model as TM
from repro_torch.models.attention import decode_attention_context_parallel
from repro_torch.models.layers import row_parallel
from repro_torch.models.moe import moe_ffn
from repro_torch.launch.inputs import train_layout
from repro_torch.launch.train import build, place_state
from repro_torch.models.params import _logical_only, abstract_params, init_params
from repro_torch.optim.adamw import (abstract_state, adamw_init, adamw_update, opt_logical,
                                     tree_leaves, tree_unflatten)
from repro_torch.parallel import ranks
from repro_torch.parallel.sharding import (Mesh, block_of, full_tensor, gather, local_shard,
                                           place, use_mesh)
from repro_torch.train import train_step as TS
from repro_torch.train.train_step import make_train_step


def t(a):
    return torch.from_numpy(np.asarray(a))


def body(rank, world, inp):
    res = {}
    # collectives on (pod 2, data 4)
    m = Mesh((2, 4), ("pod", "data"), device="cpu")
    xs = local_shard(t(inp["x"]), m, ("data", None))
    res["ag"] = C.all_gather_bidirectional(xs, m, "data").numpy()
    res["ag1"] = C.ring_all_gather(xs, m.get_group("data"), bidirectional=False).numpy()
    res["hier"] = C.all_reduce_hierarchical(t(inp["y"]), m, "data", "pod").numpy()
    res["comp"] = C.all_reduce_compressed(t(inp["y"]), m, "pod").numpy()
    res["rs"] = C.ring_reduce_scatter(t(inp["x"]), m.get_group("data")).numpy()

    # row_parallel on (data 4, model 2)
    m = Mesh((4, 2), ("data", "model"), device="cpu")
    bf = lambda a: t(a).to(torch.bfloat16)
    with use_mesh(m), precision.bf16_collectives():
        res["rp_mlp"] = row_parallel(bf(inp["rp_h"]), bf(inp["rp_w"]), 2).float().numpy()
        res["rp_attn"] = row_parallel(bf(inp["rp_o"]), bf(inp["rp_wo"]), 2).float().numpy()
        for form, xa, wa in (("rp_mlp", "rp_h", "rp_w"), ("rp_attn", "rp_o", "rp_wo")):
            xg, wg = bf(inp[xa]).requires_grad_(), bf(inp[wa]).requires_grad_()
            obj = (row_parallel(xg, wg, 2).float() * t(inp["rp_ct"])).sum()
            gx, gw = torch.autograd.grad(obj, [xg, wg])
            res[form + "_gx"], res[form + "_gw"] = gx.float().numpy(), gw.float().numpy()

    # context-parallel decode on (data 2, model 4): the cache on (data, model)
    m = Mesh((2, 4), ("data", "model"), device="cpu")
    q = local_shard(t(inp["cp_q"]), m, ("data", None, None, None))
    kc = local_shard(t(inp["cp_k"]), m, ("data", "model", None, None))
    vc = local_shard(t(inp["cp_v"]), m, ("data", "model", None, None))
    res["cp"] = decode_attention_context_parallel(q, kc, vc, torch.tensor(40), mesh=m,
                                                  axis="model").numpy()
    res["cp_row"] = m.index("data")

    # expert-parallel MoE on (pod 2, data 2, model 2), the weights' shards
    m = Mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    x = local_shard(t(inp["moe_x"]), m, (("pod", "data"), None, None))
    params = {"router": local_shard(t(inp["moe_router"]), m, ("data", None)),
              "w_in": local_shard(t(inp["moe_w_in"]), m, ("model", "data", None, None)),
              "w_out": local_shard(t(inp["moe_w_out"]), m, ("model", None, "data"))}
    with use_mesh(m):
        y, mt = moe_ffn(x, params, num_experts=8, top_k=2, activation=F.silu,
                        capacity_factor=None)
    res["moe_y"] = y.float().numpy()
    res["moe_row"] = m.index("pod") * 2 + m.index("data")
    res["moe_dropped"] = float(mt.dropped_frac)
    res["moe_aux"] = float(mt.aux_loss)
    res["moe_load"] = mt.expert_load.numpy()
    # its backward: each rank's objective is its share of sum(y * ct) and
    # the aux term whole; a weight shard's grad is summed over pod, where
    # it is replicated (JAX's in-spec), then each leaf is gathered whole
    leaves = [x.requires_grad_()] + [params[k].requires_grad_()
                                     for k in ("router", "w_in", "w_out")]
    with use_mesh(m):
        y, mt = moe_ffn(x, params, num_experts=8, top_k=2, activation=F.silu,
                        capacity_factor=None)
    ct = local_shard(t(inp["moe_ct"]), m, (("pod", "data"), None, None))
    gx, gr, gi, go = torch.autograd.grad((y.float() * ct).sum() + 4.0 * mt.aux_loss, leaves)
    dg, mg, pg = (m.get_group(a) for a in ("data", "model", "pod"))
    gr, gi, go = (C.all_reduce(g, pg) for g in (gr, gi, go))
    res["moe_g_x"] = C.all_gather(C.all_gather(gx, dg, 0), pg, 0).numpy()
    res["moe_g_router"] = C.all_gather(gr, dg, 0).numpy()
    res["moe_g_w_in"] = C.all_gather(C.all_gather(gi, dg, 1), mg, 0).numpy()
    res["moe_g_w_out"] = C.all_gather(C.all_gather(go, dg, 2), mg, 0).numpy()

    # reduced granite-moe's train step on the mesh (the EP branch), with
    # UserWarning an error, at granite's aux weight and at 1; and the one-
    # rank step in 4 microbatches, each a mesh shard, at 1
    gcfg = get_config("granite-moe-1b-a400m").reduced()
    like = init_params(gcfg, torch.Generator().manual_seed(0), "cpu")
    g0 = tree_unflatten(like, [t(inp[f"ep_p0_{i}"]) for i in range(len(tree_leaves(like)))])
    gtok = t(inp["ep_tokens"]).long()
    gbatch = {"tokens": gtok, "labels": gtok, "loss_mask": torch.ones(gtok.shape)}
    kept = []

    def adamw_keeping_grads(grads, *a, **k):
        kept.append([g.clone() for g in tree_leaves(grads)])
        return adamw_update(grads, *a, **k)

    TS.adamw_update = adamw_keeping_grads
    aux1 = dataclasses.replace(gcfg, router_aux_loss=1.0)
    for key, cfg_, mm, mb in (("ep_mesh", gcfg, m, 0), ("ep_mesh_aux1", aux1, m, 0),
                              ("ep_mb4_aux1", aux1, None, 4)):
        run = RunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, microbatch=mb)
        own = tree_unflatten(g0, [p.clone() for p in tree_leaves(g0)])
        with warnings.catch_warnings(), use_mesh(mm):
            warnings.simplefilter("error", UserWarning)
            own, _, met = make_train_step(cfg_, run, mesh=mm, capacity_factor=None)(
                own, adamw_init(own), gbatch, 1)
        if key == "ep_mesh":
            ep_whole = own
        res[f"{key}_loss"] = float(met["loss"])
        res[f"{key}_grads"] = [g.numpy() for g in kept.pop()]
    TS.adamw_update = adamw_update

    # pod sync on (pod 2, data 2, model 2), reduced internlm2 from JAX's
    # params; the synced grads kept by wrapping the step's optimizer
    cfg = get_config("internlm2-1.8b").reduced()
    like = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p0 = tree_unflatten(like, [t(inp[f"ps_p0_{i}"]) for i in range(len(tree_leaves(like)))])
    tok = t(inp["ps_tokens"]).long()
    kept = []

    def adamw_keeping_grads(grads, *a, **k):
        kept.append([g.clone() for g in tree_leaves(grads)])
        return adamw_update(grads, *a, **k)

    TS.adamw_update = adamw_keeping_grads
    # "one_rank": the step with no mesh on the whole batch, the exact mean;
    # "mb2": two microbatches, on the mesh and on one rank
    runs = (("auto", m, 0), ("compressed", m, 0), ("one_rank", None, 0),
            ("auto_mb2", m, 2), ("one_rank_mb2", None, 2))
    for mask in ("ones", "ragged"):
        batch = {"tokens": tok, "labels": tok, "loss_mask": t(inp[f"ps_mask_{mask}"])}
        for mode, mm, mb in runs:
            run = RunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, microbatch=mb,
                            pod_sync="compressed" if mode == "compressed" else "auto")
            own = tree_unflatten(p0, [p.clone() for p in tree_leaves(p0)])
            own, _, met = make_train_step(cfg, run, mesh=mm)(own, adamw_init(own), batch, 1)
            key = f"ps_{mode}" if mask == "ones" else f"ps_{mask}_{mode}"
            res[f"{key}_loss"] = float(met["loss"])
            res[f"{key}_grad_norm"] = float(met["grad_norm"])
            res[f"{key}_grads"] = [g.numpy() for g in kept.pop()]
            if mask == "ones" and mode in ("auto", "compressed"):
                res[f"ps_{mode}"] = [p.numpy() for p in tree_leaves(own)]
    TS.adamw_update = adamw_update

    # the sharded train state on (pod 2, data 2, model 2), as the launcher
    # holds it: each rank's blocks (shape, bytes, where in the whole leaf)
    # of build's state; one step from JAX's params, against JAX's and the
    # whole-weight step's ("auto" above; granite's "ep_mesh"); the optimizer
    # on blocks against the whole one with the same grads
    named = lambda tree: [x for _, x in _named_leaves(tree)]  # noqa: E731

    def equal(a, b):
        return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                   for x, y in zip(named(a), named(b)))
    batch = {"tokens": tok, "labels": tok, "loss_mask": torch.ones(tok.shape)}

    def slices(tree, lay, mm):
        out = []
        for x, bs in zip(named(tree), named(lay)):
            spec = bs.spec if bs.is_block(x) else (None,) * len(bs.shape)
            out.append([[block_of(mm, e)[1] * n, (block_of(mm, e)[1] + 1) * n]
                        for e, n in zip(spec, x.shape)])
        return out

    for mom in ("f32", "int8"):
        run = RunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                        moments_int8=mom == "int8")
        bp, bo, _ = build(cfg, run, "cpu", m)
        lay = train_layout(cfg, m, mom)
        held = (bp, bo.m, bo.v)
        res[f"sh_{mom}_held"] = [[list(x.shape), x.element_size(), sl] for x, sl in zip(
            named(held), slices(held, (lay[0], lay[1].m, lay[1].v), m))]
        bp, bo = place_state(cfg, run, tree_unflatten(p0, [p.clone() for p in tree_leaves(p0)]), m)
        TS.adamw_update = adamw_keeping_grads
        bp, bo, met = make_train_step(cfg, run, mesh=m)(bp, bo, batch, 1)
        TS.adamw_update = adamw_update
        res[f"sh_{mom}_loss"] = float(met["loss"])
        res[f"sh_{mom}_grad_norm"] = float(met["grad_norm"])
        res[f"sh_{mom}_p1"] = [p.numpy() for p in tree_leaves(bp)]
        res[f"sh_{mom}_g"] = [g.numpy() for g in kept.pop()]
        res["sh_slices"] = slices(bp, lay[0], m)
        # against the whole-weight step on these ranks: its params cut to the blocks
        whole = tree_unflatten(p0, [t(a) for a in res["ps_auto"]])
        res[f"sh_{mom}_vs_whole"] = [p.numpy() for p in tree_leaves(place(whole, lay[0], m))]
        if mom == "int8":
            st8 = (bp, bo)
    # granite-moe (the EP MoE on blocks) against its whole-weight step
    run = RunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    bp, bo = place_state(gcfg, run, tree_unflatten(g0, [p.clone() for p in tree_leaves(g0)]), m)
    TS.adamw_update = adamw_keeping_grads
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        bp, _, met = make_train_step(gcfg, run, mesh=m, capacity_factor=None)(bp, bo, gbatch, 1)
    TS.adamw_update = adamw_update
    glay = train_layout(gcfg, m)
    res["sh_ep_loss"] = float(met["loss"])
    res["sh_ep_p1"] = [p.numpy() for p in tree_leaves(bp)]
    res["sh_ep_whole_p1"] = [p.numpy() for p in tree_leaves(place(ep_whole, glay[0], m))]
    res["sh_ep_g"] = [g.numpy() for g in kept.pop()]
    res["sh_ep_whole_g"] = [g.numpy() for g in tree_leaves(
        place(tree_unflatten(g0, [t(a) for a in res["ep_mesh_grads"]]), glay[0], m))]
    res["sh_ep_slices"] = slices(bp, glay[0], m)

    # reduced mamba2 (the SSM mixer on blocks) against its whole-weight step
    scfg = get_config("mamba2-2.7b").reduced()
    s0 = init_params(scfg, torch.Generator().manual_seed(2), "cpu")
    slay = train_layout(scfg, m)
    run = RunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    TS.adamw_update = adamw_keeping_grads
    for key, tree in (("whole", tree_unflatten(s0, [p.clone() for p in tree_leaves(s0)])),
                      ("blocks", place(s0, slay[0], m))):
        opt = (adamw_init(tree) if key == "whole"
               else place(adamw_init(s0), slay[1], m))
        own, _, met = make_train_step(scfg, run, mesh=m)(tree, opt, batch, 1)
        g = kept.pop()
        if key == "whole":
            own = place(own, slay[0], m)
            g = tree_leaves(place(tree_unflatten(s0, g), slay[0], m))
            res["sh_ssm_whole_loss"] = float(met["loss"])
        else:
            res["sh_ssm_loss"] = float(met["loss"])
        res[f"sh_ssm_{'p1' if key == 'blocks' else 'whole_p1'}"] = [
            p.numpy() for p in tree_leaves(own)]
        res[f"sh_ssm_{'g' if key == 'blocks' else 'whole_g'}"] = [x.numpy() for x in g]
    TS.adamw_update = adamw_update

    # AdamW on blocks against AdamW on the whole tree, the same grads, three
    # steps: bit-equal without clipping; with it, the grad norm (summed in
    # another order) within an f32 rounding
    for mom in ("f32", "int8"):
        run = RunConfig(moments_int8=mom == "int8")
        lay = train_layout(cfg, m, mom)
        for clip in (0.0, 1.0):
            wp = tree_unflatten(p0, [p.clone() for p in tree_leaves(p0)])
            wo = adamw_init(wp, moments=mom)
            bp, bo = place_state(cfg, run, tree_unflatten(p0, [p.clone() for p in tree_leaves(p0)]), m)
            gen = torch.Generator().manual_seed(5)
            for _ in range(3):
                g = tree_unflatten(p0, [torch.randn(p.shape, generator=gen) * 0.01
                                        for p in tree_leaves(p0)])
                wp, wo, mw = adamw_update(g, wo, wp, lr=1e-3, moments=mom, grad_clip=clip)
                bp, bo, mb = adamw_update(place(g, lay[0], m), bo, bp, lr=1e-3, moments=mom,
                                          grad_clip=clip, mesh=m, layout=lay)
            same = equal(gather((bp, bo), lay, m), (wp, wo))
            res[f"sh_adamw_{mom}_{clip}"] = [same, float(mw["grad_norm"]), float(mb["grad_norm"])]

    # reshard (pod 2, data 2, model 2) -> best_mesh_for(4, model=2) of the
    # int8 state after its step, and a checkpoint saved from (data 2, model 2)
    # on ranks 0-3 restored onto (data 2, model 1) on ranks 0-1: each bit-
    # equal to the whole state cut to the new mesh
    lay8 = train_layout(cfg, m, "int8")
    whole = gather(st8, lay8, m)
    _, logical = _logical_only(cfg)
    like = (abstract_params(cfg)[0], abstract_state(abstract_params(cfg)[0], moments="int8"))
    lg = (logical, opt_logical(logical, True))
    m4 = make_mesh(*best_mesh_for(4, model=2), device="cpu")
    moved = reshard(st8, lg, m4, old_mesh=m, like=like)
    res["sh_reshard"] = (equal(moved, place(whole, train_layout(cfg, m4, "int8"), m4))
                         if m4.member else all(x is None for x in named(moved)))
    ma = Mesh((2, 2), ("data", "model"), device="cpu")
    mb_ = Mesh((2, 1), ("data", "model"), device="cpu")
    lay_a, lay_b = train_layout(cfg, ma, "int8"), train_layout(cfg, mb_, "int8")
    if ma.member:
        mgr = CheckpointManager("sharded_ckpt", every=1, write=rank == 0, mesh=ma, layout=lay_a)
        mgr.save(1, place(whole, lay_a, ma), blocking=True)
    torch.distributed.barrier()
    if mb_.member:
        want = place(whole, lay_b, mb_)
        got, k = CheckpointManager("sharded_ckpt", mesh=mb_, layout=lay_b).restore(want)
        res["sh_ckpt"] = k == 1 and equal(got, want)
        res["sh_ckpt_local"] = sum(x.numel() for x in named(got) if isinstance(x, torch.Tensor))
    torch.distributed.barrier()

    # model-level context-parallel decode on (data 4, model 2)
    m = Mesh((4, 2), ("data", "model"), device="cpu")
    prompt, forced = t(inp["cpm_prompt"]).long(), t(inp["cpm_forced"]).long()
    with torch.no_grad():
        _, cache, npos = TM.prefill(cfg, p0, prompt, 64)
        for name, pos in (("scalar", lambda i: torch.tensor(npos + i)),
                          ("rows", lambda i: torch.full((2,), npos + i))):
            local = TM.shard_cache(cfg, cache, m, "data")
            steps = []
            for i in range(3):
                lg, local = TM.decode_step(cfg, p0, forced[i][:, None], local, pos(i),
                                           cp_axis="data", mesh=m)
                steps.append(lg.numpy())
            res[f"cpm_{name}"] = np.stack(steps)
        steps = []
        for i in range(3):
            lg, cache = TM.decode_step(cfg, p0, forced[i][:, None], cache, torch.tensor(npos + i))
            steps.append(lg.numpy())
        res["cpm_one"] = np.stack(steps)

    # elastic reshard: 8 -> 4 ranks, bit-equal
    _, logical = _logical_only(cfg)
    m8 = make_mesh(*best_mesh_for(8, model=2), device="cpu")
    p8 = reshard(p0, logical, m8)
    m4 = make_mesh(*best_mesh_for(4, model=2), device="cpu")
    p4 = reshard(p8, logical, m4)
    res["m8"], res["m4"] = m8.shape, m4.shape
    if m4.member:
        res["reshard_equal"] = all(
            torch.equal(full_tensor(a), b) for a, b in zip(tree_leaves(p4), tree_leaves(p0)))
        res["reshard_local"] = sum(a.to_local().numel() for a in tree_leaves(p4))
    else:
        res["reshard_equal"] = all(a is None for a in tree_leaves(p4))
    res["staged_bytes"] = C.host_staged.bytes
    return res


if __name__ == "__main__":
    inp = dict(np.load(sys.argv[1]))
    got = ranks.spawn(body, 8, inp, timeout=300)
    out = {"ag": got[0]["ag"], "hier": got[0]["hier"], "comp": got[0]["comp"],
           "rp_mlp": got[0]["rp_mlp"], "rp_attn": got[0]["rp_attn"]}
    out["ag_all"] = np.stack([g["ag"] for g in got] + [g["ag1"] for g in got])
    out["hier_all"] = np.stack([g["hier"] for g in got])
    out["comp_all"] = np.stack([g["comp"] for g in got])
    out["rs"] = np.stack([g["rs"] for g in got])
    out["rp_all"] = np.stack([np.concatenate([g["rp_mlp"].ravel(), g["rp_attn"].ravel()])
                              for g in got])
    out["cp"] = np.concatenate([next(g["cp"] for g in got if g["cp_row"] == r) for r in (0, 1)])
    out["cp_all"] = np.stack([g["cp"] for g in got])
    out["moe_y"] = np.concatenate([next(g["moe_y"] for g in got if g["moe_row"] == r)
                                   for r in range(4)])
    for k in ("moe_dropped", "moe_aux"):
        out[k] = np.array([g[k] for g in got])
    out["moe_load"] = np.stack([g["moe_load"] for g in got])
    for k in [k for k in got[0] if k.startswith(("moe_g_", "rp_m", "rp_a")) and "_g" in k]:
        out[k] = got[0][k]
        out[k + "_same"] = all(np.array_equal(g[k], got[0][k]) for g in got)
    for key in ("ep_mesh", "ep_mesh_aux1", "ep_mb4_aux1"):
        out[f"{key}_loss"] = np.array([g[f"{key}_loss"] for g in got])
        for i, leaf in enumerate(got[0][f"{key}_grads"]):
            out[f"{key}_g{i}"] = leaf
            out[f"{key}_g{i}_same"] = all(np.array_equal(g[f"{key}_grads"][i], leaf)
                                         for g in got)
    for key in [k[:-5] for k in got[0] if k.startswith("ps_") and k.endswith("_loss")]:
        out[f"{key}_loss"] = np.array([g[f"{key}_loss"] for g in got])
        out[f"{key}_grad_norm"] = np.array([g[f"{key}_grad_norm"] for g in got])
        for i, leaf in enumerate(got[0][f"{key}_grads"]):
            out[f"{key}_g{i}"] = leaf
            out[f"{key}_g{i}_same"] = all(np.array_equal(g[f"{key}_grads"][i], leaf)
                                         for g in got)
    for mode in ("auto", "compressed"):
        for i, leaf in enumerate(got[0][f"ps_{mode}"]):
            out[f"ps_{mode}_{i}"] = leaf
            out[f"ps_{mode}_{i}_same"] = all(np.array_equal(g[f"ps_{mode}"][i], leaf)
                                            for g in got)
    for k in ("sh_f32_held", "sh_int8_held", "sh_slices", "sh_ep_slices"):
        out[k] = np.array([json.dumps(g[k]) for g in got])
    out["sh_ssm_whole_loss"] = np.array([g["sh_ssm_whole_loss"] for g in got])
    for key in ("sh_f32", "sh_int8", "sh_ep", "sh_ssm"):
        out[f"{key}_loss"] = np.array([g[f"{key}_loss"] for g in got])
        for part in ("p1", "g", "vs_whole", "whole_p1", "whole_g"):
            for r, g in enumerate(got):
                for i, a in enumerate(g.get(f"{key}_{part}", [])):
                    out[f"{key}_{part}_{r}_{i}"] = a
    for k in [k for k in got[0] if k.startswith("sh_adamw_")]:
        out[k] = np.array([g[k] for g in got], dtype=np.float64)
    out["sh_reshard"] = np.array([g["sh_reshard"] for g in got])
    out["sh_ckpt"] = np.array([g.get("sh_ckpt", False) for g in got])
    out["sh_ckpt_local"] = np.array([g.get("sh_ckpt_local", 0) for g in got])
    for k in ("cpm_scalar", "cpm_rows", "cpm_one"):
        out[k] = got[0][k]
    out["cpm_same"] = all(np.array_equal(g["cpm_scalar"], got[0]["cpm_scalar"]) for g in got)
    out["reshard_equal"] = np.array([g["reshard_equal"] for g in got])
    out["reshard_local"] = np.array([g.get("reshard_local", 0) for g in got])
    out["m_shapes"] = np.array([str(got[0]["m8"]), str(got[0]["m4"])])
    out["staged_bytes"] = np.array([g["staged_bytes"] for g in got])
    np.savez(sys.argv[2], **out)
    print("PORT DONE")
'''


def _run(tmp, name, script, args, env_extra):
    path = tmp / name
    path.write_text(script)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env_extra)
    proc = subprocess.run([sys.executable, str(path)] + [str(a) for a in args],
                          capture_output=True, text=True, timeout=TIMEOUT, env=env,
                          cwd=str(tmp))
    assert proc.returncode == 0, f"{name} failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's npz, the port's npz), each run once per module."""
    tmp = tmp_path_factory.mktemp("dist")
    jax_out, port_out = tmp / "jax.npz", tmp / "port.npz"
    _run(tmp, "jax_side.py", JAX_SCRIPT, [jax_out], {"JAX_PLATFORMS": "cpu"})
    _run(tmp, "port_side.py", PORT_SCRIPT, [jax_out, port_out], {})
    return dict(np.load(jax_out)), dict(np.load(port_out))


def _check(what, err, tol):
    print(f"[parity] {what}: err {err:.3g} (tol {tol})")
    assert err <= tol


def test_all_gather_is_exact(runs):
    j, p = runs
    assert np.array_equal(j["ag"], j["x"])
    for got in p["ag_all"]:                      # every rank, both ring kinds
        assert np.array_equal(got, j["x"])


def test_ring_reduce_scatter(runs):
    """Each rank's chunk of the sum over its data ring (every rank of the
    ring holds the same x, so the sum is 4x)."""
    j, p = runs
    chunks = j["x"].reshape(4, 4, 8)
    for r, got in enumerate(p["rs"]):
        _check(f"ring_reduce_scatter rank {r}", float(np.abs(got - 4 * chunks[r % 4]).max()), 1e-5)


def test_hierarchical_all_reduce(runs):
    j, p = runs
    for got in p["hier_all"]:
        _check("hierarchical all-reduce vs 8y", float(np.abs(got - 8 * j["y"]).max()), 1e-5)
    _check("hierarchical all-reduce vs JAX", float(np.abs(p["hier"] - j["hier"]).max()), 1e-5)


def test_compressed_ring_all_reduce(runs):
    """Each within 0.02 of 2y, and the port within one int8 step of the
    final scale (the largest |value| / 127) of JAX's."""
    j, p = runs
    two_y = 2 * j["y"]
    for name, got in (("JAX", j["comp"]),) + tuple(("port", g) for g in p["comp_all"]):
        _check(f"compressed ring ({name}) vs 2y, rel",
               float(np.abs(got - two_y).max() / np.abs(two_y).max()), 0.02)
    step = float(np.abs(j["comp"]).max()) / 127
    _check("compressed ring, port vs JAX, in int8 steps",
           float(np.abs(p["comp"] - j["comp"]).max()) / step, 1.0)


@pytest.mark.parametrize("form", ["rp_mlp", "rp_attn"])
def test_row_parallel_bf16_collectives(runs, form):
    """Within one bf16 step (2^-7 of the value's binade) of JAX's; every
    rank holds the same output."""
    j, p = runs
    ref = j[form]
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    _check(f"row_parallel {form} vs JAX, in bf16 steps",
           float((np.abs(p[form] - ref) / ulp).max()), 1.0)
    assert (p["rp_all"] == p["rp_all"][0]).all()


@pytest.mark.parametrize("form", ["rp_mlp", "rp_attn"])
def test_row_parallel_bf16_collectives_backward(runs, form):
    """The grads of x and w (bf16, a seeded cotangent of the output)
    within one bf16 step of ``jax.grad``'s through JAX's ``shard_map``:
    the sum's backward is the identity and each rank's slice grads are
    gathered whole; every rank holds the same grads."""
    j, p = runs
    for leaf in ("gx", "gw"):
        key = f"{form}_{leaf}"
        ref = j[key]
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        _check(f"row_parallel {form} grad {leaf[1]} vs JAX, in bf16 steps",
               float((np.abs(p[key] - ref) / ulp).max()), 1.0)
        assert bool(p[key + "_same"])


def test_context_parallel_decode(runs):
    j, p = runs
    _check("CP decode vs JAX's CP decode", float(np.abs(p["cp"] - j["cp"]).max()), 1e-4)
    _check("CP decode vs local decode", float(np.abs(p["cp"] - j["cp_ref"]).max()), 1e-4)


@pytest.mark.parametrize("ref", ["jax", "one_rank"])
def test_context_parallel_decode_step(runs, ref):
    """``decode_step`` with ``cp_axis``: the port's logits (every rank's
    the same; a per-row position the scalar's exactly) within rel 4e-2 of
    JAX's CP decode step (bf16 products round at other places in the two
    frameworks), and within rel 1e-5 of the port's one-rank decode (the
    same f32 attention over the same bf16 cache, merged in another order)."""
    j, p = runs
    assert bool(p["cpm_same"]) and np.array_equal(p["cpm_rows"], p["cpm_scalar"])
    other, tol = (j["cpm_logits"], 4e-2) if ref == "jax" else (p["cpm_one"], 1e-5)
    for i in range(3):
        rel = float(np.abs(p["cpm_scalar"][i] - other[i]).max() / np.abs(other[i]).max())
        _check(f"CP decode_step {i} vs {ref}, rel", rel, tol)


@pytest.mark.parametrize("ref", ["moe_y", "moe_dense"])
def test_expert_parallel_moe(runs, ref):
    j, p = runs
    _check(f"EP MoE vs JAX's {ref}", float(np.abs(p["moe_y"] - j[ref]).max()), 5e-2)


def test_expert_parallel_moe_metrics(runs):
    j, p = runs
    assert float(j["moe_dropped"]) == 0.0 and (p["moe_dropped"] == 0.0).all()
    _check("EP MoE aux vs JAX", float(np.abs(p["moe_aux"] - j["moe_aux"]).max()), 1e-5)
    _check("EP MoE load vs JAX", float(np.abs(p["moe_load"] - j["moe_load"]).max()), 1e-5)


@pytest.mark.parametrize("leaf", ["x", "router", "w_in", "w_out"])
def test_expert_parallel_moe_backward(runs, leaf):
    """The EP branch's grads (``core/collectives.py``'s backward rules)
    against ``jax.grad`` of the same objective through JAX's
    ``shard_map``, each leaf whole (EP_GRAD_TOL of its largest |grad|);
    every rank holds the same."""
    j, p = runs
    key = f"moe_g_{leaf}"
    ref = j[key]
    assert bool(p[key + "_same"])
    _check(f"EP MoE grad of {leaf} vs JAX, in its largest |grad|",
           float(np.abs(p[key] - ref).max() / np.abs(ref).max()), EP_GRAD_TOL)


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_expert_parallel_train_step(runs, ref):
    """Reduced granite-moe's step on (pod 2, data 2, model 2) through the
    EP branch, which ran with UserWarning an error: every rank's synced
    grads the same; each leaf within rel EP_STEP_TOL[ref] by norm of the
    one-rank step in 4 microbatches (the mesh's shards), the port's at
    an aux weight of 1 (the aux loss is each shard's own; a rank's share
    of its cotangent shows there), JAX's one-device step at granite's
    0.01; the loss within rel 1e-3."""
    j, p = runs
    if ref == "port":
        mine, other = _grads(p, "ep_mesh_aux1"), _grads(p, "ep_mb4_aux1")
        la, lo = float(p["ep_mesh_aux1_loss"][0]), float(p["ep_mb4_aux1_loss"][0])
        assert all(bool(p[f"ep_mesh_aux1_g{i}_same"]) for i in range(len(mine)))
    else:
        mine, other = _grads(p, "ep_mesh"), _grads(j, "ep_jax")
        la, lo = float(p["ep_mesh_loss"][0]), float(j["ep_jax_loss"])
    assert all(bool(p[f"ep_mesh_g{i}_same"]) for i in range(len(mine)))
    _check(f"EP train step grads vs {ref} 4 microbatches, worst leaf rel by norm",
           _worst_norm(mine, other), EP_STEP_TOL[ref])
    _check(f"EP train step loss vs {ref} 4 microbatches, rel", abs(la - lo) / abs(lo), 1e-3)


def _params_diff(a, b, n):
    return max(float(np.abs(a[i] - b[i]).max()) for i in range(n))


@pytest.mark.parametrize("pair", [("jax", "compressed"), ("auto", "compressed")])
def test_compressed_pod_sync(runs, pair):
    """JAX's compressed step against the port's, and the port's exact
    step against its compressed one: loss rel 1e-3, params 5e-3."""
    j, p = runs
    n = sum(1 for k in j if k.startswith("ps_p1_"))
    assert n and all(bool(p[f"ps_{m}_{i}_same"]) for m in ("auto", "compressed")
                     for i in range(n))
    pc = [p[f"ps_compressed_{i}"] for i in range(n)]
    if pair[0] == "jax":
        la, other = float(j["ps_loss"]), [j[f"ps_p1_{i}"] for i in range(n)]
    else:
        la, other = float(p["ps_auto_loss"][0]), [p[f"ps_auto_{i}"] for i in range(n)]
    lc = p["ps_compressed_loss"]
    assert (lc == lc[0]).all()
    _check(f"pod sync loss, {pair[0]} vs port compressed, rel", abs(la - lc[0]) / abs(la), 1e-3)
    _check(f"pod sync params, {pair[0]} vs port compressed", _params_diff(other, pc, n), 5e-3)
    moved = _params_diff([j[f"ps_p0_{i}"] for i in range(n)], pc, n)
    assert moved > 0, "the step did not move the params"


def _grads(src, key):
    n = sum(1 for k in src if k.startswith(key + "_g") and k[len(key) + 2:].isdigit())
    assert n
    return [src[f"{key}_g{i}"] for i in range(n)]


def _worst_steps(a, b):
    """The largest of ``max|a_i - b_i|`` over the leaves i, in int8 steps
    of ``b_i`` (its largest |value| / 127)."""
    return max(float(np.abs(x - y).max()) / max(float(np.abs(y).max()) / 127, 1e-30)
               for x, y in zip(a, b))


def _worst_norm(a, b):
    """The largest of ``|a_i - b_i| / |b_i|`` (2-norms) over the leaves i."""
    return max(float(np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-30))
               for x, y in zip(a, b))


def _port_key(mask, mode):
    return f"ps_{mode}" if mask == "ones" else f"ps_{mask}_{mode}"


@pytest.mark.parametrize("mb", ["", "_mb2"])
@pytest.mark.parametrize("mask", ["ones", "ragged"])
def test_pod_sync_exact_mean_is_the_batch_mean(runs, mask, mb):
    """The step on (pod 2, data 2, model 2) with the exact mean against the
    step with no mesh on the whole batch, with the shards' mask counts
    equal ("ones") and not ("ragged"), in one batch and in two
    microbatches: every rank's synced grads the same, each leaf within
    rel POD_SYNC_TOL["rel"] by norm, the loss within rel 1e-5."""
    _, p = runs
    mesh, one = _port_key(mask, "auto" + mb), _port_key(mask, "one_rank" + mb)
    g = _grads(p, mesh)
    assert all(bool(p[f"{mesh}_g{i}_same"]) for i in range(len(g)))
    _check(f"pod sync grads ({mask}{mb}), exact mean vs one rank, worst leaf rel by norm",
           _worst_norm(g, _grads(p, one)), POD_SYNC_TOL["rel"])
    la, lo = p[f"{mesh}_loss"], float(p[f"{one}_loss"][0])
    assert (la == la[0]).all()
    _check(f"pod sync loss ({mask}{mb}), exact mean vs one rank, rel",
           abs(float(la[0]) - lo) / abs(lo), 1e-5)


@pytest.mark.parametrize("mode", ["auto", "compressed"])
@pytest.mark.parametrize("mask", ["ones", "ragged"])
def test_pod_sync_grads_vs_jax(runs, mask, mode):
    """The port's step against JAX's (bridged params, the same batch), with
    the exact mean and through the int8 ring: every rank's synced grads
    the same, each leaf within rel 4e-2 by norm of JAX's (REL of
    ``tests/test_torch_train.py``), the grad norm within rel 4e-2, the
    loss within rel 1e-3."""
    j, p = runs
    key = _port_key(mask, mode)
    mine, ref = _grads(p, key), _grads(j, f"ps_{mask}_{mode}")
    assert all(bool(p[f"{key}_g{i}_same"]) for i in range(len(mine)))
    _check(f"pod sync grads ({mask}), port {mode} vs JAX {mode}, worst leaf rel by norm",
           _worst_norm(mine, ref), POD_SYNC_TOL["rel"])
    gp, gj = float(p[f"{key}_grad_norm"][0]), float(j[f"ps_{mask}_{mode}_grad_norm"])
    _check(f"pod sync grad norm ({mask}), port {mode} vs JAX, rel", abs(gp - gj) / gj,
           POD_SYNC_TOL["rel"])
    lp, lj = float(p[f"{key}_loss"][0]), float(j[f"ps_{mask}_{mode}_loss"])
    _check(f"pod sync loss ({mask}), port {mode} vs JAX, rel", abs(lp - lj) / abs(lj), 1e-3)


def test_pod_sync_ring_within_int8_steps(runs):
    """The port's compressed step against its exact one (the same shards'
    grads, so they differ by the ring alone): each leaf within
    POD_SYNC_TOL["int8"] int8 steps (its largest |exact grad| / 127) and
    the grad norm within rel POD_SYNC_TOL["norm"]. At two pods the ring
    rounds each value twice (one reduce-scatter hop, one all-gather), each
    within half a step of its own scale; the limit lets either scale be
    twice the exact grad's. A ring that sums where it should average,
    drops a pod or skips a leaf is off by a whole grad, ~127 steps."""
    _, p = runs
    comp, auto = _grads(p, "ps_compressed"), _grads(p, "ps_auto")
    _check("pod sync grads, port compressed vs exact, in int8 steps",
           _worst_steps(comp, auto), POD_SYNC_TOL["int8"])
    gc, ga = float(p["ps_compressed_grad_norm"][0]), float(p["ps_auto_grad_norm"][0])
    _check("pod sync grad norm, port compressed vs exact, rel", abs(gc - ga) / ga,
           POD_SYNC_TOL["norm"])


def test_elastic_reshard_is_bit_equal(runs):
    _, p = runs
    assert list(p["m_shapes"]) == ["{'pod': 2, 'data': 2, 'model': 2}",
                                   "{'pod': 2, 'data': 1, 'model': 2}"]
    assert p["reshard_equal"].all()
    # the 4 ranks of the new mesh hold the state, the others none
    assert (p["reshard_local"][:4] > 0).all() and (p["reshard_local"][4:] == 0).all()


@pytest.mark.parametrize("chunk_bytes", [0, 64, 200, 10 ** 6])
def test_chunked_matches_jax(chunk_bytes):
    """``chunked`` cuts dim 0 into the same segments as JAX's (in process:
    a shape-keeping function that tells segments apart)."""
    import jax.numpy as jnp
    import torch
    from repro.core.collectives import chunked as jax_chunked
    from repro_torch.core.collectives import chunked
    x = np.arange(13 * 3, dtype=np.float32).reshape(13, 3)
    port = chunked(lambda a: a - a[:1], torch.from_numpy(x), chunk_bytes).numpy()
    ref = np.asarray(jax_chunked(lambda a: a - a[:1], jnp.asarray(x), chunk_bytes))
    assert np.array_equal(port, ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_ring_quantizer_is_jax_bit_for_bit(seed):
    """The ring's per-tensor int8 (``_quant_int8``: scale max|x| / 127 +
    1e-30, round half to even) and its dequantization equal JAX's."""
    import jax.numpy as jnp
    import torch
    from repro.core import collectives as JC
    from repro_torch.core import collectives as TC
    x = np.random.default_rng(seed).standard_normal(1000).astype(np.float32) * 3
    q, sc = TC._quant_int8(torch.from_numpy(x))
    jq, jsc = JC._quant_int8(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(jq)) and float(sc) == float(jsc)
    assert np.array_equal(TC._dequant_int8(q, sc).numpy(), np.asarray(JC._dequant_int8(jq, jsc)))


def test_cpu_ranks_stage_nothing(runs):
    """On CPU ranks the transport is a plain gloo send: no host copies."""
    assert (runs[1]["staged_bytes"] == 0).all()


# ----------------------------------------------------------------------
# the train state held in blocks (launch/train.py::build on a mesh)
# ----------------------------------------------------------------------

#: the sharded step's limits: params max abs and loss rel as
#: dist_checks.py:121-125 (AdamW's first step moves a param by about lr
#: = 1e-3 either way, so a grad whose sign is bf16 noise moves it by
#: 2e-3), each grad block rel by norm as every grad is held to JAX's
SHARDED_TOL = dict(params=5e-3, loss=1e-3, grads=POD_SYNC_TOL["rel"])
RANKS = range(8)


def _held(src, key):
    import json
    return json.loads(str(src[key]))


def _cut(whole, sl):
    return whole[tuple(slice(a, b) for a, b in sl)]


@pytest.mark.parametrize("moments", ["f32", "int8"])
def test_sharded_state_is_jax_layout(runs, moments):
    """Each rank's params and AdamW moments as ``launch/train.py::build``
    leaves them on (pod 2, data 2, model 2) are JAX's ``addressable_shards``
    of the same device (``build``: ``param_shardings``, ``_opt_logical``):
    every leaf's shape, item size and place in the whole leaf, so the
    bytes too, exactly; and a rank holds less than the whole tree."""
    j, p = runs
    total = []
    for r in RANKS:
        mine, want = _held(p[f"sh_{moments}_held"], r), _held(j, f"sh_{moments}_held_{r}")
        assert mine == want, (r, mine, want)
        total.append(sum(n * int(np.prod(shp)) for shp, n, _ in mine))
    whole = int(j[f"sh_{moments}_whole_bytes"])
    print(f"[parity] sharded {moments} state: each rank holds {total} bytes of {whole}")
    assert max(total) < whole


@pytest.mark.parametrize("moments", ["f32", "int8"])
def test_sharded_step_vs_jax(runs, moments):
    """One step from JAX's params on (pod 2, data 2, model 2) from blocks:
    each rank's param blocks within SHARDED_TOL["params"] of JAX's shards
    of the same device after JAX's sharded step, the loss (every rank's
    the same) within rel 1e-3 of JAX's, and each grad block within rel
    4e-2 by norm of the same block of JAX's one-device step."""
    j, p = runs
    n = sum(1 for k in j if k.startswith(f"sh_{moments}_p1_0_"))
    assert n
    worst_p = max(float(np.abs(p[f"sh_{moments}_p1_{r}_{i}"] - j[f"sh_{moments}_p1_{r}_{i}"]).max())
                  for r in RANKS for i in range(n))
    worst_g = 0.0
    for r in RANKS:
        sl = _held(p["sh_slices"], r)
        mine = [p[f"sh_{moments}_g_{r}_{i}"] for i in range(n)]
        worst_g = max(worst_g, _worst_norm(mine, [_cut(j[f"sh_one_g{i}"], sl[i])
                                                  for i in range(n)]))
    losses = p[f"sh_{moments}_loss"]
    assert (losses == losses[0]).all()
    _check(f"sharded step ({moments}) params vs JAX's shards", worst_p, SHARDED_TOL["params"])
    _check(f"sharded step ({moments}) loss vs JAX, rel",
           abs(float(losses[0]) - float(j[f"sh_{moments}_loss"])) / float(j[f"sh_{moments}_loss"]),
           SHARDED_TOL["loss"])
    _check(f"sharded step ({moments}) grad blocks vs JAX one device, worst leaf rel by norm",
           worst_g, SHARDED_TOL["grads"])


@pytest.mark.parametrize("arch", ["internlm2", "granite_moe", "mamba2"])
def test_sharded_step_vs_whole(runs, arch):
    """The step from blocks against the port's whole-weight step on the
    same 8 ranks and params (internlm2: the pod sync's "auto" step;
    reduced granite-moe: the EP step under ``use_mesh``, with
    ``UserWarning`` an error, capacity None; reduced mamba2: the SSM
    mixer tensor-parallel over its heads): each rank's param blocks
    within SHARDED_TOL["params"] of the whole params' same blocks, each
    grad block (granite-moe, mamba2) within rel 4e-2 by norm of the whole
    grads' same block, the loss within rel 1e-3."""
    _, p = runs
    key, whole_loss = {"internlm2": ("sh_f32", float(p["ps_auto_loss"][0])),
                       "granite_moe": ("sh_ep", float(p["ep_mesh_loss"][0])),
                       "mamba2": ("sh_ssm", float(p["sh_ssm_whole_loss"][0]))}[arch]
    part = "vs_whole" if arch == "internlm2" else "whole_p1"
    n = sum(1 for k in p if k.startswith(f"{key}_p1_0_"))
    assert n
    worst_p = max(float(np.abs(p[f"{key}_p1_{r}_{i}"] - p[f"{key}_{part}_{r}_{i}"]).max())
                  for r in RANKS for i in range(n))
    _check(f"sharded step ({arch}) params vs the whole-weight step", worst_p,
           SHARDED_TOL["params"])
    if arch != "internlm2":
        worst_g = max(_worst_norm([p[f"{key}_g_{r}_{i}"] for i in range(n)],
                                  [p[f"{key}_whole_g_{r}_{i}"] for i in range(n)])
                      for r in RANKS)
        _check(f"sharded step ({arch}) grad blocks vs the whole-weight step, worst leaf "
               "rel by norm", worst_g, SHARDED_TOL["grads"])
    losses = p[f"{key}_loss"]
    assert (losses == losses[0]).all()
    _check(f"sharded step ({arch}) loss vs the whole-weight step, rel",
           abs(float(losses[0]) - whole_loss) / whole_loss, SHARDED_TOL["loss"])


@pytest.mark.parametrize("clip", ["0.0", "1.0"])
@pytest.mark.parametrize("moments", ["f32", "int8"])
def test_sharded_adamw_is_whole_adamw(runs, moments, clip):
    """AdamW on each rank's blocks (int8 moments: its run of the flat
    blocks) against AdamW on the whole tree, the same grads, three steps:
    params and moments gathered whole bit-equal without clipping; with
    clipping at 1 the grad norm, summed in another order, within rel 1e-6
    (so the clipped params may move by an f32 rounding)."""
    _, p = runs
    same, wn, bn = p[f"sh_adamw_{moments}_{clip}"].T
    _check(f"sharded AdamW ({moments}, clip {clip}) grad norm vs whole, rel",
           float(np.abs(bn - wn).max() / wn[0]), 1e-6)
    if clip == "0.0":
        assert same.all()


def test_sharded_reshard_and_checkpoint_are_bit_equal(runs):
    """The int8 state in blocks on (pod 2, data 2, model 2) resharded onto
    ``best_mesh_for(4, model=2)``: each of its ranks' blocks bit-equal to
    the whole state cut to it, the other ranks hold none; a checkpoint
    saved from (data 2, model 2) on 4 ranks (gathered, rank 0 writing the
    one-device format) restored onto (data 2, model 1) on 2: bit-equal to
    the whole state cut to it."""
    _, p = runs
    assert p["sh_reshard"].all()
    assert p["sh_ckpt"][:2].all() and (p["sh_ckpt_local"][:2] > 0).all()
