"""Training launcher, the port of ``repro/launch/train.py``.

Three modes:

- local: trains on one device, the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --seq 4096 --batch 8 --microbatch 2 --steps 3 --moments-int8

  trains the full-width model on the card (random init from seed 0, the
  synthetic ``TokenPipeline`` stream of seed 0), with the AdamW moments
  stored blockwise-int8 through the CUDA quantize / dequantize kernels.
  ``--reduced --device cpu`` trains a tiny model on the CPU through the
  plain versions; ``--reduced`` alone also shrinks the default shape to a
  CPU's size (batch 8, seq 64) unless ``--batch``/``--seq`` say
  otherwise. ``--ckpt-dir`` checkpoints every ``--ckpt-every`` steps
  (``--ckpt-replicas`` chain replicas) and resumes from the newest
  checkpoint there; ``--log`` appends each step's record as JSON. Prints
  a ``[train]`` line per step and a final line. ``--trace OUT.json``
  writes the steps' phases on the host's wall clock (``train.step``,
  ``train.forward``, ``train.backward``, ``train.accumulate``,
  ``train.optimizer``; ``train/train_step.py``) as Chrome-trace JSON
  (``obs.export.dump``).
- multi-pod: ``--multi-pod`` trains as SPMD ranks, one process per
  mesh position, on a gloo group: ``--ranks N`` processes started by
  ``torch.multiprocessing`` (the rendezvous a file in a temporary
  directory), or the group ``torchrun`` describes in the environment
  (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``). The mesh
  is ``best_mesh_for(world, model=min(2, world), prefer_pods=2)``, as
  the JAX launcher's local mode builds it from the device count. Every
  rank draws the same params from the seed, keeps only its blocks of
  them and of the AdamW state (JAX's ``param_shardings`` and
  ``_opt_logical``: d_model split over data, heads, mlp and vocab over
  model, int8 moments flat over both) and frees the rest; it takes its
  share of each batch and computes FSDP over data and tensor-parallel
  over model, and ``--pod-sync compressed`` sends the grads across pods
  through the int8 ring. On one card every rank computes on it and the
  ranks talk over gloo through host memory. Rank 0 prints and logs (the
  loss and grad norm are every rank's); a checkpoint gathers the blocks
  whole on every rank and rank 0 writes them in the one-device format;
  every rank resumes from ``--ckpt-dir`` and cuts its blocks again.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --reduced --device cpu --multi-pod --ranks 4 --pod-sync compressed --steps 3

- simulate: ``--simulate N`` dry-runs the config as N trainer nodes on
  a named fabric (``--fabric``, see ``train/cluster.TRAIN_FABRICS``;
  ``h100`` by default) — no torch work, just the FabricRuntime
  timeline: roofline compute, path-aware allreduce, contention-scheduled
  checkpoint staging. Prints simulated tokens/s and the step breakdown,
  as the JAX launcher does.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --shape train_4k --steps 20 --simulate 4 --ckpt-staging soc \\
        --ckpt-every 5 --fail node1:8

``--pod-sync compressed`` takes effect with ``--multi-pod`` (a mesh
with a pod axis); under ``--simulate --pods`` the pod sync is the
simulated policy.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from repro_torch._device import resolve_device
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.ft.elastic import best_mesh_for, make_mesh
from repro_torch.configs import SHAPES, RunConfig, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.quant.ops import dequantize, quantize
from repro_torch.launch.inputs import train_layout
from repro_torch.models.params import init_params
from repro_torch.optim.adamw import AdamWState, adamw_init, tree_leaves, tree_unflatten
from repro_torch.parallel import ranks as ranks_mod
from repro_torch.parallel.sharding import place
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer

#: --reduced's default shape (batch, seq): the tiny config on a CPU
REDUCED_SHAPE = (8, 64)


def _moments(run: RunConfig) -> str:
    return "int8" if run.moments_int8 else "f32"


def place_state(cfg, run: RunConfig, params, mesh):
    """This rank's blocks of ``params`` (whole, the same on every rank)
    and of ``adamw_init``'s state for them under ``launch/inputs.
    train_layout`` (JAX's ``jax.device_put`` with ``param_shardings`` and
    ``_opt_logical``). The state is made and cut one leaf at a time, so
    no more than one whole moment is held."""
    moments = _moments(run)
    play, olay = train_layout(cfg, mesh, moments)
    ms, vs = [], []
    for p, bm, bv in zip(tree_leaves(params), tree_leaves(olay.m), tree_leaves(olay.v)):
        st = adamw_init(p, moments=moments)
        ms.append(place(st.m, bm, mesh))
        vs.append(place(st.v, bv, mesh))
    opt = AdamWState(step=0, m=tree_unflatten(params, ms), v=tree_unflatten(params, vs))
    return place(params, play, mesh), opt


def build(cfg, run: RunConfig, device, mesh=None, host_tracer=None):
    """Params from seed ``run.seed``, AdamW state and the train step
    (recording its phases in ``host_tracer``, if given). On ``mesh``'s
    ranks each rank draws the same params and keeps only its blocks of
    them and of the state (``place_state``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(run.seed)
    params = init_params(cfg, gen, device)
    if mesh is None:
        opt = adamw_init(params, moments=_moments(run))
    else:
        params, opt = place_state(cfg, run, params, mesh)
    return params, opt, make_train_step(cfg, run, mesh=mesh, host_tracer=host_tracer)


def train_loop(cfg, run, shape, args, device, mesh=None, lead: bool = True):
    """Build, (resume,) train ``args.steps`` steps and print a line per
    step. ``lead``: this process prints, logs and saves checkpoints
    (rank 0 of a mesh); the others only restore."""
    def say(msg):
        if lead:
            print(msg, flush=True)

    say(f"[train] {cfg.name} on {device}: batch {shape.global_batch} x seq "
        f"{shape.seq_len}, microbatch {run.microbatch}, moments "
        f"{'int8' if run.moments_int8 else 'f32'}, remat {run.remat_policy}"
        + ("" if mesh is None else f", mesh {mesh.shape} pod_sync {run.pod_sync}"))
    quantize.launches = dequantize.launches = 0
    host_tracer = None
    if mesh is None and args.trace:
        from repro_torch.obs.host import HostTracer
        host_tracer = HostTracer()
    params, opt, step_fn = build(cfg, run, device, mesh, host_tracer)
    ckpt = None
    if args.ckpt_dir:
        # on a mesh every rank gathers the blocks of a save; rank 0 writes
        ckpt = CheckpointManager(
            args.ckpt_dir, every=args.ckpt_every if lead or mesh is not None else 0,
            replicas=args.ckpt_replicas if lead else 0, write=lead, mesh=mesh,
            layout=None if mesh is None else train_layout(cfg, mesh, _moments(run)))
    tr = Trainer(cfg, run, shape, step_fn=step_fn, params=params, opt_state=opt,
                 ckpt=ckpt, log_path=(args.log or None) if lead else None)
    if tr.start_step:
        say(f"[train] resumed from the checkpoint of step {tr.start_step - 1} "
            f"in {args.ckpt_dir}")
    tokens = shape.global_batch * shape.seq_len
    for _ in range(args.steps - tr.start_step):
        rec = tr.run_steps(1)
        say(f"[train] step {rec['step']}: loss {rec['loss']:.4f} lr {rec['lr']:.3g} "
            f"grad_norm {rec['grad_norm']:.4g} {rec['seconds'] * 1e3:.1f} ms "
            f"({tokens / rec['seconds']:.1f} tok/s)")
    if not tr.history:
        say(f"[train] nothing to do: the checkpoint in {args.ckpt_dir} is at "
            f"step {tr.start_step - 1} of {args.steps}")
        return tr
    last = tr.history[-1]
    say(f"[train] done: step={last['step']} loss={last['loss']:.4f} "
        f"({last['seconds'] * 1e3:.0f} ms/step); kernel launches: "
        f"quantize={quantize.launches} dequantize={dequantize.launches}")
    if host_tracer is not None:
        from repro_torch.obs.export import dump
        dump(host_tracer, args.trace)
        say(f"[trace] {len(host_tracer.spans)} spans -> {args.trace}")
    return tr


def multi_pod_rank(rank: int, world: int, cfg, run, shape, args):
    """One SPMD rank of ``--multi-pod``: its mesh position, the training
    loop; returns its losses."""
    shp, names = best_mesh_for(world, model=min(2, world), prefer_pods=2)
    mesh = make_mesh(shp, names, device=resolve_device(args.device))
    if rank == 0:
        print(f"[train] mesh={mesh.shape} ranks={world} (gloo)", flush=True)
    tr = train_loop(cfg, run, shape, args, mesh.device, mesh, lead=rank == 0)
    return [rec["loss"] for rec in tr.history]


def multi_pod(cfg, run, shape, args):
    """``--multi-pod``: under ``torchrun`` this process is one rank of its
    group; else ``--ranks`` processes are spawned here. Returns rank 0's
    losses."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world = ranks_mod.init_rank_from_env()
        try:
            return multi_pod_rank(int(os.environ["RANK"]), world, cfg, run, shape, args)
        finally:
            torch.distributed.destroy_process_group()
    if args.ranks < 1:
        raise ValueError(f"--multi-pod needs --ranks >= 1, got {args.ranks}")
    return ranks_mod.spawn(multi_pod_rank, args.ranks, cfg, run, shape, args,
                           timeout=None)[0]


def simulate(cfg, shape, args):
    """--simulate: dry-run the config on a named fabric (no torch work).
    With ``--pods P``, runs P pods of ``--simulate N`` nodes each —
    per-pod fabrics merged over the shared ``dcn:pod`` trunk
    (train/pods.py) — and ``--pod-sync`` selects the inter-pod gradient
    sync (raw vs int8-compressed trunk ring, simulated)."""
    from repro_torch.train.cluster import (ClusterTimeModel, TRAIN_FABRICS,
                                           TrainCluster)
    if args.fabric not in TRAIN_FABRICS:
        raise SystemExit(f"unknown fabric {args.fabric!r} "
                         f"(have {sorted(TRAIN_FABRICS)})")

    def parse_pair(spec, cast):
        name, _, val = spec.partition(":")
        return name, cast(val)

    topo = None
    fabric = None
    if args.pods > 1:
        from repro_torch.train.pods import PodTopology, pod_fabric
        topo = PodTopology(args.pods, args.simulate, sync=args.pod_sync)
        fabric = pod_fabric(args.pods, args.simulate,
                            trunk_bw=args.trunk_bw or None,
                            pod_fabric_fn=TRAIN_FABRICS[args.fabric])
        nodes = topo.total_nodes
    else:
        nodes = args.simulate
        fabric = TRAIN_FABRICS[args.fabric](nodes)

    tm = ClusterTimeModel.from_config(cfg, shape, nodes=nodes,
                                      ckpt_path=args.ckpt_staging,
                                      buckets=args.buckets,
                                      weighted_buckets=args.weighted_buckets)

    def fresh_fabric():
        if args.pods > 1:
            from repro_torch.train.pods import pod_fabric
            return pod_fabric(args.pods, args.simulate,
                              trunk_bw=args.trunk_bw or None,
                              pod_fabric_fn=TRAIN_FABRICS[args.fabric])
        return TRAIN_FABRICS[args.fabric](nodes)

    def make(time_model, fab):
        return TrainCluster(
            nodes, time_model, fabric=fab, topology=topo,
            ckpt_every=args.ckpt_every,
            host_load=dict([parse_pair(args.host_load, float)])
            if args.host_load else None,
            fail_at=parse_pair(args.fail, int) if args.fail else None,
            mitigate_stragglers=True)

    ref = None
    if args.buckets > 1:
        # single-shot reference on an identical fresh fabric: the
        # overlap win is reported as measured, not predicted
        ref = make(dataclasses.replace(tm, buckets=1, bucket_weights=None),
                   fresh_fabric()).run(args.steps)
    cluster = make(tm, fabric)
    summary = cluster.run(args.steps)
    pods_msg = (f" pods={topo.pods}x{topo.nodes_per_pod} "
                f"pod_sync={topo.sync}" if topo is not None else "")
    print(f"[simulate] fabric={args.fabric} nodes={nodes}{pods_msg} "
          f"arch={cfg.name} shape={shape.name}")
    print(f"[simulate] compute={tm.compute_s * 1e3:.2f}ms/step "
          f"grad={tm.grad_bytes / 1e9:.2f}GB ckpt={tm.ckpt_bytes / 1e9:.2f}GB "
          f"via {tm.ckpt_path}")
    for e in summary["events"]:
        print(f"[simulate] t={e['t']:.3f}s {e['event']} "
              f"{ {k: v for k, v in e.items() if k not in ('t', 'event')} }")
    print(f"[simulate] {summary['steps']} steps in "
          f"{summary['sim_seconds']:.3f}s simulated "
          f"-> {summary.get('tokens_per_s', 0.0):,.0f} tokens/s "
          f"({len(cluster.straggler.stragglers())} stragglers flagged)")
    if ref is not None and ref["steps"] and summary["steps"]:
        t1 = ref["sim_seconds"] / ref["steps"]
        tk = summary["sim_seconds"] / summary["steps"]
        win = 100.0 * (1.0 - tk / t1) if t1 > 0 else 0.0
        print(f"[simulate] buckets={tm.buckets}: {tk * 1e3:.1f}ms/step vs "
              f"{t1 * 1e3:.1f}ms single-shot -> overlap win {win:.1f}%")
        # first step's overlap timeline, straight off the tracer's
        # bucket phase spans (the cluster's own runtime traces them)
        from repro_torch.obs.trace import PHASE
        spans = [s for s in cluster.runtime.tracer.spans
                 if s.kind == PHASE and s.name == "bucket"
                 and not s.meta.get("aborted")]
        s0 = min((s.meta["step"] for s in spans), default=0)
        for s in sorted((s for s in spans if s.meta["step"] == s0),
                        key=lambda s: s.meta["bucket"]):
            print(f"[simulate]   bucket {s.meta['bucket']}: closed "
                  f"t={s.t_end * 1e3:.1f}ms issued t={s.t_start * 1e3:.1f}ms,"
                  f" in flight {(s.t_end - s.t_start) * 1e3:.1f}ms")
    if topo is not None:
        from repro_torch.core.fabric import OUT
        left = cluster.runtime.ledger.reserved(topo.trunk, OUT)
        print(f"[simulate] trunk {topo.trunk}: reserved after run = "
              f"{left:.3g} (0 = every pod-sync reservation conserved)")
    off = cluster.offload.get_performance_stats()
    if off["compression_bytes_in"]:
        print(f"[simulate] offload: "
              f"{off['compression_operations_offloaded']} saves compressed "
              f"off-host, cycles_saved={off['cpu_cycles_saved']:.3g}, "
              f"ratio={off['compression_ratio']:.2f}")
    if args.trace:
        from repro_torch.obs.export import dump
        dump(cluster.runtime.tracer, args.trace)
        print(f"[simulate] wrote Chrome trace "
              f"({len(cluster.runtime.tracer.spans)} spans) to {args.trace}")
    return cluster


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU example mode)")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--moments-int8", action="store_true",
                    help="store the AdamW moments blockwise-int8")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--pod-sync", default="auto", choices=["auto", "compressed"])
    ap.add_argument("--multi-pod", action="store_true",
                    help="train as SPMD ranks on a gloo group (see the module doc)")
    ap.add_argument("--ranks", type=int, default=4,
                    help="--multi-pod: processes to spawn (torchrun's world "
                         "takes its place)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-replicas", type=int, default=0)
    ap.add_argument("--log", default="")
    ap.add_argument("--simulate", type=int, default=0, metavar="NODES",
                    help="dry-run NODES simulated trainer nodes on a "
                         "named fabric instead of training")
    ap.add_argument("--pods", type=int, default=1,
                    help="--simulate: run PODS pods of NODES nodes each, "
                         "per-pod fabrics merged over the shared dcn:pod "
                         "trunk (--pod-sync picks the inter-pod sync)")
    ap.add_argument("--trunk-bw", type=float, default=0.0,
                    help="--simulate --pods: inter-pod trunk bytes/s "
                         "(default pods * DCN_BW_PER_CHIP)")
    ap.add_argument("--buckets", type=int, default=1, metavar="K",
                    help="--simulate: split the gradient into K "
                         "per-layer-group buckets, each allreduce "
                         "issued as its backward slice completes "
                         "(bucketed-DDP overlap; K>1 also runs a "
                         "single-shot reference and prints the "
                         "measured overlap win)")
    ap.add_argument("--weighted-buckets", action="store_true",
                    help="--simulate --buckets K: size each gradient "
                         "bucket from the model's real per-layer-group "
                         "parameter counts instead of splitting "
                         "uniformly (train/cluster.layer_group_weights)")
    ap.add_argument("--trace", default="", metavar="OUT.json",
                    help="write the run's span timeline as Chrome-trace "
                         "JSON (load in chrome://tracing or ui.perfetto.dev): "
                         "--simulate's simulated spans, or the local mode's "
                         "host-clock phases of each step")
    ap.add_argument("--fabric", default="h100",
                    help="named fabric for --simulate "
                         "(h100 | weak-soc | fast-net | linefs)")
    ap.add_argument("--ckpt-staging", default="soc",
                    choices=["soc", "host", "auto", "soc-compress",
                             "host-compress"],
                    help="--simulate: checkpoint staging mode (auto = "
                         "per-save ledger-occupancy choice over wires "
                         "AND compress-then-stage; *-compress = run the "
                         "codec on that side's device, stage only the "
                         "compressed bytes)")
    ap.add_argument("--host-load", default="",
                    help="--simulate: NODE:FRAC background host-path load, "
                         "e.g. node0:0.6")
    ap.add_argument("--fail", default="",
                    help="--simulate: NODE:STEP silences a node mid-run, "
                         "e.g. node1:8")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = SHAPES[args.shape]
    if args.simulate:
        if args.batch or args.seq:
            shape = ShapeConfig("custom", args.seq or shape.seq_len,
                                args.batch or shape.global_batch, "train")
        return simulate(cfg, shape, args)

    device = resolve_device(args.device)
    if args.reduced:
        shape = ShapeConfig("reduced", REDUCED_SHAPE[1], REDUCED_SHAPE[0], "train")
    if args.batch or args.seq:
        shape = ShapeConfig("custom", args.seq or shape.seq_len,
                            args.batch or shape.global_batch, "train")
    run = RunConfig(learning_rate=args.lr, total_steps=args.steps,
                    warmup_steps=max(2, args.steps // 10),
                    microbatch=args.microbatch, pod_sync=args.pod_sync,
                    ckpt_every=args.ckpt_every, moments_int8=args.moments_int8)
    if args.multi_pod:
        if args.trace:
            ap.error("--trace writes --simulate's or the local mode's spans, "
                     "not --multi-pod's")
        return multi_pod(cfg, run, shape, args)
    return train_loop(cfg, run, shape, args, device)


if __name__ == "__main__":
    main()
