"""Serve+train colocation launcher (the §6 multi-tenant study).

Runs a ``StagedServeEngine`` (latency tenant, the model's real decode)
and a ``TrainCluster`` (throughput tenant, timing-only) on one merged
fabric and one budget ledger, in three configurations:

  solo       each tenant alone on the fabric (the baselines);
  unmanaged  both tenants, equal fair shares — the §6 collapse;
  managed    QoS weights + the SLO-driven admission controller.

``--mode all`` (default) runs the sweep and prints the crossover table:
serve p50/p99 TTFT vs solo, train tokens/s retention, throttle count,
and the per-path occupancy attribution of the managed run. The flags
and the printed lines are those of the JAX package's launcher; the
figures are the fabric model's simulated seconds, so under the same
``core/hw.py`` constants they are its figures too.

The serve tenant runs ``impl="auto"`` on ``--device`` (``cuda`` unless
asked): on the card its prefill goes through the flash-attention kernel
and its decode through the flash-decoding kernel; on the CPU both take
their plain versions. Weights are random, from seed 0.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.colocate --arch internlm2-1.8b \
      --requests 8 --train-steps 4 --serve-weight 16 --slo-factor 1.2
  PYTHONPATH=src python -m repro_torch.launch.colocate --reduced --device cpu
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.models.params import init_params
from repro_torch.serve.engine import Request, StagedServeEngine
from repro_torch.tenancy import (AdmissionConfig, Colocation, QoSPolicy, SERVE,
                                 TRAIN, colocation_fabric, colocation_time_model,
                                 solo_serve, solo_train)
from repro_torch.train.cluster import ClusterTimeModel, TrainCluster


def build_pieces(args, *, device=None, compute: str = "torch", params=None,
                 cluster_kw: Optional[Callable[[], dict]] = None):
    """The launcher's fabric factory, tenant factories and request list.

    ``compute="sim"`` builds the engine without a model (JAX's sim token
    stream: the same simulated timeline). ``params`` reuses weights
    already on ``device``; ``cluster_kw`` is called once per cluster and
    its keywords (a numeric stream: ``step_fn``, ``params``,
    ``opt_state``, ``batch_at``) go to ``TrainCluster``."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if compute == "torch" and params is None:
        device = resolve_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params = init_params(cfg, gen, device)
    fabric = lambda: colocation_fabric(  # noqa: E731 — fresh per run
        args.nodes, host_bw=args.host_bw, soc_frac=args.soc_frac,
        net_bw_per_node=100.0, decode_bw=4 * args.host_bw,
        concurrency_discount=args.discount)
    tm = colocation_time_model(0, prefill_units_per_token=args.prefill_units,
                               decode_units_per_slot=args.decode_units)
    ctm = ClusterTimeModel(compute_s=args.compute_s,
                           grad_bytes=args.grad_units,
                           ckpt_bytes=args.ckpt_units,
                           ckpt_path=args.ckpt_staging,
                           tokens_per_step=args.tokens_per_step)

    def make_engine(rt):
        if compute == "sim":
            return StagedServeEngine(None, None, compute="sim", slots=args.slots,
                                     max_len=64, runtime=rt, time_model=tm,
                                     tenant=SERVE)
        return StagedServeEngine(cfg, params, slots=args.slots, max_len=64,
                                 impl="auto", runtime=rt, time_model=tm,
                                 tenant=SERVE, device=device)

    def make_cluster(rt):
        kw = cluster_kw() if cluster_kw is not None else {}
        return TrainCluster(args.nodes, ctm, fabric=rt.fabric, runtime=rt,
                            ckpt_every=args.ckpt_every, tenant=TRAIN, **kw)

    def requests():
        rng = np.random.default_rng(args.seed)
        return [Request(rid=i, prompt=rng.integers(
                    0, cfg.vocab_size, args.prompt_len).astype(np.int32),
                        max_new_tokens=args.max_new,
                        arrival=args.spacing * i)
                for i in range(args.requests)]

    return fabric, make_engine, make_cluster, requests


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU example mode)")
    ap.add_argument("--device", default="cuda",
                    help="the serve tenant's device (cpu: plain versions)")
    ap.add_argument("--mode", default="all",
                    choices=["all", "solo", "unmanaged", "managed"])
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--train-steps", type=int, default=4)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--spacing", type=float, default=0.3,
                    help="request inter-arrival seconds")
    ap.add_argument("--serve-weight", type=float, default=16.0)
    ap.add_argument("--train-weight", type=float, default=1.0)
    ap.add_argument("--slo-factor", type=float, default=1.2,
                    help="SLO = factor x solo p99 TTFT")
    ap.add_argument("--occupancy-limit", type=float, default=None,
                    help="pre-emptive throttle: train share of the "
                         "prefill path (e.g. 0.4)")
    ap.add_argument("--host-bw", type=float, default=16.0,
                    help="path units/s of each host path (toy units)")
    ap.add_argument("--soc-frac", type=float, default=0.7)
    ap.add_argument("--discount", type=float, default=0.1)
    ap.add_argument("--prefill-units", type=float, default=0.25,
                    help="path units per prompt token on the shared "
                         "prefill path")
    ap.add_argument("--decode-units", type=float, default=0.25,
                    help="path units per active slot per decode step on "
                         "the serve-private decode path")
    ap.add_argument("--grad-units", type=float, default=16.0)
    ap.add_argument("--ckpt-units", type=float, default=8.0)
    ap.add_argument("--ckpt-every", type=int, default=2)
    ap.add_argument("--ckpt-staging", default="soc",
                    choices=["soc", "host", "auto"])
    ap.add_argument("--compute-s", type=float, default=0.3)
    ap.add_argument("--tokens-per-step", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--trace", default="", metavar="OUT.json",
                    help="write the managed run's span timeline (or the "
                         "unmanaged run's, with --mode unmanaged) as "
                         "Chrome-trace JSON + print the attribution "
                         "summary (load in chrome://tracing or "
                         "ui.perfetto.dev)")
    return ap


def managed_config(args, solo_p99: float) -> AdmissionConfig:
    """The managed run's admission controller: SLO = ``--slo-factor`` x
    the solo p99 TTFT, and the pre-emptive occupancy throttle on the
    shared prefill path when ``--occupancy-limit`` is given."""
    watch = (colocation_time_model(0).prefill_path,)
    return AdmissionConfig(
        slo_ttft=args.slo_factor * solo_p99, occupancy_limit=args.occupancy_limit,
        watch_paths=watch if args.occupancy_limit else ())


def solo_line(solo_s: dict, solo_t: dict) -> str:
    return (f"[solo]      serve p50={solo_s['p50_ttft']:.4f}s "
            f"p99={solo_s['p99_ttft']:.4f}s | "
            f"train {solo_t['tokens_per_s']:,.0f} tokens/s")


def run_line(tag: str, rep, solo_s: dict, solo_t: dict) -> str:
    infl = rep.serve["p99_ttft"] / solo_s["p99_ttft"]
    keep = rep.train["tokens_per_s"] / solo_t["tokens_per_s"]
    return (f"[{tag:<9}] serve p50={rep.serve['p50_ttft']:.4f}s "
            f"p99={rep.serve['p99_ttft']:.4f}s ({infl:.2f}x solo) | "
            f"train {rep.train['tokens_per_s']:,.0f} tokens/s "
            f"({keep:.1%} of solo) | throttles={rep.throttles}")


def managed_lines(rep) -> list:
    """The managed run's occupancy attribution and admission events."""
    lines = ["[occupancy] " + "  ".join(
        f"{path}:{{{', '.join(f'{t}={f:.2f}' for t, f in sorted(per.items()))}}}"
        for path, per in sorted(rep.occupancy.items()))]
    for e in rep.events:
        if e["event"] in ("throttle", "resume"):
            lines.append(f"[admission] t={e['t']:.3f}s {e['event']} "
                         f"({e.get('reason', '')})")
    return lines


def main(argv=None):
    args = parser().parse_args(argv)

    fabric, make_engine, make_cluster, requests = build_pieces(
        args, device=args.device)
    out = {}

    solo_s = solo_serve(fabric(), make_engine, requests())
    solo_t = solo_train(fabric(), make_cluster, args.train_steps)
    out["solo"] = (solo_s, solo_t)
    print(solo_line(solo_s, solo_t))
    if args.mode == "solo":
        return out

    tracer = None
    if args.trace:
        from repro_torch.obs.trace import Tracer
        tracer = Tracer()

    if args.mode in ("all", "unmanaged"):
        rep = Colocation(fabric=fabric(), make_engine=make_engine,
                         make_cluster=make_cluster,
                         tracer=tracer if args.mode == "unmanaged" else None,
                         ).run(requests(), args.train_steps)
        out["unmanaged"] = rep
        print(run_line("unmanaged", rep, solo_s, solo_t))
    if args.mode in ("all", "managed"):
        rep = Colocation(
            fabric=fabric(), make_engine=make_engine,
            make_cluster=make_cluster,
            qos=QoSPolicy.serve_train(args.serve_weight, args.train_weight),
            admission=managed_config(args, solo_s["p99_ttft"]),
            tracer=tracer,
            ).run(requests(), args.train_steps)
        out["managed"] = rep
        print(run_line("managed", rep, solo_s, solo_t))
        for line in managed_lines(rep):
            print(line)

    if tracer is not None:
        from repro_torch.obs.export import dump, summary
        dump(tracer, args.trace)
        print(f"[trace] {len(tracer.spans)} spans -> {args.trace} "
              "(load in chrome://tracing or ui.perfetto.dev)")
        print(summary(tracer))
    return out


if __name__ == "__main__":
    main()
