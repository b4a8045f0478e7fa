"""Million-user serving fleet launcher (sim compute, no model).

Runs the SLO tenant fleet — N ``StagedServeEngine``s as tenants of one
``FabricRuntime`` and one budget ledger — under seeded open-loop
traces, and prints the per-tenant TTFT-attainment table. The default
is the headline experiment: ``premium`` (tight SLO, heavy QoS weight)
rides a 10x diurnal burst trace while ``standard`` offers steady load;
``--mode both`` contrasts the static fleet (attainment collapses
during the burst) against TTFT-driven decode autoscaling (replicas
spawn onto private paths, the shared host path drains, attainment
holds). Token streams are bit-identical across the two modes — scaling
moves traffic, it never changes bytes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.fleet                  # headline, both
  PYTHONPATH=src python -m repro_torch.launch.fleet --mode autoscaled \
      --duration 60 --arbitration
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.scale import AutoscaleConfig, ServeFleet, headline_specs


def _build(args, tracer=None) -> ServeFleet:
    cfg = AutoscaleConfig(max_replicas=args.max_replicas)
    specs = headline_specs(duration=args.duration, autoscale=cfg)
    if args.premium_rate or args.standard_rate:
        by_name = {"premium": args.premium_rate, "standard": args.standard_rate}
        specs = [dataclasses.replace(
                     s, trace=dataclasses.replace(
                         s.trace, base_rate=by_name[s.name]))
                 if by_name.get(s.name) else s
                 for s in specs]
    return ServeFleet(specs, host_bw=args.host_bw,
                      replica_bw=args.replica_bw, replicas=args.replicas,
                      arbitration=args.arbitration, tracer=tracer)


def _show(tag: str, rep) -> None:
    print(f"[{tag}] {rep.sim_seconds:.1f}s simulated, "
          f"{rep.events_processed:,} events")
    print(f"  {'tenant':<10} {'slo':>7} {'attain':>7} {'p50':>8} {'p99':>8} "
          f"{'reqs':>6} {'peak_rep':>8} {'scales':>6}")
    for name, tr in sorted(rep.tenants.items()):
        m = tr.metrics
        print(f"  {name:<10} {tr.slo_ttft:>6.2f}s {tr.attainment:>7.1%} "
              f"{m['p50_ttft']:>7.3f}s {m['p99_ttft']:>7.3f}s "
              f"{m['requests']:>6.0f} {tr.peak_replicas:>8d} "
              f"{len(tr.scale_events):>6d}")
    for e in rep.admission_events:
        print(f"  [admission] t={e['t']:.2f}s {e['event']} "
              f"offender={e.get('offender', '?')} "
              f"victim={e.get('victim', '?')}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", default="both",
                    choices=["both", "static", "autoscaled"])
    ap.add_argument("--duration", type=float, default=120.0,
                    help="trace length in simulated seconds")
    ap.add_argument("--premium-rate", type=float, default=None,
                    help="override premium base arrival rate (req/s)")
    ap.add_argument("--standard-rate", type=float, default=None,
                    help="override standard base arrival rate (req/s)")
    ap.add_argument("--host-bw", type=float, default=1400.0,
                    help="shared host path units/s")
    ap.add_argument("--replica-bw", type=float, default=400.0,
                    help="units/s of each private decode-replica path")
    ap.add_argument("--replicas", type=int, default=3,
                    help="decode-replica paths provisioned in the fabric")
    ap.add_argument("--max-replicas", type=int, default=4,
                    help="autoscaler ceiling per tenant (incl. fallback)")
    ap.add_argument("--arbitration", action="store_true",
                    help="K-tenant admission arbitration (priority-ordered "
                         "intake pause/resume)")
    ap.add_argument("--max-sim-seconds", type=float, default=2000.0)
    ap.add_argument("--trace", default="", metavar="OUT.json",
                    help="write the autoscaled run's span timeline (or the "
                         "static run's, with --mode static) as Chrome-trace "
                         "JSON")
    args = ap.parse_args(argv)

    tracer = None
    if args.trace:
        from repro_torch.obs.trace import Tracer
        tracer = Tracer()

    out = {}
    if args.mode in ("both", "static"):
        out["static"] = _build(
            args, tracer=tracer if args.mode == "static" else None).run(
            autoscale=False, max_sim_seconds=args.max_sim_seconds)
        _show("static    ", out["static"])
    if args.mode in ("both", "autoscaled"):
        out["autoscaled"] = _build(args, tracer=tracer).run(
            autoscale=True, max_sim_seconds=args.max_sim_seconds)
        _show("autoscaled", out["autoscaled"])
    if tracer is not None:
        from repro_torch.obs.export import dump
        dump(tracer, args.trace)
        print(f"[trace] {len(tracer.spans)} spans -> {args.trace}")
    if len(out) == 2:
        s = out["static"].attainment("premium")
        a = out["autoscaled"].attainment("premium")
        print(f"[fleet] premium attainment: static {s:.1%} -> "
              f"autoscaled {a:.1%}")
    return out


if __name__ == "__main__":
    main()
