"""Serving launcher: batched requests through the port's serving engines.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b

runs the full-width model on the card (random weights from seed 0):
internlm2's prefill through the CUDA flash-attention kernel and decode
through the CUDA flash-decoding kernel; mamba2's prefill through the
CUDA SSD-scan kernel and decode through the one-token recurrence.
``--reduced --device cpu`` runs a tiny model on the CPU through the
plain versions.

``--kv-fabric`` plans the synchronous engine's decode-cache placement
on the §5.2 KV fabric. ``--staged`` runs the event-driven pipeline on
that fabric instead: prefill transfers (DMA path) overlap decode cache
reads, the decode placement is re-planned per admitted request from
live ledger occupancy, and the report adds the simulated p50/p99
time-to-first-token, the makespan and the placements.
``--arrival-spacing`` spaces arrivals out (simulated seconds); 0 = one
burst.

``--trace steady|burst`` replaces the fixed request list with a seeded
``repro_torch.scale.TraceSpec`` replay: Poisson arrivals (diurnal and
burst modulated) with heavy-tailed prompt/decode lengths. It needs
``--staged``; ``--requests``, ``--prompt-len``, ``--max-new`` and
``--arrival-spacing`` are ignored then. ``--trace-json OUT.json`` writes
the staged run's span timeline as Chrome-trace JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention.ops import decode_attention_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.params import init_params
from repro_torch.serve.disagg import kv_fabric, kv_serve_time_model
from repro_torch.serve.engine import Request, ServeEngine, StagedServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kv-fabric", action="store_true",
                    help="plan decode cache placement on the §5.2 fabric")
    ap.add_argument("--staged", action="store_true",
                    help="event-driven pipeline (per-request placement)")
    ap.add_argument("--arrival-spacing", type=float, default=0.0,
                    help="seconds between simulated arrivals (staged)")
    ap.add_argument("--trace", choices=("steady", "burst"), default=None,
                    help="replay a seeded repro_torch.scale trace instead "
                         "of the fixed request list (requires --staged)")
    ap.add_argument("--trace-rate", type=float, default=2.0,
                    help="trace base arrival rate, requests/s")
    ap.add_argument("--trace-duration", type=float, default=20.0,
                    help="trace length in simulated seconds")
    ap.add_argument("--trace-seed", type=int, default=0,
                    help="arrival-generator seed (deterministic replay)")
    ap.add_argument("--trace-json", default="", metavar="OUT.json",
                    help="write the staged run's span timeline as "
                         "Chrome-trace JSON (requires --staged; distinct "
                         "from --trace, which replays an arrival trace)")
    args = ap.parse_args(argv)
    if args.trace and not args.staged:
        ap.error("--trace requires --staged")
    if args.trace_json and not args.staged:
        ap.error("--trace-json requires --staged")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device)
    if args.staged:
        tracer = None
        if args.trace_json:
            from repro_torch.obs.trace import Tracer
            tracer = Tracer()
        eng = StagedServeEngine(cfg, params, slots=args.slots,
                                max_len=args.max_len, fabric=kv_fabric(),
                                time_model=kv_serve_time_model(),
                                plan_placement=True, tracer=tracer,
                                device=device)
    else:
        fabric = kv_fabric() if args.kv_fabric else None
        eng = ServeEngine(cfg, params, slots=args.slots, max_len=args.max_len,
                          fabric=fabric, device=device)
        if eng.placement is not None:
            p = eng.placement
            print(f"[serve] decode cache placement: {p.location} "
                  f"({p.rate / 1e6:.1f}M gets/s, "
                  f"+{(p.rate / p.baseline_rate - 1) * 100:.0f}% vs baseline)")
    del params                            # the engine keeps its bf16 copy

    if args.arrival_spacing and not args.staged:
        print("[serve] note: --arrival-spacing only shapes the simulated "
              "timeline of --staged; the synchronous engine admits a burst")
    if args.trace:
        from repro_torch.scale import ArrivalGenerator, TraceSpec, burst_trace
        if args.trace == "burst":
            trace = burst_trace(base_rate=args.trace_rate,
                                duration=args.trace_duration,
                                burst_start=args.trace_duration * 0.25,
                                burst_duration=args.trace_duration * 0.375)
        else:
            trace = TraceSpec("steady", args.trace_rate, args.trace_duration,
                              diurnal_amplitude=0.25,
                              diurnal_period=args.trace_duration)
        # clamp sampled lengths to the engine's slot budget
        trace = dataclasses.replace(trace, prompt=dataclasses.replace(
            trace.prompt,
            high=max(trace.prompt.low,
                     min(trace.prompt.high, args.max_len - trace.decode.high))))
        reqs = ArrivalGenerator(trace, seed=args.trace_seed,
                                vocab=cfg.vocab_size).requests()
        for r in reqs:
            r.temperature = args.temperature
            eng.submit(r)
        print(f"[serve] trace {trace.name!r}: {len(reqs)} arrivals over "
              f"{trace.duration:.0f}s (mean {trace.mean_rate:.1f} req/s, "
              f"peak {trace.peak_rate:.1f} req/s, seed {args.trace_seed})")
    else:
        rng = np.random.default_rng(0)
        reqs = []
        for i in range(args.requests):
            prompt = rng.integers(0, cfg.vocab_size, size=(args.prompt_len,)).astype(np.int32)
            r = Request(rid=i, prompt=prompt, max_new_tokens=args.max_new,
                        temperature=args.temperature,
                        arrival=i * args.arrival_spacing if args.staged else 0.0)
            reqs.append(r)
            eng.submit(r)

    flash_attention.launches = decode_attention_kernel.launches = ssd_scan.launches = 0
    t0 = time.monotonic()
    eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.monotonic() - t0
    toks = sum(len(r.out_tokens) for r in reqs)
    print(f"[serve] {len(reqs)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s); decode_steps={eng.stats['decode_steps']} "
          f"prefill_compilations={eng.stats['prefill_compilations']}")
    print(f"[serve] kernel launches: flash_attention={flash_attention.launches} "
          f"decode_attention={decode_attention_kernel.launches} "
          f"ssd_scan={ssd_scan.launches} (device {device})")
    if args.staged:
        p50, p99 = np.percentile([r.ttft for r in reqs], [50, 99])
        print(f"[serve] simulated TTFT p50={p50 * 1e3:.3f}ms "
              f"p99={p99 * 1e3:.3f}ms makespan="
              f"{eng.clock.now * 1e3:.3f}ms placements={eng.placements}")
        if args.trace_json:
            from repro_torch.obs.export import dump
            dump(eng.runtime.tracer, args.trace_json)
            print(f"[trace] {len(eng.runtime.tracer.spans)} spans -> "
                  f"{args.trace_json}")
    for r in reqs[:4]:
        print(f"  req{r.rid}: {r.out_tokens[:10]}{'...' if len(r.out_tokens) > 10 else ''}")
    if not all(r.done for r in reqs):
        raise RuntimeError("not every request finished")
    return reqs


if __name__ == "__main__":
    main()
