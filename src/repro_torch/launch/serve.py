"""Serving launcher: batched requests through the port's ServeEngine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b

runs the full-width model on the card (random weights from seed 0):
internlm2's prefill through the CUDA flash-attention kernel and decode
through the CUDA flash-decoding kernel; mamba2's prefill through the
CUDA SSD-scan kernel and decode through the one-token recurrence.
``--reduced --device cpu`` runs a tiny model on the CPU through the
plain versions.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention.ops import decode_attention_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.params import init_params
from repro_torch.serve.engine import Request, ServeEngine


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
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device)
    eng = ServeEngine(cfg, params, slots=args.slots, max_len=args.max_len,
                      device=device)
    del params                            # the engine keeps its bf16 copy

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=(args.prompt_len,)).astype(np.int32)
        r = Request(rid=i, prompt=prompt, max_new_tokens=args.max_new,
                    temperature=args.temperature)
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
    for r in reqs[:4]:
        print(f"  req{r.rid}: {r.out_tokens[:10]}{'...' if len(r.out_tokens) > 10 else ''}")
    if not all(r.done for r in reqs):
        raise RuntimeError("not every request finished")
    return reqs


if __name__ == "__main__":
    main()
