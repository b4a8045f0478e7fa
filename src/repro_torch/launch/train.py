"""Training launcher, the local mode of ``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --seq 4096 --batch 8 --microbatch 2 --steps 3 --moments-int8

trains the full-width model on the card (random init from seed 0, the
synthetic ``TokenPipeline`` stream of seed 0), with the AdamW moments
stored blockwise-int8 through the CUDA quantize / dequantize kernels.
``--reduced --device cpu`` trains a tiny model on the CPU through the
plain versions; ``--reduced`` alone also shrinks the default shape to a
CPU's size (batch 8, seq 64) unless ``--batch``/``--seq`` say otherwise.
Prints a ``[train]`` line per step and a final line.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import SHAPES, RunConfig, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.quant.ops import dequantize, quantize
from repro_torch.models.params import init_params
from repro_torch.optim.adamw import adamw_init
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer

#: --reduced's default shape (batch, seq): the tiny config on a CPU
REDUCED_SHAPE = (8, 64)


def build(cfg, run: RunConfig, device):
    """Params from seed ``run.seed``, AdamW state and the train step."""
    gen = torch.Generator(device=device)
    gen.manual_seed(run.seed)
    params = init_params(cfg, gen, device)
    opt = adamw_init(params, moments="int8" if run.moments_int8 else "f32")
    return params, opt, make_train_step(cfg, run)


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
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    shape = SHAPES[args.shape]
    if args.reduced:
        cfg = cfg.reduced()
        shape = ShapeConfig("reduced", REDUCED_SHAPE[1], REDUCED_SHAPE[0], "train")
    if args.batch or args.seq:
        shape = ShapeConfig("custom", args.seq or shape.seq_len,
                            args.batch or shape.global_batch, "train")
    run = RunConfig(learning_rate=args.lr, total_steps=args.steps,
                    warmup_steps=max(2, args.steps // 10),
                    microbatch=args.microbatch, moments_int8=args.moments_int8)
    print(f"[train] {cfg.name} on {device}: batch {shape.global_batch} x seq "
          f"{shape.seq_len}, microbatch {run.microbatch}, moments "
          f"{'int8' if run.moments_int8 else 'f32'}, remat {run.remat_policy}")
    quantize.launches = dequantize.launches = 0
    params, opt, step_fn = build(cfg, run, device)
    tr = Trainer(cfg, run, shape, step_fn=step_fn, params=params, opt_state=opt)
    tokens = shape.global_batch * shape.seq_len
    for _ in range(args.steps):
        rec = tr.run_steps(1)
        print(f"[train] step {rec['step']}: loss {rec['loss']:.4f} lr {rec['lr']:.3g} "
              f"grad_norm {rec['grad_norm']:.4g} {rec['seconds'] * 1e3:.1f} ms "
              f"({tokens / rec['seconds']:.1f} tok/s)")
    last = tr.history[-1]
    print(f"[train] done: step={last['step']} loss={last['loss']:.4f} "
          f"({last['seconds'] * 1e3:.0f} ms/step); kernel launches: "
          f"quantize={quantize.launches} dequantize={dequantize.launches}")
    return tr


if __name__ == "__main__":
    main()
