"""The train loop: the program's train step driven from the seed.

Set-up builds one object, the step from ``make_train_step`` with its f32
master weights (the benchmark's, drawn from the seed) and AdamW state
(f32 or int8 moments, as the traffic says), and drives it through ``setup_steps`` steps on the window's own
feed; the window then runs the same object on. Each step's batch is
``batch`` rows of ``seq + 1`` random ids drawn on the device from the
seed and the step's index (tokens the first ``seq``, labels the last),
so every row differs. What the check needs from the set-up steps is
read as they pass: each step's loss, the first gradient as the
optimizer holds it (its m after one step over ``1 - b1``, by leaf)
and each leaf's change from its seed value (drawn again leaf by leaf)
after the last set-up step. The learning-rate schedule counts steps
from ``FIRST_STEP``.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from portbench import flops as FL
from portbench import trace as T
from portbench import traffic as TR
from portbench import weights

now = time.perf_counter
FIRST_STEP = 1


def batch(model: Dict, traffic: Dict, seed: int, step: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device)
    gen.manual_seed(TR.device_seed(seed, 5, step))
    b, s = int(traffic["batch"]), int(traffic["seq"])
    ids = torch.randint(0, model["vocab_size"], (b, s + 1), generator=gen, device=device)
    return {"tokens": ids[:, :-1], "labels": ids[:, 1:],
            "loss_mask": torch.ones((b, s), dtype=torch.float32, device=device)}


def run_config(traffic: Dict):
    from repro_torch.configs.base import RunConfig
    o = traffic["optimizer"]
    return RunConfig(learning_rate=o["lr"], warmup_steps=o["warmup_steps"],
                     total_steps=o["total_steps"], weight_decay=o["weight_decay"],
                     b1=o["b1"], b2=o["b2"], eps=o["eps"], grad_clip=o["grad_clip"],
                     microbatch=int(traffic["microbatch"]), remat_policy=traffic["remat"],
                     moments_int8=traffic["moments"] == "int8")


def _leaf_norms(model: Dict, tree, fn) -> Dict:
    return {p: float(fn(p, weights.get(tree, p))) for p in weights.paths(model)}


def change_norms(model: Dict, tree, seed: int, device) -> Dict:
    """Each leaf's distance from its seed value, drawn again leaf by leaf."""
    return _leaf_norms(model, tree, lambda p, t: torch.linalg.vector_norm(
        t.detach() - weights.leaf(model, p, seed, device, dtype=torch.float32)))


def _moment_norm(m) -> torch.Tensor:
    """The norm of a moment leaf: f32, or int8 blocks (``q``) with a scale each."""
    if isinstance(m, torch.Tensor):
        return torch.linalg.vector_norm(m)
    return torch.linalg.vector_norm(m.q.float() * m.scale[:, None])


def run(cfg: Dict, traffic: Dict, seed: int, seconds: float, trace: bool, device,
        pcfg) -> Dict:
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.train_step import make_train_step

    model = cfg["model"]
    rc = run_config(traffic)
    params = weights.make(model, seed, device, masters=True)
    opt = adamw_init(params, moments=traffic["moments"])
    step_fn = make_train_step(pcfg, rc)

    def step(i):
        return step_fn(params, opt, batch(model, traffic, seed, i, device), FIRST_STEP + i)

    losses: List[float] = []
    grad1 = None
    for i in range(int(traffic["setup_steps"])):
        params, opt, met = step(i)
        losses.append(float(met["loss"]))
        if i == 0:
            grad1 = _leaf_norms(model, opt.m, lambda p, m: _moment_norm(m) / (1 - rc.b1))
    change = change_norms(model, params, seed, device)
    _sync(device)

    tokens = int(traffic["batch"]) * int(traffic["seq"])
    steps: List = []
    t0 = now()
    i = int(traffic["setup_steps"])
    while now() - t0 < seconds:
        s0 = now()
        params, opt, met = step(i)
        float(met["loss"])                          # waits for the step
        steps.append((s0, now()))
        i += 1
    t1 = now()
    rec = {"kind": "train", "t0": t0, "t1": t1, "steps": steps,
           "tokens_per_step": tokens,
           "flops_per_step": FL.train_step_flops(model, int(traffic["batch"]),
                                                 int(traffic["seq"])),
           "attempted": len(steps), "failed": 0}
    if trace:
        rec["trace"] = _traced(step, i, device)
    rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if _cuda(device) else 0
    rec["program"] = {"losses": losses, "grad1": grad1, "change": change}
    del params, opt, step_fn, met
    gc.collect()
    if _cuda(device):
        torch.cuda.empty_cache()
    return rec


def kernel_patches(calls: T.Calls) -> list:
    """K4a and K4b as the optimizer calls them; the loss and the optimizer
    in ranges of their own."""
    import repro_torch.optim.adamw as AD
    import repro_torch.train.train_step as TS

    def quant(x, block=256):
        return FL.k4_quantize(x.numel(), x.element_size(), block)

    def dequant(qt, shape, dtype=torch.float32):
        n = 1
        for d in shape:
            n *= int(d)
        return FL.k4_dequantize(n, torch.empty((), dtype=dtype).element_size())

    return [(AD, "quantize_int8_blockwise", "pb.k4", quant),
            (AD, "dequantize_int8_blockwise", "pb.k4", dequant),
            (TS, "loss_fn", "pb.forward", None),
            (TS, "adamw_update", "pb.optimizer", None)]


def _traced(step, i: int, device) -> Dict:
    """One more step, after the window, under the profiler."""
    calls = T.Calls()
    with T.wrapped(kernel_patches(calls), calls):
        with T.profiler() as prof:
            with torch.profiler.record_function("pb.trace"):
                calls.on = True
                with torch.profiler.record_function("pb.step"):
                    step(i)
                _sync(device)
                calls.on = False
    out = T.reduce(prof)
    out["calls"] = calls.rows
    out["steps"] = 1
    return out


def _cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def _sync(device) -> None:
    if _cuda(device):
        torch.cuda.synchronize()
