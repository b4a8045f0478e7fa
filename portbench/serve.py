"""The serve loop: closed-loop clients against ``ServeEngine.step()``.

Each client sends its next request when its last one completes. The
engine's three calls (``_prefill_request``, which ends in a host read
of the first token, ``_decode_compute`` and ``_finish_decode``, which
reads the step's tokens to the host) are timed on the host clock from
this file, wrapped on the engine instance; nothing in the program
changes. Set-up makes the weights, builds the engine, warms every
prefill bucket (or length) the traffic draws and the decode step, then
sends the first wave (one request a client) and admits it, so the
window opens with every slot busy.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import flops as FL
from portbench import trace as T
from portbench import traffic as TR
from portbench import weights

now = time.perf_counter


class Clients:
    """Host-clock record of every request and engine call."""

    def __init__(self, engine, pool: TR.RequestPool):
        self.engine, self.pool = engine, pool
        self.reqs: Dict[int, Dict] = {}
        self.prefills: List = []          # (t0, t1, prompt tokens)
        self.decodes: List = []           # (t0, t1, fills of the live rows)
        self.fills = [0] * engine.slots   # each slot's cache fill, as K2 reads it
        self.traced = False
        self.calls = T.Calls()
        self._wrap()

    def _range(self, name):
        return torch.profiler.record_function(name) if self.traced else contextlib.nullcontext()

    def _wrap(self):
        eng = self.engine
        prefill, compute, finish = eng._prefill_request, eng._decode_compute, eng._finish_decode

        def _prefill_request(req):
            t0 = now()
            with self._range("pb.prefill"):
                out = prefill(req)
            t1 = now()
            self.prefills.append((t0, t1, len(req.prompt)))
            self.reqs[req.rid]["times"].append(t1)
            return out

        def _decode_compute(act):
            live = [eng.active[s] for s in act]
            for s, r in zip(act, live):
                self.fills[s] = len(r.prompt) + len(r.out_tokens)
            self._step = (now(), [self.fills[s] for s in act])
            self.calls.context["fills"] = list(self.fills)
            with self._range("pb.decode"):
                return compute(act)

        def _finish_decode(act, logits):
            live = [eng.active[s] for s in act]
            with self._range("pb.finish"):
                out = finish(act, logits)
            t1 = now()
            for r in live:
                self.reqs[r.rid]["times"].append(t1)
            t0, fills = self._step
            self.decodes.append((t0, t1, fills))
            return out

        eng._prefill_request = _prefill_request
        eng._decode_compute = _decode_compute
        eng._finish_decode = _finish_decode

    def send(self):
        from repro_torch.serve.engine import Request
        rid, prompt, new = self.pool.next()
        self.reqs[rid] = {"sent": now(), "times": [], "prompt": prompt, "new": new}
        self.engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=new))

    def step(self) -> int:
        """One engine step; each request it completes sends its client's next."""
        self.engine.step()
        done, self.engine.finished = self.engine.finished, []
        for req in done:
            rec = self.reqs[req.rid]
            rec["out"] = list(req.out_tokens)
            rec["done"] = now()
            self.send()
        return len(done)


def kernel_patches(calls: T.Calls) -> list:
    """K1, K2 and K3 as the model calls them, each in its range."""
    import repro_torch.models.attention as A
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    def k1(q, k, v, **kw):
        b, s, hq, hd = q.shape
        return FL.k1(b, s, hq, k.shape[2], hd, q.element_size())

    def k2(q, kc, vc, cache_len, **kw):
        b, _, hq, hd = q.shape
        fills = [min(f, kc.shape[1]) for f in calls.context["fills"]][:b]
        return FL.k2(b, hq, kc.shape[2], hd, fills, q.element_size(), kc.element_size())

    def k3(x, dt, A_, Bm, C, **kw):
        b, s, h, p = x.shape
        return FL.k3(b, s, h, p, Bm.shape[-1], x.element_size(), Bm.element_size())

    return [(A, "flash_attention", "pb.k1", k1),
            (A, "decode_attention_kernel", "pb.k2", k2),
            (ssd_ops, "ssd_scan", "pb.k3", k3)]


def warm_lengths(traffic: Dict, engine) -> List[int]:
    """One prompt length for each prefill shape the traffic can draw: each
    power-of-two bucket its prompts fall in, or, for exact-length
    prefill, four lengths spread over the range."""
    lo, hi = TR.support(traffic["prompt"])
    if engine.bucket_prefill:
        out, n = [], lo
        while True:
            b = engine._bucket_len(n)
            out.append(min(b, hi))
            if b >= hi:
                return sorted(set(out))
            n = b + 1
    return sorted({int(x) for x in np.linspace(lo, hi, 4)})


def run(cfg: Dict, traffic: Dict, seed: int, seconds: float, trace: bool, device,
        pcfg) -> Dict:
    from repro_torch.serve.engine import Request, ServeEngine

    model = cfg["model"]
    params = weights.make(model, seed, device)
    engine = ServeEngine(pcfg, params, slots=int(traffic["slots"]),
                         max_len=int(traffic["max_len"]),
                         cache_dtype=getattr(torch, traffic.get("cache_dtype", "float32")),
                         bucket_prefill=bool(traffic.get("bucket_prefill", True)),
                         device=device)
    gen = TR.rng(seed, 3)
    for i, n in enumerate(warm_lengths(traffic, engine)):
        engine.submit(Request(rid=-1 - i, prompt=gen.integers(0, model["vocab_size"], n)
                              .astype(np.int32), max_new_tokens=2))
    engine.run()
    pool = TR.RequestPool(traffic, seed, model["vocab_size"])
    cl = Clients(engine, pool)
    for _ in range(int(traffic["clients"])):
        cl.send()
    cl.step()                                     # admits the first wave
    _sync(device)

    t0 = now()
    while now() - t0 < seconds:
        cl.step()
    _sync(device)
    t1 = now()
    rec = {"kind": "serve", "t0": t0, "t1": t1, "model": model,
           "reqs": cl.reqs, "prefills": cl.prefills, "decodes": cl.decodes,
           "attempted": sum(1 for r in cl.reqs.values() if t0 <= r["sent"] <= t1)}
    if trace:
        rec["trace"] = _traced(cl, device, float(traffic.get("trace_seconds", 2.0)))
    rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if _cuda(device) else 0
    rec["failed"] = 0
    rec["sample"] = _sample(cl.reqs, t0, t1, traffic["check"], seed)
    del engine, cl
    gc.collect()
    if _cuda(device):
        torch.cuda.empty_cache()
    rec["params"] = params
    return rec


def _traced(cl: Clients, device, seconds: float) -> Dict:
    """The loop continued for ``seconds`` under the profiler, the
    kernels and the engine's calls in ranges."""
    calls = cl.calls
    with T.wrapped(kernel_patches(calls), calls):
        cl.traced = True
        cl.step()                                 # the ranges' first calls, untraced
        _sync(device)
        with T.profiler() as prof:
            with torch.profiler.record_function("pb.trace"):
                calls.on = True
                t0 = now()
                while now() - t0 < seconds:
                    with torch.profiler.record_function("pb.step"):
                        cl.step()
                _sync(device)
                calls.on = False
        cl.traced = False
    out = T.reduce(prof)
    out["calls"] = calls.rows
    return out


def _sample(reqs: Dict, t0: float, t1: float, check: Dict, seed: int) -> List[Dict]:
    """Requests finished in the window, drawn from the seed: the longest
    first, then others until ``check["tokens"]`` served tokens."""
    done = [r for r in reqs.values() if "out" in r and t0 <= r["done"] <= t1]
    if not done:
        return []
    done.sort(key=lambda r: -(len(r["prompt"]) + len(r["out"])))
    pick, rest = [done[0]], done[1:]
    order = TR.rng(seed, 4).permutation(len(rest))
    tokens = len(done[0]["out"])
    for i in order:
        if tokens >= int(check["tokens"]) or len(pick) >= int(check.get("max_requests", 64)):
            break
        pick.append(rest[i])
        tokens += len(rest[i]["out"])
    return [{"prompt": r["prompt"], "out": r["out"]} for r in pick]


def _cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def _sync(device) -> None:
    if _cuda(device):
        torch.cuda.synchronize()
