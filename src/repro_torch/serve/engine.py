"""Batched serving: prefill + continuous-batching decode, two runtimes,
the counterpart of ``repro/serve/engine.py``.

Slot model: a fixed decode batch of ``slots``; each slot holds one
request's cache rows (K/V, or SSM states). A new request is prefilled
alone, at a power-of-two bucketed length for attention-only configs and
at its exact length for configs with SSM layers; its cache rows are
copied into a free slot, and each decode step advances every active slot
one token with per-row positions.

Two engines share the compute core (``_EngineCore``):

``ServeEngine``       the synchronous baseline: ``step()`` = admit (each
                      prefill runs to completion, blocking everything)
                      + one decode step. Optionally timestamps its work
                      on a ``FabricRuntime`` so it is comparable with
                      the staged engine on the same simulated timeline.
``StagedServeEngine`` the event-driven pipeline: ``PrefillStage``
                      prefills queued requests as soon as they arrive
                      (overlapping transfers fair-share the prefill
                      path), ``AdmitStage`` copies ready caches into
                      free slots, re-planning the §5.2 decode-cache
                      placement per admitted request from the live
                      ledger, and ``DecodeStage`` advances active slots
                      while prefill transfers are still in flight; with
                      ``decode_pool`` its cache reads are sharded over a
                      pool of ``DecodeReplica`` processes that can be
                      added and retired mid-run.

Both engines produce identical greedy tokens: each decode-batch row is
independent (per-row positions and masks, and every product sees all
``slots`` rows whichever are active), so overlap changes *when* a token
exists on the simulated clock, never *which* token it is. The
simulated-time model is ``ServeTimeModel``: the model computes eagerly,
and its communication (the prefilled KV cache shipping to its slot, the
per-step decode cache reads) is charged as fabric transfers whose
amounts come from prompt lengths and slot counts only, so the timeline
is the JAX engine's to the bit, whatever device computes.

``compute="sim"`` replaces the model with a deterministic per-request
token stream (``_sim_token``, JAX's) and needs no config, weights or
device. With ``compute="torch"`` (the default) the model runs on
``device`` (``cuda`` unless the caller asks for the CPU): on the card
(``impl="auto"``) attention prefill runs the CUDA flash-attention
kernel and attention decode the CUDA flash-decoding kernel; SSM prefill
runs the CUDA SSD-scan kernel and SSM decode the one-token recurrence
in plain tensor ops. On the CPU every kernel takes its plain version.
All device work of both engines is issued on the current stream, in
program order: the in-place cache and position writes of a slot
admitted while a decode step is in flight follow that step's reads.

On the card, with ``impl="auto"`` (and, for a config with MoE layers,
no mesh: ``decode_graph.applies``), the decode step is captured as CUDA graphs
at the first decode step and replayed from then on
(``serve/decode_graph.py``: one graph between each two attention layers'
decode attention, which is launched eagerly between the replays), for
the engine's fixed batch of ``slots`` rows, its cache, positions and
weights in place. ``stats["decode_graph_replays"]`` counts the replayed
steps; only such an engine has the key, so a CPU engine's ``stats`` stay
the JAX engine's. A replayed step's logits are the graph's static
output: they hold until the next decode step overwrites them, which is
after both engines have read them (``StagedServeEngine``'s
``DecodeStage`` reads them across its yield; its next step comes after).

``ServeEngine(host_tracer=HostTracer())`` (``obs/host.py``) records the
synchronous engine's real work on the host's wall clock, each phase in
the profiler's timeline while one records: ``serve.request`` (submit to
retirement; ``rid``, prompt and output tokens), ``serve.step`` (``active``
rows, requests ``admitted``, ``host_syncs``: 2 for a greedy decode step,
1 for each prefill), ``serve.admit``, ``serve.prefill`` (``rid``,
``tokens``, ``bucket``) with ``serve.prefill.enqueue`` (the model and the
sampling call) and ``serve.prefill.sync`` (the first token's host read),
``serve.splice``, ``serve.decode`` (``graphed``, and the graph's
``pieces``, 0 when eager; the first replayed step also captures) with
``serve.decode.inputs`` and ``serve.decode.enqueue``, and
``serve.finish`` with ``serve.finish.sync`` (the step's token and
position reads). ``serve.prefill`` and ``serve.decode`` also carry
``moe_layers`` and ``moe_rows``: the rows the MoE layers' lossless
buffers compute in the call, ``E_held x T`` a layer for its T tokens
(the bucket, or ``slots``), reckoned on the host (0 without MoE layers
or off the card). Without a tracer (the default) each
site costs one test of ``None``; tracing changes no token.

An engine on the card whose config has MoE layers also counts, in
``stats``: ``moe_rows_computed``, the same rows summed on the host, and
``moe_assignments_held``, the (token, k) assignments its held experts
kept, added up on the device (inside the graph too) and read only when
``stats`` is read. Their ratio is the share of the lossless buffers'
rows that hold a routed token. A CPU engine has neither key, so its
``stats`` stay the JAX engine's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.port import held_experts
from repro_torch.core.fabric import Fabric
from repro_torch.core.runtime import FabricRuntime, Signal
from repro_torch.models import model as M
from repro_torch.models.params import compute_copy, layer_period, num_groups, slot_kind
from repro_torch.serve import decode_graph


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (S,) token ids
    max_new_tokens: int = 16
    temperature: float = 0.0
    arrival: float = 0.0                # simulated arrival time (seconds)
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    first_token_time: Optional[float] = None   # simulated TTFT timestamp
    finish_time: Optional[float] = None
    placement: Optional[str] = None     # decode-cache placement decision

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival


@dataclasses.dataclass(frozen=True)
class ServeTimeModel:
    """How engine work maps onto fabric transfers (simulated time).

    ``prefill_path`` carries one transfer of
    ``prompt_len * prefill_units_per_token`` per admitted request (the
    prefilled KV cache shipping to its decode slot); ``decode_path``
    carries ``n_active * decode_units_per_slot`` per decode step (the
    batched cache read). ``placement_paths`` optionally routes a slot's
    decode traffic by its ``PlacementPlan.location`` (e.g.
    ``{"soc_cache": "soc_read", "host": "host_read"}``)."""
    prefill_path: str
    decode_path: str
    prefill_units_per_token: float = 1.0
    decode_units_per_slot: float = 1.0
    placement_paths: Optional[Dict[str, str]] = None

    def decode_path_for(self, placement: Optional[str]) -> str:
        if self.placement_paths and placement in self.placement_paths:
            return self.placement_paths[placement]
        return self.decode_path


class _EngineCore:
    """Model compute + slot bookkeeping shared by both engines.

    ``compute`` selects the token source: ``"torch"`` (default) runs the
    real model; ``"sim"`` replaces prefill/decode with a deterministic
    per-request hash stream (``_sim_token``) and needs no ``cfg``,
    ``params`` or device. The slot model, queues, timestamps and fabric
    transfers are identical either way.

    ``params`` are the f32 master weights; the engine keeps a bf16 copy
    of the matrices (``compute_copy``, which returns bf16 leaves as they
    are), the values the JAX engine casts to before every product."""

    MIN_BUCKET = 8

    def __init__(self, cfg: Optional[ModelConfig], params: Any, *,
                 slots: int = 4, max_len: int = 256, impl: str = "auto",
                 cache_dtype: torch.dtype = torch.float32, seed: int = 0,
                 bucket_prefill: bool = True, compute: str = "torch",
                 device=None, host_tracer=None):
        if compute not in ("torch", "sim"):
            raise ValueError(f"compute must be 'torch' or 'sim', got {compute!r}")
        self.compute = compute
        self.slots, self.max_len, self.impl = slots, max_len, impl
        self.cache_dtype = cache_dtype
        self.tenant: Optional[str] = None   # QoS tag on fabric transfers
        #: (completion sim-time, ttft) samples — admission control input
        self.ttft_log: List[Tuple[float, float]] = []
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: List[Request] = []
        self.finished: List[Request] = []   # retired, not yet drained by run()
        self._stats: Dict[str, float] = {
            "prefill_tokens": 0, "decode_steps": 0,
            "prefill_compilations": 0, "prefill_padded_tokens": 0}
        self._moe_layers = 0                       # MoE layers, when counted (below)
        self._held: Optional[torch.Tensor] = None  # assignments kept, on the device
        self._compiled_buckets: set = set()
        self.host_tracer = host_tracer
        self._request_spans: Dict[int, Any] = {}   # id(request) -> its open span
        self._host_syncs = 0                       # this step's host reads, when traced
        self._graph: Optional[decode_graph.DecodeGraph] = None  # made at the first decode step
        self._graphed = False
        if compute == "sim":
            self.cfg, self.params, self.device = cfg, params, None
            self.cache = None
            self.pos = np.zeros((slots,), np.int64)
            self.bucket_prefill = False
            return
        if cfg is None:
            raise ValueError("compute='torch' needs a ModelConfig")
        self.device = resolve_device(device)
        self.cfg, self.params = cfg, compute_copy(params)
        self.cache = M.init_cache(cfg, slots, max_len, cache_dtype, self.device)
        self.pos = torch.zeros((slots,), dtype=torch.int32, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        # bucketing needs causal attention's inert pad tail; SSM state
        # runs through every position, so those configs prefill exact.
        attn_only = all(slot_kind(cfg, s)["kind"] == "attn"
                        for s in range(layer_period(cfg)))
        self.bucket_prefill = bucket_prefill and attn_only
        self._graphed = decode_graph.applies(cfg, self.device, impl)
        if self._graphed:
            self._stats["decode_graph_replays"] = 0
        moe_layers = num_groups(cfg) * sum(slot_kind(cfg, s)["moe"]
                                           for s in range(layer_period(cfg)))
        if moe_layers and self.device.type == "cuda":
            self._moe_layers = moe_layers
            self._held = torch.zeros((), dtype=torch.int64, device=self.device)
            self._stats["moe_rows_computed"] = 0
            self._stats["moe_assignments_held"] = 0

    @property
    def stats(self) -> Dict[str, float]:
        """The engine's counters. ``moe_assignments_held`` is read from the
        device here, and only here."""
        if self._held is not None:
            self._stats["moe_assignments_held"] = int(self._held)
        return self._stats

    def _moe_rows(self, tokens: int) -> int:
        """Rows the MoE layers' lossless buffers compute for a call on
        ``tokens`` tokens: ``E_held x tokens`` a layer, reckoned on the host."""
        rows = self._moe_layers * held_experts(self.cfg) * tokens
        if rows:
            self._stats["moe_rows_computed"] += rows
        return rows

    @staticmethod
    def _sim_token(rid: int, i: int) -> int:
        """Deterministic token ``i`` of request ``rid`` in sim mode."""
        return (rid * 1315423911 + i * 2654435761) & 0x7FFF

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        if self.host_tracer is not None:
            self._request_spans[id(req)] = self.host_tracer.begin_phase(
                "serve.request", tenant="requests", rid=req.rid,
                prompt_tokens=len(req.prompt))
        self.queue.append(req)

    def _bucket_len(self, n: int) -> int:
        """Pad target: next power of two (>= MIN_BUCKET), clamped to the
        cache length so the padded prefill still fits."""
        if not self.bucket_prefill:
            return n
        bucket = max(self.MIN_BUCKET, 1 << (max(n - 1, 0)).bit_length())
        return bucket if bucket <= self.max_len else n

    def _prefill_request(self, req: Request) -> Tuple[Any, int]:
        """Prefill one request (bucketed): appends the first output token
        and returns (cache_row, next_pos)."""
        if self.compute == "sim":
            n = len(np.asarray(req.prompt))
            req.out_tokens.append(self._sim_token(req.rid, 0))
            self._stats["prefill_tokens"] += n
            return None, n
        ht = self.host_tracer
        prompt = np.asarray(req.prompt)                  # (S,) or (S, C)
        n = prompt.shape[0]
        bucket = self._bucket_len(n)
        moe_rows = self._moe_rows(bucket)
        if ht is not None:
            span = ht.open("serve.prefill", rid=req.rid, tokens=n, bucket=bucket,
                           moe_layers=self._moe_layers, moe_rows=moe_rows)
        if bucket > n:
            pad = np.zeros((bucket - n,) + prompt.shape[1:], prompt.dtype)
            prompt = np.concatenate([prompt, pad])
        # a prefill "compilation" is a distinct bucket, as in the JAX engine
        self._compiled_buckets.add((bucket,) + prompt.shape[1:])
        toks = torch.as_tensor(prompt, device=self.device)[None]        # (1, S[,C])
        if ht is not None:
            part = ht.open("serve.prefill.enqueue")
        logits, cache1, npos = M.prefill(self.cfg, self.params, toks, self.max_len,
                                         impl=self.impl, cache_dtype=self.cache_dtype,
                                         length=n, held_count=self._held)
        tok = self._sample(logits[:, -1], req.temperature)
        if ht is not None:
            ht.close(part)
            part = ht.open("serve.prefill.sync")
        # codebook 0 only, as the JAX engine keeps it (engine.py:184); the
        # first decode step feeds it to every codebook
        req.out_tokens.append(int(tok.reshape(-1)[0]))
        if ht is not None:
            ht.close(part)
            self._host_syncs += 1
        self._stats["prefill_tokens"] += n
        self._stats["prefill_padded_tokens"] += bucket - n
        self._stats["prefill_compilations"] = len(self._compiled_buckets)
        if ht is not None:
            ht.close(span)
        return cache1, npos

    def _splice_cache(self, slot: int, row_cache):
        """Copy a prefilled (batch=1) cache into slot ``slot``, in place:
        every leaf of a slot (K/V, or the SSM state ``h`` and the conv
        states) has the batch at dim 1. (JAX's ``.at[:, slot].set`` builds
        a new cache instead.)"""
        for dst, src in zip(self.cache, row_cache):
            for name in dst:
                dst[name][:, slot].copy_(src[name][:, 0])

    def _activate(self, slot: int, req: Request, cache1, npos: int):
        if self.compute == "sim":
            self.pos[slot] = npos
            self.active[slot] = req
            return
        if self.host_tracer is not None:
            span = self.host_tracer.open("serve.splice")
        self._splice_cache(slot, cache1)
        if self.host_tracer is not None:
            self.host_tracer.close(span)
        self.pos[slot] = npos
        self.active[slot] = req

    def _sample(self, logits: torch.Tensor, temperature: float) -> torch.Tensor:
        """Greedy at temperature 0, else a draw from softmax(logits / T)
        with the engine's generator (not the JAX engine's numbers)."""
        if temperature <= 0:
            return logits.argmax(dim=-1)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[..., 0]

    # ------------------------------------------------------------------
    def _decode_compute(self, act: List[int]) -> Optional[torch.Tensor]:
        """One decode step for all slots; returns logits (B,1,V), or
        (B,1,C,V) for codebooks. Replayed (module docstring), they are the
        graph's output and hold until the next decode step."""
        if self.compute == "sim":
            for s in range(self.slots):
                if self.active[s] is not None:
                    self.pos[s] += 1
            self._stats["decode_steps"] += 1
            return None
        ht = self.host_tracer
        if ht is not None:
            span = ht.open("serve.decode", active=len(act))
        if self._graphed and self._graph is None:
            self._graph = decode_graph.DecodeGraph(self.cfg, self.params, self.cache,
                                                   self.pos, self.cache_dtype, self._held)
        graph = self._graph
        if ht is not None:
            part = ht.open("serve.decode.inputs")
        cb = self.cfg.num_codebooks
        last = np.zeros((self.slots,) + ((cb,) if cb > 1 else ()), np.int64)
        for s in act:
            last[s] = self.active[s].out_tokens[-1]
        if graph is None:
            tokens = torch.as_tensor(last, device=self.device)[:, None]     # (B,1[,C])
        else:
            graph.tokens.copy_(torch.from_numpy(last).view(graph.tokens.shape))
        if ht is not None:
            ht.close(part)
            part = ht.open("serve.decode.enqueue")
        if graph is None:
            logits, self.cache = M.decode_step(self.cfg, self.params, tokens,
                                               self.cache, self.pos, impl=self.impl,
                                               held_count=self._held)
        else:
            logits = graph.replay()
            self._stats["decode_graph_replays"] += 1
        if ht is not None:
            ht.close(part)
        live = [1 if self.active[s] is not None else 0 for s in range(self.slots)]
        self.pos += torch.as_tensor(live, dtype=torch.int32, device=self.device)
        self._stats["decode_steps"] += 1
        moe_rows = self._moe_rows(self.slots)
        if ht is not None:
            ht.close(span, graphed=graph is not None,
                     pieces=0 if graph is None else graph.pieces,
                     moe_layers=self._moe_layers, moe_rows=moe_rows)
        return logits

    def _finish_decode(self, act: List[int], logits) -> List[Request]:
        """Append sampled tokens, retire finished requests. Only the
        ``act`` slots are read: in the staged engine a slot admitted
        while this step was in flight is not part of it."""
        if self.compute == "sim":
            retired = []
            for s in act:
                req = self.active[s]
                req.out_tokens.append(
                    self._sim_token(req.rid, len(req.out_tokens)))
                if len(req.out_tokens) >= req.max_new_tokens or \
                        int(self.pos[s]) >= self.max_len - 1:
                    req.done = True
                    self.active[s] = None
                    self.finished.append(req)
                    retired.append(req)
            return retired
        ht = self.host_tracer
        if ht is not None:
            span = ht.open("serve.finish")
            part = ht.open("serve.finish.sync")
        nxt = logits[:, 0].argmax(dim=-1).cpu().numpy()    # host sync; (B,[C])
        pos = self.pos.cpu().numpy()
        if ht is not None:
            ht.close(part)
            self._host_syncs += 2 + sum(self.active[s].temperature > 0 for s in act)
        retired: List[Request] = []
        for s in act:
            req = self.active[s]
            if req.temperature > 0:
                val = self._sample(logits[s:s + 1, 0], req.temperature).cpu().numpy()
            else:
                val = nxt[s]
            val = val.reshape(-1)
            req.out_tokens.append(int(val[0]) if val.size == 1 else val.tolist())
            if len(req.out_tokens) >= req.max_new_tokens or \
                    int(pos[s]) >= self.max_len - 1:
                req.done = True
                self.active[s] = None
                self.finished.append(req)
                retired.append(req)
                if ht is not None:
                    ht.end_phase(self._request_spans.pop(id(req), None),
                                 output_tokens=len(req.out_tokens))
        if ht is not None:
            ht.close(span)
        return retired

    def _free_slot(self) -> Optional[int]:
        for s in range(self.slots):
            if self.active[s] is None:
                return s
        return None


class ServeEngine(_EngineCore):
    """Synchronous engine: ``step()`` admits queued requests into free
    slots (each prefill runs to completion) and runs one decode step.

    Optional ``runtime`` + ``time_model`` charge each prefill and decode
    step as *blocking* fabric transfers, putting this engine on the same
    simulated timeline as StagedServeEngine — with zero overlap, which
    is exactly the baseline the staged pipeline is measured against.
    ``fabric`` plans the §5.2 decode-cache placement once, at init.
    ``host_tracer`` records the engine's phases (module docstring)."""

    def __init__(self, cfg: ModelConfig, params: Any, *, slots: int = 4,
                 max_len: int = 256, impl: str = "auto",
                 cache_dtype: torch.dtype = torch.float32, seed: int = 0,
                 fabric: Optional[Fabric] = None,
                 cache_hit_mass: float = 0.7, placement_costs=None,
                 runtime: Optional[FabricRuntime] = None,
                 time_model: Optional[ServeTimeModel] = None,
                 bucket_prefill: bool = True,
                 tenant: Optional[str] = None, device=None, host_tracer=None):
        super().__init__(cfg, params, slots=slots, max_len=max_len, impl=impl,
                         cache_dtype=cache_dtype, seed=seed,
                         bucket_prefill=bucket_prefill, device=device,
                         host_tracer=host_tracer)
        self.runtime, self.tm = runtime, time_model
        self.tenant = tenant
        if runtime is not None and time_model is None:
            raise ValueError("a runtime needs a ServeTimeModel")
        self.placement = None
        if fabric is not None:
            from repro_torch.serve.disagg import plan_decode_placement
            self.placement = plan_decode_placement(
                fabric, hit_mass=cache_hit_mass, costs=placement_costs)

    # ------------------------------------------------------------------
    def _charge(self, path: str, amount: float, flow: str) -> None:
        """Run a transfer to completion (the sync engine blocks on it)."""
        if self.runtime is None or amount <= 0:
            return
        tr = self.runtime.transfer(path, amount, flow=flow,
                                   tenant=self.tenant)
        self.runtime.clock.run(stop=lambda: tr.done)

    def _now(self) -> Optional[float]:
        return self.runtime.clock.now if self.runtime is not None else None

    def _arrived(self, req: Request) -> bool:
        return self.runtime is None or req.arrival <= self.runtime.clock.now

    def _advance_to_next_arrival(self) -> None:
        """When idle but requests are still due, jump the clock."""
        if self.runtime is None or any(a is not None for a in self.active):
            return
        pending = [r.arrival for r in self.queue
                   if r.arrival > self.runtime.clock.now]
        if pending and not any(self._arrived(r) for r in self.queue):
            self.runtime.clock.run(until=min(pending))

    def _admit(self):
        if self.host_tracer is not None:
            span = self.host_tracer.open("serve.admit")
        for s in range(self.slots):
            if self.active[s] is not None:
                continue
            idx = next((i for i, r in enumerate(self.queue)
                        if self._arrived(r)), None)
            if idx is None:
                break
            req = self.queue.pop(idx)
            if self.placement is not None:
                req.placement = self.placement.location
            cache1, npos = self._prefill_request(req)
            if self.tm is not None:
                amt = len(np.asarray(req.prompt)) * self.tm.prefill_units_per_token
                self._charge(self.tm.prefill_path, amt, f"prefill:{req.rid}")
            req.first_token_time = self._now()
            if req.first_token_time is not None:
                self.ttft_log.append((req.first_token_time, req.ttft))
            self._activate(s, req, cache1, npos)
        if self.host_tracer is not None:
            self.host_tracer.close(span)

    # ------------------------------------------------------------------
    def step(self) -> int:
        """Admit + one decode step for all active slots. Returns the
        number of active requests."""
        ht = self.host_tracer
        if ht is None:
            return self._step()
        span = ht.open("serve.step")
        queued, self._host_syncs = len(self.queue), 0
        n = self._step()
        ht.close(span, active=n, admitted=queued - len(self.queue),
                 host_syncs=self._host_syncs)
        return n

    def _step(self) -> int:
        self._advance_to_next_arrival()
        self._admit()
        act = [s for s in range(self.slots) if self.active[s] is not None]
        if not act:
            return 0
        logits = self._decode_compute(act)
        if self.tm is not None:
            placements = {self.active[s].placement for s in act}
            for pl in sorted(placements, key=str):
                n = sum(1 for s in act if self.active[s].placement == pl)
                self._charge(self.tm.decode_path_for(pl),
                             n * self.tm.decode_units_per_slot, f"decode:{pl}")
        retired = self._finish_decode(act, logits)
        for req in retired:
            req.finish_time = self._now()
        return len(act)

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drive step() until queues drain; returns (and drains) the
        requests retired since the last run() call, in retirement order."""
        steps = 0
        while (self.queue or any(self.active)) and steps < max_steps:
            self.step()
            steps += 1
        completed, self.finished = self.finished, []
        return completed


# ----------------------------------------------------------------------
# the staged pipeline
# ----------------------------------------------------------------------

class PrefillStage:
    """Dispatches a prefill process per arrived request: real prefill
    compute, then the KV-cache transfer over ``tm.prefill_path``.
    Concurrent prefills fair-share the path (``max_inflight`` bounds
    them); TTFT is stamped at transfer completion — *before* a decode
    slot is free, which is where the staged win over the synchronous
    engine comes from."""

    def __init__(self, engine: "StagedServeEngine", max_inflight: int = 2):
        self.engine = engine
        self.max_inflight = max_inflight
        self.inflight = 0

    def process(self):
        eng = self.engine
        while True:
            while eng.queue and not eng.intake_paused \
                    and self.inflight < self.max_inflight:
                req = eng.queue.pop(0)
                self.inflight += 1
                eng.runtime.process(self._one(req), name=f"prefill:{req.rid}")
            yield eng.arrived

    def _one(self, req: Request):
        eng, tm = self.engine, self.engine.tm
        cache1, npos = eng._prefill_request(req)
        amt = len(np.asarray(req.prompt)) * tm.prefill_units_per_token
        if amt > 0:
            yield eng.runtime.transfer(tm.prefill_path, amt,
                                       flow=f"prefill:{req.rid}",
                                       tenant=eng.tenant)
        req.first_token_time = eng.clock.now
        eng.ttft_log.append((req.first_token_time, req.ttft))
        eng.ready.append((req, cache1, npos))
        self.inflight -= 1
        eng.arrived.fire()        # the dispatcher may start the next prefill
        eng.admittable.fire()


class AdmitStage:
    """Moves prefilled requests into free decode slots. With
    ``plan_placement`` the §5.2 decode-cache placement is re-evaluated
    *per admitted request* against the live ledger (current holders and
    reservations), not once at startup."""

    def __init__(self, engine: "StagedServeEngine"):
        self.engine = engine

    def process(self):
        eng = self.engine
        while True:
            admitted = False
            while eng.ready:
                s = eng._free_slot()
                if s is None:
                    break
                req, cache1, npos = eng.ready.pop(0)
                if eng.plan_placement:
                    req.placement = eng._plan_placement().location
                    eng.placements[req.placement] = \
                        eng.placements.get(req.placement, 0) + 1
                eng._activate(s, req, cache1, npos)
                admitted = True
            if admitted:
                eng.decodable.fire()
            yield eng.admittable


class DecodeReplica:
    """One decode-path worker in the engine's replica pool: a runtime
    Process that claims per-slot cache-read shards from
    ``engine._decode_items`` and moves them *concurrently* over its own
    path. The base replica (``fallback=True``) rides the time model's
    default decode path and only serves while no extra replicas exist —
    scaling out *moves* the decode traffic off the shared path instead
    of adding to it. Retirement cancels the in-flight shard transfers;
    the completion callback re-queues each unmoved remainder — work is
    deferred to the survivors, never lost, so token streams are
    bit-identical across scale events."""

    def __init__(self, engine: "StagedServeEngine", path: str,
                 fallback: bool = False):
        self.engine = engine
        self.path = path
        self.fallback = fallback
        self.retired = False
        self.proc = None
        self.inflight: List = []

    def serve(self):
        eng = self.engine
        while True:
            if eng._decode_items and not (self.fallback and eng._extras()):
                # claim my fair share of the queued shards (ceil split
                # over the serving replicas); a straggler shard left by
                # rounding re-fires the signal and drains at the same
                # simulated instant
                live = len(eng._extras()) or 1
                take = min(-(-len(eng._decode_items) // live),
                           len(eng._decode_items))
                for _ in range(take):
                    amt = eng._decode_items.pop(0)
                    # accounting lives in the completion callback, not
                    # after a yield: a retired replica's generator is
                    # closed, but its callbacks still run
                    t = eng.runtime.transfer(
                        self.path, amt, flow=f"decode:{self.path}",
                        tenant=eng.tenant, on_complete=self._shard_done)
                    self.inflight.append(t)
                if eng._decode_items:
                    eng.decode_work.fire()
            yield eng.decode_work

    def _shard_done(self, t) -> None:
        if t in self.inflight:
            self.inflight.remove(t)
        self.engine._on_decode_shard_done(t)


class DecodeStage:
    """Advances every active slot one token per iteration; the step's
    batched cache read is charged as transfers on the decode path(s),
    overlapping any in-flight prefill transfers. With the engine's
    replica pool enabled, default-path reads are sharded across the
    live replicas while explicitly-placed reads keep their paths."""

    def __init__(self, engine: "StagedServeEngine"):
        self.engine = engine

    def process(self):
        eng, tm = self.engine, self.engine.tm
        while True:
            act = [s for s in range(eng.slots) if eng.active[s] is not None]
            if not act:
                if eng._n_open == 0:
                    return
                yield eng.decodable
                continue
            logits = eng._decode_compute(act)
            groups: Dict[str, int] = {}
            for s in act:
                path = tm.decode_path_for(eng.active[s].placement)
                groups[path] = groups.get(path, 0) + 1
            # start every placement group's cache read at once; the step
            # completes when the slowest path drains
            transfers = []
            pool_amt, pool_slots = 0.0, 0
            for path in sorted(groups):
                amt = groups[path] * tm.decode_units_per_slot
                if amt <= 0:
                    continue
                if eng._decode_pool and path == tm.decode_path:
                    pool_amt += amt
                    pool_slots += groups[path]
                else:
                    transfers.append(eng.runtime.transfer(
                        path, amt, flow=f"decode:{path}", tenant=eng.tenant))
            if pool_amt > 0:
                eng._dispatch_decode_pool(pool_amt, pool_slots)
            for tr in transfers:
                yield tr
            while eng._decode_open_amt > 1e-9:
                yield eng.decode_done
            retired = eng._finish_decode(act, logits)
            for req in retired:
                req.finish_time = eng.clock.now
                eng._n_open -= 1
            if retired:
                eng.admittable.fire()


class StagedServeEngine(_EngineCore):
    """The event-driven serving pipeline (see the module docstring).

    Needs a ``fabric`` (it then builds its own ``FabricRuntime``, with
    ``tracer`` if given) or a shared ``runtime``, and a ``time_model``.
    ``run()`` drives the simulated clock until every submitted request
    has retired; ``start()`` only spawns the stage processes, for a
    caller that owns the clock."""

    def __init__(self, cfg: Optional[ModelConfig], params: Any, *,
                 slots: int = 4,
                 max_len: int = 256, impl: str = "auto",
                 cache_dtype: torch.dtype = torch.float32, seed: int = 0,
                 fabric: Optional[Fabric] = None,
                 time_model: Optional[ServeTimeModel] = None,
                 runtime: Optional[FabricRuntime] = None,
                 bucket_prefill: bool = True,
                 plan_placement: bool = False,
                 cache_hit_mass: float = 0.7, placement_costs=None,
                 max_inflight_prefills: int = 2,
                 tenant: Optional[str] = None,
                 compute: str = "torch",
                 decode_pool: bool = False,
                 tracer=None, device=None):
        super().__init__(cfg, params, slots=slots, max_len=max_len, impl=impl,
                         cache_dtype=cache_dtype, seed=seed,
                         bucket_prefill=bucket_prefill, compute=compute,
                         device=device)
        self.tenant = tenant
        if runtime is None:
            if fabric is None:
                raise ValueError("StagedServeEngine needs a fabric or runtime")
            runtime = FabricRuntime(fabric, tracer=tracer)
        elif tracer is not None:
            raise ValueError("pass the tracer to the shared runtime, "
                             "not to the engine")
        if time_model is None:
            raise ValueError("StagedServeEngine needs a ServeTimeModel")
        self.runtime, self.tm = runtime, time_model
        self.clock = runtime.clock
        self.plan_placement = plan_placement
        self.cache_hit_mass, self.placement_costs = cache_hit_mass, placement_costs
        self.placements: Dict[str, int] = {}
        self.ready: List[Tuple[Request, Any, int]] = []
        self.arrived = Signal(self.clock)
        self.admittable = Signal(self.clock)
        self.decodable = Signal(self.clock)
        self.prefill_stage = PrefillStage(self, max_inflight=max_inflight_prefills)
        self.admit_stage = AdmitStage(self)
        self.decode_stage = DecodeStage(self)
        self._n_open = 0
        self._started = False
        self.intake_paused = False       # admission arbitration gate
        # -- decode replica pool (autoscaling target) ------------------
        self._decode_pool = decode_pool
        self._replicas: List[DecodeReplica] = []
        self._decode_items: List[float] = []   # sharded cache-read amounts
        self._decode_open_amt = 0.0            # dispatched, not yet moved
        self.decode_work = Signal(self.clock)  # shards queued
        self.decode_done = Signal(self.clock)  # all dispatched work moved
        self.scale_events: List[dict] = []
        if decode_pool:
            self.add_decode_replica(self.tm.decode_path, fallback=True)

    def _plan_placement(self):
        from repro_torch.serve.disagg import plan_decode_placement
        return plan_decode_placement(
            self.runtime.fabric, hit_mass=self.cache_hit_mass,
            costs=self.placement_costs, ledger=self.runtime.ledger)

    # -- decode replica pool -------------------------------------------
    def _extras(self) -> List[DecodeReplica]:
        return [r for r in self._replicas if not r.fallback and not r.retired]

    @property
    def n_decode_replicas(self) -> int:
        """Extra (non-fallback) decode replicas currently serving."""
        return len(self._extras())

    def add_decode_replica(self, path: Optional[str] = None, *,
                           fallback: bool = False) -> DecodeReplica:
        """Scale out: spawn a decode worker on ``path`` (default: the
        time model's decode path) as a runtime Process."""
        if not self._decode_pool:
            raise ValueError("engine was built without decode_pool=True")
        path = path if path is not None else self.tm.decode_path
        if path not in self.runtime.fabric:
            raise ValueError(f"unknown decode path {path!r}")
        rep = DecodeReplica(self, path, fallback=fallback)
        rep.proc = self.runtime.process(rep.serve(),
                                        name=f"decode-replica:{path}")
        self._replicas.append(rep)
        if not fallback:
            self.scale_events.append({
                "t": self.clock.now, "event": "scale_out", "path": path,
                "replicas": self.n_decode_replicas})
            self.decode_work.fire()    # queued shards may now move here
        return rep

    def retire_decode_replica(self) -> Optional[DecodeReplica]:
        """Scale in: kill the newest extra replica. Its in-flight shard
        transfers cancel (reservation back to the ledger) and each
        unmoved remainder is re-queued for the survivors. The fallback
        replica is never retired."""
        extras = self._extras()
        if not extras:
            return None
        rep = extras[-1]
        rep.retired = True
        self._replicas.remove(rep)
        rep.proc.kill()
        for t in list(rep.inflight):
            if not t.done:
                self.runtime.cancel(t)
        self.scale_events.append({
            "t": self.clock.now, "event": "scale_in", "path": rep.path,
            "replicas": self.n_decode_replicas})
        # the fallback may need to pick re-queued work back up
        self.decode_work.fire()
        return rep

    def _dispatch_decode_pool(self, amount: float, shards: int = 1) -> None:
        """Queue one decode step's default-path cache read as per-slot
        shards; the live replicas (extras if any exist, else the
        fallback) claim and move them concurrently."""
        n = max(int(shards), 1)
        share = amount / n
        self._decode_items.extend([share] * n)
        self._decode_open_amt += amount
        self.decode_work.fire()

    def _on_decode_shard_done(self, t) -> None:
        if t.canceled and t.remaining > 1e-9:
            # a retired replica's shard: defer the remainder
            self._decode_items.append(t.remaining)
            self._decode_open_amt -= t.amount - t.remaining
            self.decode_work.fire()
        else:
            self._decode_open_amt -= t.amount
        if self._decode_open_amt <= 1e-9 and not self._decode_items:
            self._decode_open_amt = 0.0
            self.decode_done.fire()

    # -- admission arbitration gate ------------------------------------
    def pause_intake(self) -> None:
        """Defer this engine's prefill dispatch (already-inflight work
        keeps running)."""
        self.intake_paused = True

    def resume_intake(self) -> None:
        if self.intake_paused:
            self.intake_paused = False
            self.arrived.fire()

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        """Requests enter the queue at their ``arrival`` time."""
        self._n_open += 1
        self.clock.at(max(req.arrival, self.clock.now), self._on_arrival, req)

    def _on_arrival(self, req: Request):
        self.queue.append(req)
        # open-loop traffic: the decode loop drains and exits whenever
        # the engine goes momentarily idle — respawn it for the new wave
        if self._started and self._decode_proc.done:
            self._decode_proc = self.runtime.process(
                self.decode_stage.process(), name="DecodeStage")
        self.arrived.fire()

    def _start(self):
        if not self._started:
            self._started = True
            self.runtime.process(self.prefill_stage.process(), name="PrefillStage")
            self.runtime.process(self.admit_stage.process(), name="AdmitStage")
            self._decode_proc = self.runtime.process(
                self.decode_stage.process(), name="DecodeStage")

    def start(self) -> None:
        """Spawn the stage processes without driving the clock (for a
        caller that embeds this engine in a larger timeline)."""
        self._start()

    @property
    def idle(self) -> bool:
        """True when every submitted request has been retired."""
        return self._n_open == 0

    @property
    def prefill_backlog(self) -> int:
        """Requests not yet through prefill: queued, in flight, or ready
        but unadmitted."""
        return len(self.queue) + self.prefill_stage.inflight + len(self.ready)

    def run(self, until: Optional[float] = None) -> List[Request]:
        """Run the simulated timeline until all submitted requests are
        served (or ``until``); returns and drains the retired requests."""
        self._start()
        if self._decode_proc.done and self._n_open > 0:
            # the decode loop drained on a previous run(); new work arrived
            self._decode_proc = self.runtime.process(
                self.decode_stage.process(), name="DecodeStage")
        self.clock.run(until=until)
        completed, self.finished = self.finished, []
        return completed
