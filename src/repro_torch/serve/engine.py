"""Batched serving, the counterpart of the compute of
``repro/serve/engine.py``: prefill + continuous-batching decode.

Slot model: a fixed decode batch of ``slots``; each slot holds one
request's cache rows (K/V, or SSM states). A new request is prefilled
alone, at a power-of-two bucketed length for attention-only configs and
at its exact length for configs with SSM layers; its cache rows are
copied into a free slot, and each decode step advances every active slot
one token with per-row positions.

On the card (``impl="auto"``), attention prefill runs the CUDA
flash-attention kernel and attention decode the CUDA flash-decoding
kernel; SSM prefill runs the CUDA SSD-scan kernel and SSM decode the
one-token recurrence in plain tensor ops. On the CPU every kernel takes
its plain version.

The synchronous ``ServeEngine`` is here without the simulated fabric
(``fabric``, ``runtime``, ``time_model``) and without the staged
pipeline: those need the fabric and event runtime, which a later slice
of the port brings.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.params import compute_copy, layer_period, slot_kind


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (S,) token ids
    max_new_tokens: int = 16
    temperature: float = 0.0
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class _EngineCore:
    """Model compute + slot bookkeeping.

    ``params`` are the f32 master weights; the engine keeps a bf16 copy
    of the matrices (``compute_copy``), which holds the values the JAX
    engine casts to before every product."""

    MIN_BUCKET = 8

    def __init__(self, cfg: ModelConfig, params: Any, *, slots: int = 4,
                 max_len: int = 256, impl: str = "auto",
                 cache_dtype: torch.dtype = torch.float32, seed: int = 0,
                 bucket_prefill: bool = True, device=None):
        self.device = resolve_device(device)
        self.cfg, self.params = cfg, compute_copy(params)
        self.slots, self.max_len, self.impl = slots, max_len, impl
        self.cache_dtype = cache_dtype
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: List[Request] = []
        self.finished: List[Request] = []   # retired, not yet drained by run()
        self.stats: Dict[str, float] = {
            "prefill_tokens": 0, "decode_steps": 0,
            "prefill_compilations": 0, "prefill_padded_tokens": 0}
        self._compiled_buckets: set = set()
        self.cache = M.init_cache(cfg, slots, max_len, cache_dtype, self.device)
        self.pos = torch.zeros((slots,), dtype=torch.int32, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        # bucketing needs causal attention's inert pad tail; SSM state
        # runs through every position, so those configs prefill exact.
        attn_only = all(slot_kind(cfg, s)["kind"] == "attn"
                        for s in range(layer_period(cfg)))
        self.bucket_prefill = bucket_prefill and attn_only

    # ------------------------------------------------------------------
    def submit(self, req: Request):
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
        prompt = np.asarray(req.prompt)
        n = prompt.shape[0]
        bucket = self._bucket_len(n)
        if bucket > n:
            prompt = np.concatenate([prompt, np.zeros((bucket - n,), prompt.dtype)])
        # a prefill "compilation" is a distinct bucket, as in the JAX engine
        self._compiled_buckets.add((bucket,))
        toks = torch.as_tensor(prompt, device=self.device)[None]        # (1, S)
        logits, cache1, npos = M.prefill(self.cfg, self.params, toks, self.max_len,
                                         impl=self.impl,
                                         cache_dtype=self.cache_dtype, length=n)
        tok = self._sample(logits[:, -1], req.temperature)
        req.out_tokens.append(int(tok.reshape(-1)[0]))
        self.stats["prefill_tokens"] += n
        self.stats["prefill_padded_tokens"] += bucket - n
        self.stats["prefill_compilations"] = len(self._compiled_buckets)
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
        self._splice_cache(slot, cache1)
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
    def _decode_compute(self, act: List[int]) -> torch.Tensor:
        """One decode step for all slots; returns logits (B,1,V)."""
        last = np.zeros((self.slots,), np.int64)
        for s in act:
            last[s] = self.active[s].out_tokens[-1]
        tokens = torch.as_tensor(last, device=self.device)[:, None]     # (B,1)
        logits, self.cache = M.decode_step(self.cfg, self.params, tokens,
                                           self.cache, self.pos, impl=self.impl)
        live = [1 if self.active[s] is not None else 0 for s in range(self.slots)]
        self.pos += torch.as_tensor(live, dtype=torch.int32, device=self.device)
        self.stats["decode_steps"] += 1
        return logits

    def _finish_decode(self, act: List[int], logits) -> List[Request]:
        """Append sampled tokens, retire finished requests."""
        nxt = logits[:, 0].argmax(dim=-1).cpu().numpy()    # host sync
        pos = self.pos.cpu().numpy()
        retired: List[Request] = []
        for s in act:
            req = self.active[s]
            if req.temperature > 0:
                val = int(self._sample(logits[s:s + 1, 0], req.temperature)[0])
            else:
                val = int(nxt[s])
            req.out_tokens.append(val)
            if len(req.out_tokens) >= req.max_new_tokens or \
                    int(pos[s]) >= self.max_len - 1:
                req.done = True
                self.active[s] = None
                self.finished.append(req)
                retired.append(req)
        return retired


class ServeEngine(_EngineCore):
    """Synchronous engine: ``step()`` admits queued requests into free
    slots (each prefill runs to completion) and runs one decode step."""

    def _admit(self):
        for s in range(self.slots):
            if self.active[s] is not None:
                continue
            if not self.queue:
                break
            req = self.queue.pop(0)
            cache1, npos = self._prefill_request(req)
            self._activate(s, req, cache1, npos)

    def step(self) -> int:
        """Admit + one decode step for all active slots. Returns the
        number of active requests."""
        self._admit()
        act = [s for s in range(self.slots) if self.active[s] is not None]
        if not act:
            return 0
        logits = self._decode_compute(act)
        self._finish_decode(act, logits)
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
