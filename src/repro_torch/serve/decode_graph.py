"""The serve engine's decode step, captured once and replayed as CUDA
graphs.

Issued op by op, a decode step of the full-width models is some 1,900
(internlm2-1.8b) to 3,900 (mamba2-2.7b) launches of small kernels, each
tens of host microseconds, and the card idles while the host enqueues
them. ``DecodeGraph`` captures ``models.model.decode_step`` once for the
engine's fixed batch of ``slots`` rows; a step is then a replay.

The capture is piecewise: one graph for each stretch of work between two
attention layers' decode attention, and the flash-decoding kernel (K2)
launched eagerly between the replays, into a buffer the next piece was
captured to read. K2 is called as the eager step calls it, through the
attribute ``attention.decode_attention_kernel`` looked up at every call,
so its launch counter counts every launch and a wrapper put around it at
run time wraps the replayed steps too. A config with no attention layer
(mamba2's SSM decode is plain tensor ops) is one piece: the whole step
is one graph.

The step's inputs stay where the engine keeps them: the positions
(updated in place), the cache (written in place), the weights and the
engine's MoE counter (``held_count``, added to on the device); every
address is fixed at capture. The tokens go through one static
``(slots, 1[, C])`` buffer. The logits are the last piece's static
output: they hold until the next replay.

An MoE layer's local lossless dispatch (``models/moe.py::_moe_local``,
capacity ``None``) has shapes fixed by the batch alone: its buffer is
``E_held x T`` rows for T = ``slots`` tokens whatever the routing, and
the routing decides only which rows the tokens are scattered to and
gathered from, on the device. The step leaves the MoE metrics out, and
nothing in it reads the device from the host or copies a host value in.

``applies`` is the rule that decides: a CUDA device, ``impl="auto"``,
and for a config with MoE layers the local dispatch (no mesh: the
engine never replicates hot experts).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import model as M
from repro_torch.models.params import layer_period, slot_kind
from repro_torch.parallel.sharding import current_mesh


def applies(cfg: ModelConfig, device: torch.device, impl: str) -> bool:
    """Does an engine with these settings replay its decode step?"""
    moe = any(slot_kind(cfg, s)["moe"] for s in range(layer_period(cfg)))
    return (torch.device(device).type == "cuda" and impl == "auto"
            and not (moe and current_mesh() is not None))


class DecodeGraph:
    """``decode_step`` of ``cfg`` on ``cache`` at positions ``pos``
    ((slots,) int32 on the card), captured at construction (module
    docstring), with ``held_count`` as ``decode_step``'s. ``replay()``
    runs one step on the ids written into ``tokens``."""

    def __init__(self, cfg: ModelConfig, params, cache: Tuple[dict, ...],
                 pos: torch.Tensor, cache_dtype: torch.dtype,
                 held_count: Optional[torch.Tensor] = None):
        device = pos.device
        cb = cfg.num_codebooks
        self.tokens = torch.zeros((pos.shape[0], 1) + ((cb,) if cb > 1 else ()),
                                  dtype=torch.int64, device=device)
        self.graphs: List[torch.cuda.CUDAGraph] = []
        #: K2's arguments after each piece but the last:
        #: (q, k cache, v cache, cache_len, out, window, softcap, scale)
        self.attends: List[tuple] = []
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(device)
        with torch.no_grad(), torch.cuda.device(device):
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                self._warm_up(cfg, params, cache_dtype)
                torch.cuda.synchronize()
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(pool=pool)

                def attend(q, k_cache, v_cache, cache_len, *, window=None,
                           softcap=None, impl="auto", scale=None):
                    nonlocal graph
                    out = torch.empty(q.shape, dtype=k_cache.dtype, device=q.device)
                    graph.capture_end()
                    self.graphs.append(graph)
                    self.attends.append((q, k_cache, v_cache, cache_len, out,
                                         window, softcap, scale))
                    graph = torch.cuda.CUDAGraph()
                    graph.capture_begin(pool=pool)
                    return out

                try:
                    self.logits, _ = M.decode_step(cfg, params, self.tokens, cache, pos,
                                                   attend=attend, held_count=held_count)
                finally:
                    graph.capture_end()
                self.graphs.append(graph)
            torch.cuda.current_stream().wait_stream(stream)

    def _warm_up(self, cfg: ModelConfig, params, cache_dtype: torch.dtype) -> None:
        """One eager step of one row on a scratch cache of 8 rows, on the
        capture stream, K2 left out: what an op sets up at its first call
        on a stream (cuBLAS's workspace) is set up outside the capture."""
        scratch = M.init_cache(cfg, 1, 8, cache_dtype, self.tokens.device)
        pos = torch.zeros((1,), dtype=torch.int32, device=self.tokens.device)
        M.decode_step(cfg, params, self.tokens[:1], scratch, pos,
                      attend=lambda q, k_cache, *a, **kw: torch.zeros(
                          q.shape, dtype=k_cache.dtype, device=q.device))

    @property
    def pieces(self) -> int:
        return len(self.graphs)

    def replay(self) -> torch.Tensor:
        """One decode step on the ids in ``tokens``: the pieces in order,
        K2 between them. Returns the logits (B,1,V) or (B,1,C,V), which
        the next replay overwrites."""
        for graph, args in zip(self.graphs, self.attends):
            graph.replay()
            q, k_cache, v_cache, cache_len, out, window, softcap, scale = args
            attn_mod.decode_attention_kernel(q, k_cache, v_cache, cache_len,
                                             window=window, softcap=softcap, out=out,
                                             scale=scale)
        self.graphs[-1].replay()
        return self.logits
