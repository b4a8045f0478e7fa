"""Deterministic, resumable token pipeline: a copy of the JAX package's
``data/pipeline.py`` (numpy only), kept so the port never imports it.

Stateless addressing: ``batch_at(step)`` regenerates the exact batch for
any step — the property checkpoint/restart (ft/) relies on: a restarted
run replays the identical stream with no pipeline state to persist.

Two sources:
- synthetic: an order-1 autoregressive stream with controllable noise
  (so small models visibly learn within a few hundred steps);
- memmap: a flat uint16/uint32 token file, sliced deterministically.

``batch_at`` returns the *global* batch as numpy arrays; the trainer's
``put_batch`` moves it to the device.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


class TokenPipeline:
    #: extension -> token dtype, for dtype sniffing on memmap files
    _EXT_DTYPES = {".u16": np.uint16, ".uint16": np.uint16,
                   ".u32": np.uint32, ".uint32": np.uint32}

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *,
                 seed: int = 0, data_path: Optional[str] = None,
                 noise: float = 0.1, dtype: Optional[np.dtype] = None):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.noise = noise
        self._mm = None
        if data_path and os.path.exists(data_path):
            self._mm = np.memmap(data_path, mode="r",
                                 dtype=self._token_dtype(data_path, dtype))

    def _token_dtype(self, data_path: str, dtype: Optional[np.dtype]):
        """Explicit ``dtype=`` wins; otherwise sniff the extension
        (.u16/.u32). The fallback stays uint16 — the only format the
        pre-dtype code ever read — so existing .bin files keep their
        meaning; a wide-vocab file must say so via dtype or extension."""
        if dtype is not None:
            dt = np.dtype(dtype)
            if dt not in (np.dtype(np.uint16), np.dtype(np.uint32)):
                raise ValueError(f"token files are uint16 or uint32, not {dt}")
            return dt
        ext = os.path.splitext(data_path)[1].lower()
        if ext in self._EXT_DTYPES:
            return np.dtype(self._EXT_DTYPES[ext])
        return np.dtype(np.uint16)

    # ------------------------------------------------------------------
    def _synthetic_tokens(self, rng: np.random.Generator, b: int, s: int) -> np.ndarray:
        """next = (5*prev + 17) % V, with `noise` fraction resampled."""
        v = self.cfg.vocab_size
        first = rng.integers(0, v, size=(b, 1))
        toks = np.empty((b, s), dtype=np.int64)
        toks[:, 0] = first[:, 0]
        for t in range(1, s):
            toks[:, t] = (5 * toks[:, t - 1] + 17) % v
        flip = rng.random((b, s)) < self.noise
        toks[flip] = rng.integers(0, v, size=int(flip.sum()))
        return toks.astype(np.int32)

    def _memmap_tokens(self, rng: np.random.Generator, b: int, s: int) -> np.ndarray:
        hi = len(self._mm) - (s + 1)
        starts = rng.integers(0, hi, size=b)
        return np.stack([np.asarray(self._mm[st:st + s + 1], dtype=np.int32)
                         for st in starts])

    # ------------------------------------------------------------------
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        b, s = self.shape.global_batch, self.shape.seq_len
        cb = self.cfg.num_codebooks
        ft = self.cfg.frontend_tokens if self.cfg.frontend else 0
        s_text = s - ft
        rng = np.random.default_rng((self.seed << 20) ^ (step + 1))

        if self._mm is not None:
            seq = self._memmap_tokens(rng, b, s_text)
            tokens, labels = seq[:, :-1], seq[:, 1:]
            # pipeline emits s_text tokens; pad the final position
            tokens = np.concatenate([tokens, tokens[:, -1:]], axis=1)[:, :s_text]
            labels = np.concatenate([labels, labels[:, -1:]], axis=1)[:, :s_text]
        elif cb > 1:
            toks = np.stack([self._synthetic_tokens(rng, b, s_text + 1)
                             for _ in range(cb)], axis=-1) % self.cfg.vocab_size
            tokens, labels = toks[:, :-1], toks[:, 1:]
        else:
            seq = self._synthetic_tokens(rng, b, s_text + 1)
            tokens, labels = seq[:, :-1], seq[:, 1:]

        out: Dict[str, np.ndarray] = {
            "tokens": tokens,
            "labels": labels,
        }
        if ft:
            out["frontend_embeds"] = (
                rng.standard_normal((b, ft, self.cfg.d_model)) * 0.02
            ).astype(np.float32)
            # labels/mask over the full (frontend + text) sequence
            pad_lab = np.zeros((b, ft) + labels.shape[2:], labels.dtype)
            out["labels"] = np.concatenate([pad_lab, labels], axis=1)
            out["loss_mask"] = np.concatenate(
                [np.zeros((b, ft), np.float32), np.ones((b, s_text), np.float32)], axis=1)
        else:
            out["loss_mask"] = np.ones((b, s_text), np.float32)
        return out
