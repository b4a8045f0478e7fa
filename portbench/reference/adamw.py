"""AdamW (decoupled weight decay) with global-norm clipping, the moments
kept in f32 or stored blockwise-int8: each leaf flattened into blocks of 256
values (the tail padded with zeros), one f32 scale a block,
``scale = max|x| / 127 (+1e-30)``, ``q = round(x / scale)`` (half to
even) clipped to ±127. A step dequantizes m and v, updates them in
f32 and quantizes them again. Weight decay applies to leaves of two or
more dims. The learning rate warms up linearly, then decays on a
cosine to a tenth."""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

BLOCK = 256


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1).float()
    flat = torch.cat([flat, flat.new_zeros((-flat.numel()) % BLOCK)]).view(-1, BLOCK)
    scale = flat.abs().amax(dim=1) / torch.tensor(127.0, device=flat.device) + 1e-30
    q = torch.clamp(torch.round(flat / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return (q.float() * scale[:, None]).reshape(-1)[:like.numel()].view(like.shape)


def lr_at(step: int, base: float, warmup: int, total: int, min_ratio: float = 0.1) -> float:
    if step < warmup:
        return base * step / max(warmup, 1)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return base * (min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * prog)))


class AdamW:
    def __init__(self, params: List[torch.Tensor], *, b1: float, b2: float, eps: float,
                 weight_decay: float, grad_clip: float, moments: str = "int8"):
        if moments not in ("f32", "int8"):
            raise ValueError(f"moments must be f32 or int8, got {moments!r}")
        self.params = params
        self.b1, self.b2, self.eps = b1, b2, eps
        self.wd, self.clip = weight_decay, grad_clip
        self.int8 = moments == "int8"
        self.m = [self._store(torch.zeros_like(p)) for p in params]
        self.v = [self._store(torch.zeros_like(p)) for p in params]
        self.t = 0

    def _store(self, x: torch.Tensor):
        return quantize(x) if self.int8 else x.float()

    def _load(self, x, p: torch.Tensor) -> torch.Tensor:
        return dequantize(*x, p) if self.int8 else x

    def clip_scale(self, grads: List[torch.Tensor]) -> torch.Tensor:
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        return torch.clamp(self.clip / (norm + 1e-9), max=1.0) if self.clip > 0 else 1.0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], lr: float) -> None:
        self.t += 1
        scale = self.clip_scale(grads)
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for i, (p, g) in enumerate(zip(self.params, grads)):
            g = g.float() * scale
            m = self.b1 * self._load(self.m[i], p) + (1 - self.b1) * g
            v = self.b2 * self._load(self.v[i], p) + (1 - self.b2) * g * g
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if p.dim() >= 2:
                upd = upd + self.wd * p
            p -= lr * upd
            self.m[i], self.v[i] = self._store(m), self._store(v)
