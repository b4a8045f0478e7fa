"""The traffic mixes: length laws and the inputs drawn from a seed.

A length law is a dict: ``{"law": "uniform", "lo", "hi"}``,
``{"law": "loguniform", "lo", "hi"}`` or ``{"law": "lognormal",
"median", "sigma", "lo", "hi"}`` (clamped, modelled on the clamped
lognormal ``LengthSpec`` of ``repro_torch/scale/arrivals.py``), or
``{"law": "fixed", "value"}``.

Every seed draws the same multiset of lengths: n lengths are the law's
quantiles at (i + 1/2) / n, and the seed only permutes them. So two
seeds give the same work in another order, and the spread between runs
is the system's, not the draw's.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for one named stream of a run's seed."""
    return np.random.default_rng(np.random.SeedSequence([seed % 2 ** 64, *stream]))


def device_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for a ``torch.Generator``, one per stream."""
    state = np.random.SeedSequence([seed % 2 ** 64, *stream]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def quantile(law: Dict, u: float) -> int:
    kind = law["law"]
    if kind == "fixed":
        return int(law["value"])
    lo, hi = int(law["lo"]), int(law["hi"])
    if kind == "uniform":
        x = lo + math.floor(u * (hi - lo + 1))
    elif kind == "loguniform":
        x = round(math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo))))
    elif kind == "lognormal":
        x = round(law["median"] * math.exp(law["sigma"] * NormalDist().inv_cdf(u)))
    else:
        raise ValueError(f"unknown length law {kind!r}")
    return min(max(int(x), lo), hi)


def lengths(law: Dict, n: int, gen: np.random.Generator) -> np.ndarray:
    """n lengths of ``law``: its quantiles at (i + 1/2) / n, permuted."""
    vals = np.array([quantile(law, (i + 0.5) / n) for i in range(n)], dtype=np.int64)
    return gen.permutation(vals)


def support(law: Dict) -> List[int]:
    """The smallest and largest length the law draws."""
    if law["law"] == "fixed":
        return [int(law["value"])] * 2
    return [int(law["lo"]), int(law["hi"])]


class RequestPool:
    """The closed loop's requests, in the order the clients send them.

    The first wave (one request a client, sent in set-up) draws its
    outputs from ``first_output`` (spread over the whole range, so that
    completions spread and the window opens at steady occupancy); the
    rest draw ``prompt`` and ``output``. Prompt tokens are drawn when a
    request is sent, from its own stream of the seed."""

    def __init__(self, traffic: Dict, seed: int, vocab: int):
        self.seed, self.vocab = seed, vocab
        n, c = int(traffic["requests"]), int(traffic["clients"])
        g = rng(seed, 1)
        first = traffic.get("first_output", traffic["output"])
        self.prompt_lens = np.concatenate([lengths(traffic["prompt"], c, g),
                                           lengths(traffic["prompt"], n, g)])
        self.output_lens = np.concatenate([lengths(first, c, g),
                                           lengths(traffic["output"], n, g)])
        self.sent = 0

    def __len__(self) -> int:
        return len(self.prompt_lens)

    def next(self):
        """(rid, prompt (S,) int32, max_new_tokens) of the next request."""
        i = self.sent
        if i >= len(self):
            raise RuntimeError(f"the traffic's {len(self)} requests ran out: raise "
                               f"'requests' in the traffic file")
        self.sent += 1
        toks = rng(self.seed, 2, i).integers(0, self.vocab, int(self.prompt_lens[i]))
        return i, toks.astype(np.int32), int(self.output_lens[i])
