"""The MoE dispatch's slots (``repro_torch.models.moe._slots``) on a card.

Run with ``-m gpu`` on a machine with a card (``--noconftest``: this file
imports no JAX; ``tests/test_torch_moe.py`` holds the slots to JAX's
formula on the CPU):

- at the rag cell's longest prefill (T*k = 76,800 over 18 held of 72
  experts, lossless) and its decode step (64 rows, T*k = 640), at a
  capacity that drops, and on an expert shard, the card's is_mine,
  position, kept mask and slot equal the CPU's exactly;
- captured in a ``torch.cuda.CUDAGraph`` and replayed on fresh routing
  written into the captured input, the slots equal the eager call's.
"""
import numpy as np
import pytest
import torch

from repro_torch.models import moe as TMoE


def _routing(t, k, e, seed):
    """(T*k,) experts in (token, k) order, k distinct a token."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.argsort(rng.random((t, e)), axis=-1)[:, :k].reshape(-1))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("t,lo,e_local,cap", [
    (7680, 0, 18, 7680),     # the rag cell's longest prefill, lossless
    (64, 0, 18, 64),         # its decode step, 64 rows
    (7680, 0, 18, 1000),     # drops
    (7680, 36, 18, 2000),    # an expert shard, drops
])
def test_slots_on_card_equal_cpu(t, lo, e_local, cap):
    dev = _card()
    flat_e = _routing(t, 10, 72, seed=t + lo + cap)
    want = TMoE._slots(flat_e, lo=lo, e_local=e_local, cap=cap)
    got = TMoE._slots(flat_e.to(dev), lo=lo, e_local=e_local, cap=cap)
    for name, w, g in zip(("is_mine", "pos", "keep", "slot"), want, got):
        assert torch.equal(w, g.cpu()), name


@pytest.mark.gpu
@pytest.mark.parametrize("t", [64, 7680])
def test_slots_replay_under_a_cuda_graph(t):
    dev = _card()
    kw = dict(lo=0, e_local=18, cap=t)
    flat_e = _routing(t, 10, 72, seed=1).to(dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        TMoE._slots(flat_e, **kw)                  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = TMoE._slots(flat_e, **kw)
    for seed in (2, 3, 4):
        fresh = _routing(t, 10, 72, seed=seed).to(dev)
        flat_e.copy_(fresh)
        graph.replay()
        want = TMoE._slots(fresh, **kw)
        for name, w, g in zip(("is_mine", "pos", "keep", "slot"), want, out):
            assert torch.equal(w, g), f"{name} seed {seed}"
