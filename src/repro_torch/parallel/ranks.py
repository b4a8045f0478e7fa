"""SPMD ranks on one host: one process per mesh position, joined in a
gloo group.

``spawn(fn, world, *args)`` starts ``world`` processes with
``torch.multiprocessing`` (the ``spawn`` method), each running
``fn(rank, world, *args)`` after ``init_rank`` has joined it to the
group through a rendezvous file in a fresh temporary directory (no TCP
port to collide with another run). Each rank's return value comes back
through a file in that directory, in rank order. A rank that raises
fails the run with its traceback; a run that outlives ``timeout``
seconds is killed, every rank, and raises. Each collective of the group
times out after ``DEFAULT_TIMEOUT`` seconds (or the run's timeout, if
shorter), so a rank that waits on a dead peer dies too.

Under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR`` in the
environment), ``init_rank_from_env`` joins the group it describes.

On one card every rank computes on ``cuda:0``: the card cannot hold two
NCCL ranks, so the transport is gloo through host memory
(``core/collectives.host_staged``), never NVLink.
"""
from __future__ import annotations

import datetime
import math
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: seconds a spawned run, and each collective in any run, may take
DEFAULT_TIMEOUT = 300.0


def init_rank(rank: int, world: int, init_file: str, timeout: float = DEFAULT_TIMEOUT) -> None:
    """Join the gloo group of ``world`` ranks that rendezvous at
    ``init_file``. The ranks share this host, so gloo binds the loopback
    interface unless ``GLOO_SOCKET_IFNAME`` says otherwise."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout))


def init_rank_from_env(timeout: float = DEFAULT_TIMEOUT) -> int:
    """Join the gloo group ``torchrun``'s environment describes; returns
    the world size."""
    dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=timeout))
    return dist.get_world_size()


def _run(rank: int, fn: Callable, world: int, tmp: str, timeout: float, args) -> None:
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_rank(rank, world, os.path.join(tmp, "rendezvous"), timeout)
    try:
        out = fn(rank, world, *args)
        with open(os.path.join(tmp, f"result.{rank}"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(tmp, f"error.{rank}"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *args,
          timeout: Optional[float] = DEFAULT_TIMEOUT) -> List[Any]:
    """Run ``fn(rank, world, *args)`` on ``world`` ranks; returns their
    results in rank order. ``fn`` and ``args`` must pickle (a function of
    a module, not a lambda), and so must the results (keep them on the
    host). Raises if a rank fails or the run takes longer than
    ``timeout`` seconds (None: no limit on the run)."""
    tmp = tempfile.mkdtemp(prefix="ranks-")
    group_timeout = DEFAULT_TIMEOUT if timeout is None else min(timeout, DEFAULT_TIMEOUT)
    deadline = math.inf if timeout is None else time.monotonic() + timeout
    try:
        ctx = mp.start_processes(_run, args=(fn, world, tmp, group_timeout, args),
                                 nprocs=world, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks of {getattr(fn, '__name__', fn)} "
                                       f"still running after {timeout:.0f} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            errors = sorted(f for f in os.listdir(tmp) if f.startswith("error."))
            detail = "".join(open(os.path.join(tmp, f)).read() for f in errors[:1])
            raise RuntimeError(f"a rank failed ({e}):\n{detail}") from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"result.{r}"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
