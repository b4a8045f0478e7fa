"""A tiny benchmark directory for the CPU tests: the real metric readers
beside small configurations, traffic mixes and limits of its own, in a
directory the test owns. A cell runs there through ``harness.run_cell``
on the CPU, the program's kernels taking their plain versions."""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path
from typing import Dict

from portbench import spec

if str(spec.REPO / "src") not in sys.path:          # the program, as run.py finds it
    sys.path.insert(0, str(spec.REPO / "src"))

DENSE = {"family": "dense", "num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
         "head_dim": 16, "d_ff": 128, "vocab_size": 128, "rope_theta": 1e6,
         "mlp_activation": "silu", "norm_eps": 1e-5, "tie_embeddings": False,
         "dtype": "bfloat16"}
SSM = {"family": "ssm", "num_layers": 2, "d_model": 64, "vocab_size": 128, "ssm_state": 16,
       "ssm_expand": 2, "ssm_head_dim": 16, "ssm_conv": 4, "ssm_chunk": 16, "norm_eps": 1e-5,
       "tie_embeddings": True, "dtype": "bfloat16"}
SERVE = {"loop": "serve", "clients": 4, "slots": 4, "max_len": 64, "cache_dtype": "float32",
         "bucket_prefill": True, "prompt": {"law": "loguniform", "lo": 8, "hi": 24},
         "output": {"law": "uniform", "lo": 4, "hi": 8},
         "first_output": {"law": "uniform", "lo": 2, "hi": 8}, "requests": 256,
         "trace_seconds": 0.2, "check": {"tokens": 200, "max_requests": 40}}
TRAIN = {"loop": "train", "batch": 4, "seq": 32, "microbatch": 2, "moments": "f32",
         "remat": "minimal", "z_loss": 1e-4,
         "optimizer": {"lr": 3e-4, "warmup_steps": 100, "total_steps": 10000,
                       "weight_decay": 0.1, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
                       "grad_clip": 1.0},
         "setup_steps": 2}
#: limits of the tiny cells, from CPU readings over seeds. Serving: the
#: program's widest logit gap reads 0-0.0052, fp8's 0.042-0.106 over 16
#: runs of 200 served tokens (the sample follows the window's timing, so
#: the limit keeps wide room). Training (f32
#: moments, two steps, four seeds, no timing in it): the program's
#: first-gradient gap reads 0.0011-0.0023 and its change gap 0.0006-0.001,
#: fp8's 0.0099-0.027 and 0.0035-0.0082
LIMITS = {"serve": {"logit_gap": 0.02},
          "train": {"loss_rel": 0.01, "grad_norm_gap": 0.005, "change_norm_gap": 0.002}}
CELLS = {"tiny-dense.serve": ("tiny-dense", "tiny.serve"),
         "tiny-ssm.serve": ("tiny-ssm", "tiny.serve"),
         "tiny-dense.train": ("tiny-dense", "tiny.train")}


def write(path: Path, obj: Dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def make_root(tmp: Path) -> Path:
    """A benchmark directory under ``tmp`` with the tiny cells, and its
    ``BENCHMARK.json``: the real metrics, their ``workloads`` lists
    dropped so every tiny cell reports what its loop measures."""
    root = tmp / "bench"
    shutil.copytree(spec.ROOT / "metrics", root / "metrics")
    write(root / "configs" / "tiny-dense.json",
          {"name": "tiny-dense", "registry": "internlm2-1.8b", "reduced": [], "model": DENSE})
    write(root / "configs" / "tiny-ssm.json",
          {"name": "tiny-ssm", "registry": "mamba2-2.7b", "reduced": [], "model": SSM})
    write(root / "traffic" / "tiny.serve.json", SERVE)
    write(root / "traffic" / "tiny.train.json", TRAIN)
    bench = spec.load_benchmark()
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "test"}
                          for n, (c, t) in CELLS.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    for name, (_, t) in CELLS.items():
        write(root / "limits" / f"{name}.json", {"limits": LIMITS[t.split(".")[1]]})
    write(root / "BENCHMARK.json", bench)
    return root


def run(root: Path, cell: str, *, trace: bool = False, seconds: float = 1.5,
        seed: int = 2 ** 31 + 11, controls=()) -> Dict:
    """One run of a tiny cell on the CPU, on one thread: the test runner's
    workers share the cores, and a window must still finish requests."""
    import torch
    from portbench.harness import run_cell
    bench = spec.load_benchmark(root / "BENCHMARK.json")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_cell(bench, cell, seed, seconds, trace, device="cpu",
                        t_process=time.perf_counter(), root=root, controls=controls)
    finally:
        torch.set_num_threads(threads)
