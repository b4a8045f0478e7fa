"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many NVIDIA cards as
the cell asks for. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number
compared beside its limit); the same numbers close standard error.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics. ``--control fp8`` (or ``half_batch`` on a train cell)
also puts the reference in that precision, or with that fault, in the
program's place and judges it by the cell's limits (``controls``); the
benchmark's own runs never pass it.

Exits 2 without a result where there is no card or too few, and 3 where
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` is loaded
once the window has closed.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_PROCESS = _process_start()
REPO = Path(__file__).resolve().parents[1]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

import argparse  # noqa: E402
import json  # noqa: E402


def _caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    the port's own kernels build into ``build/kernels`` there."""
    build = REPO / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="append", default=[],
                    help="read this control's numbers too (fp8, half_batch)")
    args = ap.parse_args(argv)
    _caches()

    from portbench import isolation, spec
    bench = spec.load_benchmark()
    chips = int(spec.cell(bench, args.workload)["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s), this machine has {n}",
              file=sys.stderr)
        return 2
    from portbench.harness import run_cell
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                   device="cuda", t_process=T_PROCESS, controls=args.control)
    found = isolation.loaded()
    if found:
        print(f"portbench: modules loaded that the port must not load: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for c, res in out.get("controls", {}).items():
        print(f"control {c} correct {res['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
