"""Build the CUDA kernels in ``kernels/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its
own by ``nvcc`` for ``sm_90a`` into ``build/kernels/<name>-<hash>.so`` at
the root of the checkout, at first use. The hash covers the source, the
shared headers and the flags, so an edited source builds anew and an
unchanged one loads from disk. ``build()`` starts one ``nvcc`` per source
at once and waits for all of them.

Nothing here runs at import: this module imports on machines without a
card or a compiler, where only the plain versions of the kernels run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
#: argtypes of each library's C entry points; each returns an int (a CUDA
#: error code) unless RESTYPES names another type
SIGNATURES = {
    "flash_attention": {
        # q, k, v, o, dtype, B, S, Hq, Hkv, hd, causal, window, scale, softcap, stream
        "fa_forward": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P),
    },
    "decode_attention": {
        # q, k, v, cache_len, o, scratch, counters, q_dtype, c_dtype, B, S, Hq,
        # Hkv, hd, split_rows, window, scale, softcap, stream
        "decode_forward": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _F, _F, _P),
    },
    "ssd_scan": {
        # x, dt, A, Bm, C, y, h, scratch, scratch_bytes, x_dtype, B, S, H,
        # P, N, stream
        "ssd_scan_forward": (_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                             _I, _I, _P),
        # x, dt, A, Bm, C, y, h, x_dtype, B, S, H, P, N, stream
        "ssd_scan_cuda_core_forward": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                       _I, _I, _P),
        # x_dtype, B, S, H, P, N -> scratch bytes, -1 off the tensor cores
        "ssd_scan_scratch_bytes": (_I, _I, _I, _I, _I, _I),
    },
    "quant": {
        # x, q, scale, x_dtype, n, nblk, stream
        "quant_quantize": (_P, _P, _P, _I, _L, _L, _P),
        # q, scale, out, out_dtype, n, stream
        "quant_dequantize": (_P, _P, _P, _I, _L, _P),
    },
}
RESTYPES = {"ssd_scan_scratch_bytes": _L}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (all by default) that are not built yet,
    one ``nvcc`` each, all at once. Returns seconds per kernel built, and
    writes each compiler log (register and shared-memory use) beside its
    library. Raises with the compiler's output if any build fails."""
    names = list(SIGNATURES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    t0 = time.monotonic()
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    seconds, failed = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.monotonic() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``name`` ('' if none)."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = RESTYPES.get(fn, _I)
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
