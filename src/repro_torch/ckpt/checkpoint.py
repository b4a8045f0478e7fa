"""Checkpoint save/restore of torch training state, with async staging and
chain replication: the counterpart of ``repro/ckpt/checkpoint.py``.

LineFS case study (paper §5.1) mapped to training-state persistence:
the "file" is the checkpoint shard, the "remote NVM backups" are
replica targets, and the staging path is costed against live ledger
occupancy (``CheckpointManager.choose_staging``).

The on-disk layout is the JAX package's, so a checkpoint written by
either package loads in the other:

  <dir>/step_<k>/manifest.msgpack       tree structure + sizes + hash
  <dir>/step_<k>/data.npz[.zst|.zz]     flattened leaves
  <dir>/step_<k>/COMMIT                 written last (atomicity marker)

Leaf names are those of ``jax.tree_util.tree_flatten_with_path``: dict
keys sorted, tuple and list indices as ``0``, ``1``, ..., NamedTuple
fields as ``.step``, ``.m``, ``.v`` (``Quantized`` as ``.q``,
``.scale``), joined by ``/``. ``AdamWState.step``, a Python ``int``
here, is saved as a 0-d ``int32`` (JAX's step) and restored as ``int``.
A bf16 tensor has no numpy dtype; saving one raises. The manifest is
msgpack, written and read by the small codec below (``packb`` /
``unpackb``) for the types a manifest holds.
"""
from __future__ import annotations

import hashlib
import io
import os
import shutil
import struct
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.compression import BYTE_CODECS, byte_codec, default_codec

PyTree = Any


# ----------------------------------------------------------------------
# msgpack, for the manifest: str, int, bool, None, float, list/tuple and
# dict, encoded as ``msgpack.packb`` encodes them by default (str types,
# the smallest int encoding, float64)
# ----------------------------------------------------------------------

def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(n: int, fix: int, fix_max: int, codes: Tuple[int, int, int],
              out: bytearray) -> None:
    if n <= fix_max:
        out.append(fix | n)
    elif codes[0] and n <= 0xFF:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", codes[1], n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"msgpack: length {n} too large")


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        if 0 <= obj < 0x80 or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        elif obj > 0:
            for code, fmt, hi in ((0xCC, ">BB", 0xFF), (0xCD, ">BH", 0xFFFF),
                                  (0xCE, ">BI", 0xFFFFFFFF),
                                  (0xCF, ">BQ", 0xFFFFFFFFFFFFFFFF)):
                if obj <= hi:
                    out += struct.pack(fmt, code, obj)
                    return
            raise ValueError(f"msgpack: int {obj} too large")
        else:
            for code, fmt, lo in ((0xD0, ">Bb", -0x80), (0xD1, ">Bh", -0x8000),
                                  (0xD2, ">Bi", -0x80000000),
                                  (0xD3, ">Bq", -0x8000000000000000)):
                if obj >= lo:
                    out += struct.pack(fmt, code, obj)
                    return
            raise ValueError(f"msgpack: int {obj} too small")
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out += b
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (0, 0xDC, 0xDD), out)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (0, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def unpackb(data: bytes):
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"msgpack: {len(data) - end} trailing bytes")
    return obj


_FIXED = {0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}


def _read(data: memoryview, pos: int, fmt: str):
    size = struct.calcsize(fmt)
    if pos + size > len(data):
        raise ValueError("msgpack: truncated")
    return struct.unpack_from(fmt, data, pos)[0], pos + size


def _unpack(data: memoryview, pos: int):
    code, pos = _read(data, pos, ">B")
    if code <= 0x7F:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if code == 0xC0:
        return None, pos
    if code in (0xC2, 0xC3):
        return code == 0xC3, pos
    if code in _FIXED:
        return _read(data, pos, _FIXED[code])
    if 0xA0 <= code <= 0xBF or code in _STR:
        n, pos = _read(data, pos, _STR[code]) if code in _STR else (code & 0x1F, pos)
        if pos + n > len(data):
            raise ValueError("msgpack: truncated")
        return bytes(data[pos:pos + n]).decode("utf-8"), pos + n
    if 0x90 <= code <= 0x9F or code in _ARRAY:
        n, pos = _read(data, pos, _ARRAY[code]) if code in _ARRAY else (code & 0x0F, pos)
        items = []
        for _ in range(n):
            x, pos = _unpack(data, pos)
            items.append(x)
        return items, pos
    if 0x80 <= code <= 0x8F or code in _MAP:
        n, pos = _read(data, pos, _MAP[code]) if code in _MAP else (code & 0x0F, pos)
        out = {}
        for _ in range(n):
            k, pos = _unpack(data, pos)
            out[k], pos = _unpack(data, pos)
        return out, pos
    raise ValueError(f"msgpack: unsupported type byte 0x{code:02x}")


# ----------------------------------------------------------------------
# trees: JAX's leaf names and order, torch/numpy/int leaves
# ----------------------------------------------------------------------

def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(path entry, child) pairs of an inner node in JAX's order, or None
    for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(str(i), x) for i, x in enumerate(node)]
    return None


def _named_leaves(tree: PyTree, prefix: str = "") -> List[Tuple[str, Any]]:
    if tree is None:                         # an empty subtree, as in JAX
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out += _named_leaves(child, f"{prefix}/{key}" if prefix else key)
    return out


def _rebuild(like: PyTree, leaves) -> PyTree:
    """A tree of ``like``'s structure taking its leaves, in order, from
    the iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        built = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: built[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(x, leaves) for x in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(x, leaves) for x in like)
    return next(leaves)


def _map(fn: Callable[[str, Any], Any], tree: PyTree) -> PyTree:
    named = _named_leaves(tree)
    return _rebuild(tree, iter([fn(name, leaf) for name, leaf in named]))


def _to_numpy(name: str, leaf, copy: bool) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise NotImplementedError(
                f"checkpoint leaf {name!r} is bfloat16, which numpy cannot hold; "
                "keep the train state in f32 (its masters are)")
        t = leaf.detach()
        t = t.cpu() if t.device.type != "cpu" else (t.clone() if copy else t)
        return t.numpy()
    if isinstance(leaf, (bool, np.bool_)) or not isinstance(leaf, int):
        arr = np.asarray(leaf)
        return arr.copy() if copy else arr
    if not -2 ** 31 <= leaf < 2 ** 31:
        raise ValueError(f"checkpoint leaf {name!r}: int {leaf} does not fit int32")
    return np.asarray(leaf, dtype=np.int32)


def _flatten_with_names(tree: PyTree) -> List[Tuple[str, np.ndarray]]:
    """(name, numpy array) per leaf, names and order as JAX's."""
    return [(name, _to_numpy(name, leaf, copy=False))
            for name, leaf in _named_leaves(tree)]


def stage(tree: PyTree) -> PyTree:
    """The tree with every leaf copied to host numpy: what an async save
    writes, safe from the in-place updates of the steps that follow."""
    return _map(lambda name, leaf: _to_numpy(name, leaf, copy=True), tree)


def _restore_leaf(name: str, arr: np.ndarray, like):
    if isinstance(like, torch.Tensor):
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {name!r} has shape {arr.shape}, "
                             f"want {tuple(like.shape)}")
        return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    if isinstance(like, (bool, np.bool_)):
        return bool(arr)
    if isinstance(like, int):
        return int(arr)
    return type(like)(arr)


# ----------------------------------------------------------------------
# save / load
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class StagingOption:
    """A staging strategy for ``choose_staging`` to cost against live
    occupancy: the wire a save crosses, how many bytes per raw byte it
    puts there (``wire_scale`` < 1 when compressed first), and the
    optional ops/s resource that runs the codec."""
    name: str                       # tag returned when this option wins
    path: str                       # wire resource the staged bytes cross
    wire_scale: float = 1.0         # wire bytes per raw checkpoint byte
    compute: Optional[str] = None   # ops/s resource running the codec
    ops_scale: float = 0.0          # codec ops per raw checkpoint byte


def save_checkpoint(path: str, tree: PyTree, *, step: int,
                    compress: bool = True, meta: Optional[dict] = None,
                    compressor: Optional[Callable[[str, bytes], bytes]] = None,
                    ) -> Dict[str, float]:
    """Writes atomically (COMMIT marker last). Returns size/timing stats.

    ``tree`` holds torch tensors (any device), numpy arrays or ints.
    ``compressor(codec_name, raw) -> payload`` reroutes the codec run —
    e.g. through an offload tenant that accounts the cycles on the SoC —
    but must return the same bytes the named codec would (the manifest
    hash is over the payload, so a divergent compressor is caught at
    restore time).
    """
    t0 = time.monotonic()
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    leaves = _flatten_with_names(tree)
    buf = io.BytesIO()
    np.savez(buf, **{name: arr for name, arr in leaves})
    raw = buf.getvalue()
    del buf
    codec = default_codec(compress)
    ext, comp, _ = BYTE_CODECS[codec]
    payload = compressor(codec, raw) if compressor is not None else comp(raw)
    with open(os.path.join(tmp, "data.npz" + ext), "wb") as f:
        f.write(payload)

    manifest = {
        "step": step,
        "compress": compress,
        "codec": codec,
        "raw_bytes": len(raw),
        "stored_bytes": len(payload),
        "sha256": hashlib.sha256(payload).hexdigest(),
        "names": [n for n, _ in leaves],
        "meta": meta or {},
    }
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(packb(manifest))
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write(str(step))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    dt = time.monotonic() - t0
    return {"raw_bytes": len(raw), "stored_bytes": len(payload),
            "ratio": len(payload) / max(len(raw), 1), "seconds": dt}


def load_checkpoint(path: str, like: PyTree) -> Tuple[PyTree, int]:
    """Validates COMMIT, the hash and the leaf names, and rebuilds the tree
    of ``like``: each tensor with ``like``'s dtype on ``like``'s device,
    an int leaf as ``int``."""
    if not os.path.exists(os.path.join(path, "COMMIT")):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        manifest = unpackb(f.read())
    # checkpoints from before the codec header used zstd whenever compressed
    codec = manifest.get("codec", "zstd" if manifest["compress"] else "none")
    ext, _, decomp = byte_codec(codec)   # raises IOError if zstd absent
    with open(os.path.join(path, "data.npz" + ext), "rb") as f:
        payload = f.read()
    if hashlib.sha256(payload).hexdigest() != manifest["sha256"]:
        raise IOError(f"checkpoint {path} corrupt (hash mismatch)")
    raw = decomp(payload)
    del payload
    named = _named_leaves(like)
    names = [n for n, _ in named]
    if names != manifest["names"]:
        raise ValueError(f"checkpoint {path}: tree structure changed")
    with np.load(io.BytesIO(raw)) as npz:
        leaves = [_restore_leaf(n, npz[n], leaf) for n, leaf in named]
    return _rebuild(like, iter(leaves)), int(manifest["step"])


class CheckpointManager:
    """Periodic async checkpoints + chain replication + retention.

    Async staging = every leaf copied to host numpy on the caller thread
    (the paper's "DMA to staging memory"; a copy, because the train step
    updates params and moments in place), then a background thread
    compresses, writes and replicates — training continues.

    On a mesh (``mesh`` and ``layout``, the ``BlockSpec`` tree of the
    saved tree: ``launch/inputs.train_layout``'s pair for (params, AdamW
    state)), every rank calls ``maybe_save`` with its blocks, which are
    gathered whole on every rank (``parallel/sharding.gather``); only a
    manager with ``write`` stages and writes them, in the one-device
    format. ``restore`` reads the whole tree on every rank and cuts its
    blocks (``place``), also onto another mesh than the one that saved.
    """

    @staticmethod
    def choose_staging(candidates: List[Union[str, StagingOption]], *,
                       ledger=None, direction: str = "out",
                       fallback: Optional[str] = None) -> str:
        """Pick the staging strategy for one save from *live* occupancy.

        The paper's §6.1 lesson is that the right staging path (direct
        host PCIe vs the weaker SoC DMA engine) depends on what else is
        on the wire *right now*, not on a startup constant. Plain string
        candidates are wires: the one with the most available
        ``direction`` budget (discount and current holders included)
        wins. A ``StagingOption`` is costed per raw byte instead —
        ``wire_scale`` bytes over its wire plus ``ops_scale`` ops on its
        compute resource, each at the *available* rate — so
        compress-then-stage strategies compete with raw staging on equal
        footing. Returns the winning string, or the winning option's
        ``name``. Ties keep candidate order. Without a ledger the static
        ``fallback`` (or the first candidate) is used.
        """
        if not candidates:
            raise ValueError("choose_staging needs at least one candidate")

        def label(c):
            return c.name if isinstance(c, StagingOption) else c

        if ledger is None:
            return fallback if fallback is not None else label(candidates[0])

        def avail(resource, dirn):
            return max(ledger.available(resource, dirn, joining="ckpt"), 1e-30)

        def cost(c) -> float:           # seconds per raw byte, lower wins
            if isinstance(c, StagingOption):
                s = c.wire_scale / avail(c.path, direction)
                if c.compute is not None and c.ops_scale > 0.0:
                    s += c.ops_scale / avail(c.compute, "out")
                return s
            return 1.0 / avail(c, direction)

        return label(min(candidates, key=cost))

    def __init__(self, directory: str, *, every: int = 100, keep: int = 2,
                 compress: bool = True, replicas: int = 0,
                 replica_dirs: Optional[List[str]] = None, write: bool = True,
                 mesh=None, layout: Optional[PyTree] = None):
        self.dir = directory
        self.every = every
        self.write = write
        self.mesh, self.layout = mesh, layout
        self.keep = keep
        self.compress = compress
        self.replica_dirs = list(replica_dirs or [])
        if replicas and not self.replica_dirs:
            self.replica_dirs = [os.path.join(directory, f"replica_{i}")
                                 for i in range(replicas)]
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.stats: List[dict] = []

    # ------------------------------------------------------------------
    def _step_dir(self, step: int, root: Optional[str] = None) -> str:
        return os.path.join(root or self.dir, f"step_{step:08d}")

    def maybe_save(self, step: int, tree: PyTree, *, blocking: bool = False) -> bool:
        if self.every <= 0 or step % self.every:
            return False
        self.save(step, tree, blocking=blocking)
        return True

    def save(self, step: int, tree: PyTree, *, blocking: bool = False):
        if self.layout is not None:
            from repro_torch.parallel.sharding import gather
            tree = gather(tree, self.layout, self.mesh)           # every rank
        if not self.write:
            return
        host_tree = stage(tree)                                   # stage
        self.wait()                                               # one writer

        def work():
            st = save_checkpoint(self._step_dir(step), host_tree,
                                 step=step, compress=self.compress)
            # chain replication: primary -> r0 -> r1 -> ... (paper §5.1)
            src = self._step_dir(step)
            for rdir in self.replica_dirs:
                dst = self._step_dir(step, rdir)
                os.makedirs(rdir, exist_ok=True)
                if os.path.exists(dst):
                    shutil.rmtree(dst)
                shutil.copytree(src, dst)
                src = dst
            st["step"] = step
            self.stats.append(st)
            self._gc()

        def background():
            try:
                work()
            except BaseException as e:           # surfaced by wait()
                self._error = e

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=background, daemon=True)
            self._thread.start()

    def wait(self):
        """Join the background writer; a save that failed there raises
        here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------
    def _complete_steps(self, root: str) -> List[int]:
        if not os.path.isdir(root):
            return []
        steps = []
        for d in os.listdir(root):
            if d.startswith("step_") and \
                    os.path.exists(os.path.join(root, d, "COMMIT")):
                steps.append(int(d.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        """Newest committed step across primary + replicas (a failed
        primary is recovered from the chain)."""
        best: Optional[int] = None
        for root in [self.dir] + self.replica_dirs:
            steps = self._complete_steps(root)
            if steps and (best is None or steps[-1] > best):
                best = steps[-1]
        return best

    def restore(self, like: PyTree, step: Optional[int] = None) -> Tuple[PyTree, int]:
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        placed = self.layout is not None
        if placed:                          # the whole tree, cut after loading
            from repro_torch.parallel.sharding import place, tree_map
            like = tree_map(lambda b, x: x if b is None or not isinstance(x, torch.Tensor)
                            else torch.empty(b.shape, dtype=x.dtype, device=x.device),
                            self.layout, like,
                            is_leaf=lambda x: x is None or not isinstance(x, (dict, tuple)))
        errors = []
        for root in [self.dir] + self.replica_dirs:
            try:
                tree, k = load_checkpoint(self._step_dir(step, root), like)
                return (place(tree, self.layout, self.mesh) if placed else tree), k
            except (OSError, ValueError) as e:      # FileNotFoundError, IOError
                errors.append(str(e))
        raise IOError(f"step {step} unrecoverable from any replica: {errors}")

    def _gc(self):
        for root in [self.dir] + self.replica_dirs:
            steps = self._complete_steps(root)
            for s in steps[:-self.keep]:
                shutil.rmtree(self._step_dir(s, root), ignore_errors=True)
