"""The port's checkpoints against the JAX package's, on the CPU.

The state is reduced internlm2's ``(params, AdamWState)``, f32 and int8
moments, made with ``jax.random`` and bridged to the port as numpy. The
port must name its leaves as ``jax.tree_util.tree_flatten_with_path``
does, write the JAX package's layout (a checkpoint crosses between the
packages both ways with equal arrays and dtypes), write its manifest
as ``msgpack.packb`` would (without importing msgpack) and read JAX's,
and keep the JAX manager's corruption check, replica fallback,
retention and staging choice (``tests/test_ckpt_ft.py:24-69``,
``tests/test_tenancy.py:214``, ``tests/test_offload.py:432``). An async
save copies the state before the next step updates it in place."""
import math
import os
import shutil

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

import repro.ckpt.checkpoint as JC
import repro_torch.ckpt.checkpoint as TC
from repro.configs import get_config as jax_get_config
from repro.core import hw as jax_hw
from repro.models.params import init_params as jax_init_params
from repro.optim import adamw as JO
from repro.train.cluster import train_fabric as j_train_fabric
from repro_torch.bridge import opt_state_from_numpy, params_from_numpy
from repro_torch.core.compression import Quantized
from repro_torch.optim.adamw import AdamWState, tree_leaves
from repro_torch.train.cluster import train_fabric as t_train_fabric

MOMENTS = ("f32", "int8")


@pytest.fixture(scope="module")
def states():
    """moments -> (JAX (params, AdamWState), the port's bridged pair).
    The moments carry random values, so a mixed-up leaf shows."""
    jcfg = jax_get_config("internlm2-1.8b").reduced()
    jparams = jax.jit(lambda k: jax_init_params(jcfg, k)[0])(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    g = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape) * 1e-2,
                                           jnp.float32), jparams)
    out = {}
    for moments in MOMENTS:
        jopt = JO.adamw_init(jparams, moments=moments)
        jp, jopt, _ = JO.adamw_update(g, jopt, jparams, lr=1e-3, moments=moments)
        jstate = (jp, jopt)
        np_state = jax.tree.map(np.asarray, jstate)
        tstate = (params_from_numpy(np_state[0], device="cpu"),
                  opt_state_from_numpy(np_state[1], device="cpu"))
        out[moments] = jstate, tstate
    return out


def _torch_leaves(tree):
    return [x for leaf in tree_leaves(tree)
            for x in (leaf if isinstance(leaf, Quantized) else [leaf])]


def _same_state(a, b):
    """Two port states hold equal leaves (torch.equal, same dtype) and
    steps."""
    (pa, oa), (pb, ob) = a, b
    assert oa.step == ob.step and type(ob.step) is int
    la, lb = _torch_leaves((pa, oa.m, oa.v)), _torch_leaves((pb, ob.m, ob.v))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("moments", MOMENTS)
def test_leaf_names_equal_jax(states, moments):
    jstate, tstate = states[moments]
    jnames = [n for n, _ in JC._flatten_with_names(jstate)]
    tflat = TC._flatten_with_names(tstate)
    assert [n for n, _ in tflat] == jnames
    assert len(jnames) == (56 if moments == "int8" else 34)
    assert jnames[0] == "0/embed/table" and "1/.step" in jnames
    if moments == "int8":
        assert jnames[-1] == "1/.v/lm_head/w/.scale"
    for (name, a), (_, b) in zip(JC._flatten_with_names(jstate), tflat):
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("moments", MOMENTS)
def test_port_checkpoint_loads_in_jax(states, tmp_path, moments, compress):
    jstate, tstate = states[moments]
    stats = TC.save_checkpoint(str(tmp_path / "ck"), tstate, step=9, compress=compress)
    assert stats["ratio"] <= 1.0
    back, step = JC.load_checkpoint(str(tmp_path / "ck"), jstate)
    assert step == 9
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("moments", MOMENTS)
def test_jax_checkpoint_loads_in_port(states, tmp_path, moments, compress):
    jstate, tstate = states[moments]
    JC.save_checkpoint(str(tmp_path / "ck"), jstate, step=4, compress=compress)
    like = TC._map(lambda _, x: torch.zeros_like(x) if isinstance(x, torch.Tensor)
                   else 0, tstate)
    back, step = TC.load_checkpoint(str(tmp_path / "ck"), like)
    assert step == 4 and isinstance(back[1], AdamWState)
    assert isinstance(back[0]["layers"], tuple)
    _same_state(back, tstate)


def test_manifest_is_msgpack(states, tmp_path):
    """The manifest's bytes are ``msgpack.packb`` of what it holds, and
    the port reads the JAX package's manifest."""
    jstate, tstate = states["int8"]
    TC.save_checkpoint(str(tmp_path / "t"), tstate, step=3, meta={"run": "x"})
    raw = (tmp_path / "t" / "manifest.msgpack").read_bytes()
    manifest = msgpack.unpackb(raw)
    assert raw == msgpack.packb(manifest) == TC.packb(manifest)
    assert manifest["names"] == [n for n, _ in JC._flatten_with_names(jstate)]
    JC.save_checkpoint(str(tmp_path / "j"), jstate, step=3)
    jraw = (tmp_path / "j" / "manifest.msgpack").read_bytes()
    assert TC.unpackb(jraw) == msgpack.unpackb(jraw)


MSGPACK_VALUES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
    2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
    -2 ** 63, 0.0, -1.5, 1e300, math.inf, "", "a" * 31, "a" * 32, "a" * 255, "a" * 256,
    "é" * 40_000, [], list(range(15)), list(range(16)), list(range(70_000)), (1, "x"),
    {}, {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {"nested": [{"a": [None, 1.25, -7]}, []], "k": {"x": {"y": "z"}}},
]


@pytest.mark.parametrize("value", MSGPACK_VALUES,
                         ids=lambda v: type(v).__name__ + str(len(str(v))))
def test_msgpack_codec_equals_msgpack(value):
    data = msgpack.packb(value)
    assert TC.packb(value) == data
    decoded = TC.unpackb(data)
    assert decoded == msgpack.unpackb(data)
    assert type(decoded) is type(msgpack.unpackb(data))


def test_msgpack_codec_refuses():
    with pytest.raises(TypeError):
        TC.packb({"x": object()})
    with pytest.raises(ValueError):
        TC.unpackb(msgpack.packb([1, 2]) + b"\x00")
    with pytest.raises(ValueError):
        TC.unpackb(msgpack.packb("abc")[:-1])


def _tree():
    rng = np.random.default_rng(0)
    return {"a": torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32)),
            "nested": {"b": torch.from_numpy(rng.standard_normal(4).astype(np.float32)),
                       "c": 3}}


def _equal_tree(a, b):
    assert a["nested"]["c"] == b["nested"]["c"] and type(b["nested"]["c"]) is int
    assert torch.equal(a["a"], b["a"]) and torch.equal(a["nested"]["b"], b["nested"]["b"])


def test_save_load_roundtrip(tmp_path):
    t = _tree()
    stats = TC.save_checkpoint(str(tmp_path / "ck"), t, step=7)
    assert stats["ratio"] <= 1.0
    back, step = TC.load_checkpoint(str(tmp_path / "ck"), t)
    assert step == 7
    _equal_tree(t, back)
    assert back["nested"]["b"].dtype == torch.float32


def test_corruption_detected(tmp_path):
    t = _tree()
    TC.save_checkpoint(str(tmp_path / "ck"), t, step=1)
    fn = next((tmp_path / "ck").glob("data.npz*"))
    raw = bytearray(fn.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    fn.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="hash mismatch"):
        TC.load_checkpoint(str(tmp_path / "ck"), t)


def test_structure_change_refused(tmp_path):
    t = _tree()
    TC.save_checkpoint(str(tmp_path / "ck"), t, step=1)
    with pytest.raises(ValueError, match="tree structure changed"):
        TC.load_checkpoint(str(tmp_path / "ck"), {"a": t["a"]})
    with pytest.raises(ValueError, match="shape"):
        TC.load_checkpoint(str(tmp_path / "ck"), {**t, "a": t["a"][:2]})
    with pytest.raises(FileNotFoundError):
        TC.load_checkpoint(str(tmp_path / "none"), t)


def test_chain_replica_fallback(tmp_path):
    """Primary destroyed -> restore from replica (LineFS chain)."""
    t = _tree()
    mgr = TC.CheckpointManager(str(tmp_path / "primary"), every=1, replicas=2)
    mgr.save(10, t, blocking=True)
    shutil.rmtree(mgr._step_dir(10))
    shutil.rmtree(mgr._step_dir(10, mgr.replica_dirs[0]))
    assert mgr.latest_step() == 10
    back, step = mgr.restore(t)
    assert step == 10
    _equal_tree(t, back)
    shutil.rmtree(mgr._step_dir(10, mgr.replica_dirs[1]))
    with pytest.raises(FileNotFoundError):
        mgr.restore(t)


def test_unrecoverable_step_names_every_replica(tmp_path):
    t = _tree()
    mgr = TC.CheckpointManager(str(tmp_path / "p"), every=1, replicas=1)
    mgr.save(2, t, blocking=True)
    with pytest.raises(IOError, match="unrecoverable from any replica"):
        mgr.restore({"a": t["a"]})


def test_retention_gc(tmp_path):
    t = _tree()
    mgr = TC.CheckpointManager(str(tmp_path / "p"), every=1, keep=2)
    for s in (1, 2, 3):
        mgr.save(s, t, blocking=True)
    assert mgr._complete_steps(mgr.dir) == [2, 3]
    assert [s["step"] for s in mgr.stats] == [1, 2, 3]
    mgr.every = 2
    assert not mgr.maybe_save(5, t) and mgr.maybe_save(4, t)
    mgr.wait()
    assert mgr._complete_steps(mgr.dir) == [3, 4]


@pytest.mark.parametrize("moments", MOMENTS)
def test_async_save_copies_before_in_place_update(states, tmp_path, moments):
    """A non-blocking save followed at once by an in-place update (as the
    train step makes) restores the values as they were at save time."""
    _, tstate = states[moments]
    live = TC._map(lambda _, x: x.clone() if isinstance(x, torch.Tensor) else x, tstate)
    before = TC._map(lambda _, x: x.clone() if isinstance(x, torch.Tensor) else x, live)
    mgr = TC.CheckpointManager(str(tmp_path / "p"), every=1, compress=False)
    mgr.save(1, live)
    for x in _torch_leaves((live[0], live[1].m, live[1].v)):
        x.add_(1)
    mgr.wait()
    back, step = mgr.restore(live)
    assert step == 1
    _same_state(back, before)


def test_background_save_error_surfaces_in_wait(tmp_path):
    mgr = TC.CheckpointManager(str(tmp_path / "p"), every=1)
    blocker = tmp_path / "p" / "step_00000001.tmp"
    os.makedirs(tmp_path / "p", exist_ok=True)
    blocker.write_text("a file where the writer wants a directory")
    mgr.save(1, _tree())
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                       # the error is raised once


def test_bf16_leaf_is_refused_by_name(tmp_path):
    t = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    with pytest.raises(NotImplementedError, match="'w' is bfloat16"):
        TC.save_checkpoint(str(tmp_path / "ck"), t, step=1)


def _choose(m_ckpt, fabric_fn):
    """``tests/test_tenancy.py:214`` and ``tests/test_offload.py:432``."""
    mgr = m_ckpt.CheckpointManager
    out = []
    fab = fabric_fn(1)
    led = fab.ledger()
    cands = ["host:0", "soc:0"]
    out += [mgr.choose_staging(cands, fallback="soc:0"), mgr.choose_staging(cands),
            mgr.choose_staging(cands, ledger=led)]
    led.reserve("host:0", out=0.8 * fab["host:0"].capacity, flow="load")
    out.append(mgr.choose_staging(cands, ledger=led))
    led = fab.ledger()
    opts = [m_ckpt.StagingOption("host", "host:0"), m_ckpt.StagingOption("soc", "soc:0"),
            m_ckpt.StagingOption("soc-compress", "soc:0", wire_scale=0.5,
                                 compute="dca:0", ops_scale=1.0)]
    out += [mgr.choose_staging(opts), mgr.choose_staging(opts, ledger=led)]
    led.reserve("host:0", out=0.8 * fab["host:0"].capacity, flow="load-h")
    led.reserve("soc:0", out=0.8 * fab["soc:0"].capacity, flow="load-s")
    out += [mgr.choose_staging(opts, ledger=led), mgr.choose_staging(cands, ledger=led)]
    with pytest.raises(ValueError):
        mgr.choose_staging([])
    return out


def test_choose_staging_equals_jax():
    """On the JAX package's host bandwidth (the H100's PCIe is 4x
    wider, and there the host wire keeps winning)."""
    port = _choose(TC, lambda n: t_train_fabric(n, host_bw=jax_hw.PCIE_BW))
    assert port == _choose(JC, j_train_fabric)
    assert port == ["soc:0", "host:0", "host:0", "soc:0", "host", "host",
                    "soc-compress", "host:0"]
