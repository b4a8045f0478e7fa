"""The port's dry-run (``repro_torch/launch/dryrun.py``) and its copies of
``core/charz.py`` and ``core/roofline.py`` against the JAX package.

- The two ``charz`` modules on ``tests/test_charz.py``'s literal HLO
  strings (read from that file) and on the text that its
  ``test_end_to_end_small_compile`` compiles with JAX here: the same
  parsed collectives, axes and traffic summaries.
- ``dryrun.summarize_ops`` against ``charz.summarize_traffic`` and
  ``dryrun.report_from`` against the copied ``build_report`` on the same
  text: the same summary and report, field for field.
- ``lower_cell`` on a fake (2, 2, 2) world in a subprocess (the fake
  default process group must not leak into this worker): reduced
  internlm2 (train, prefill, decode), reduced mamba2 and jamba at
  ``long_500k`` (context-parallel), reduced granite-moe (train, expert
  parallel). ``model_flops``, ``params_b``, ``active_params_b`` and
  ``memory.argument_bytes`` equal to JAX's ``lower_cell`` run in a
  second subprocess on 8 host devices, but for one named scalar XLA
  drops (``UNREAD_BY_JAX``) (there ``get_config``,
  ``make_production_mesh`` and ``SHAPES`` are swapped for the reduced
  config, the (2, 2, 2) test mesh and the same small shapes; no JAX file
  changes). Every cell on this sharded mesh records collectives, on
  named axes. The train cells trace the step on the param and optimizer
  shards themselves: reduced granite-moe's makes fewer all-gathers than
  the whole-weight trace's 55 (printed beside XLA's counts).
- The depth fit (``trace_depth``) against the whole trace at 6 groups:
  FLOPs, HBM bytes, op and collective counts and collective bytes
  equal; the peak of the live bytes, which the fit only estimates,
  within 5%.
- The FLOPs of one reduced train step traced on fake tensors equal,
  exactly, to ``FlopCounterMode``'s count of the same step run on real
  CPU tensors.
- ``python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape
  decode_32k`` (full width, 16x16) runs to its end.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

from repro.core import charz as JC
from repro_torch.core import charz as TC
from repro_torch.core import roofline as TR
from repro_torch.launch import dryrun as D

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300                    # seconds for each subprocess
MESH = [("pod", 2), ("data", 16), ("model", 16)]
#: (name, seq, global batch, kind): each cell's shape, small, under the
#: name that decides the cell's kind and context parallelism
CELL_SHAPES = [("train_4k", 256, 8, "train"), ("prefill_32k", 256, 8, "prefill"),
               ("decode_32k", 512, 8, "decode"), ("long_500k", 1024, 1, "decode")]
CELLS = [("internlm2-1.8b", "train_4k"), ("internlm2-1.8b", "prefill_32k"),
         ("internlm2-1.8b", "decode_32k"), ("mamba2-2.7b", "long_500k"),
         ("jamba-1.5-large-398b", "long_500k"), ("granite-moe-1b-a400m", "train_4k")]
FIT_TEMP_REL = 0.05
#: argument bytes the port counts and XLA does not: ``jax.jit`` drops the
#: arguments a step never reads (``keep_unused=False``), and a pure SSM
#: model's decode step never reads its int32 position ``pos``
UNREAD_BY_JAX = {"mamba2-2.7b/long_500k": 4}


def _hlo_strings():
    """Every string literal of ``tests/test_charz.py`` that holds a
    collective's replica groups or source-target pairs."""
    tree = ast.parse((ROOT / "tests" / "test_charz.py").read_text())
    return sorted({n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
                   and isinstance(n.value, str)
                   and ("replica_groups" in n.value or "source_target_pairs" in n.value)})


def _compiled_text():
    """``test_end_to_end_small_compile``'s compiled module, as text."""
    mesh = jax.make_mesh((1,), ("model",), axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        f = jax.jit(lambda a, b: (a @ b).sum())
        return f.lower(jax.ShapeDtypeStruct((8, 8), jnp.float32),
                       jax.ShapeDtypeStruct((8, 8), jnp.float32)).compile().as_text()


HLO = _hlo_strings()


def _summary(s):
    return s.per_path, s.per_op, s.op_counts, [dataclasses.astuple(o) for o in s.ops]


@pytest.mark.parametrize("text", HLO + ["compiled"], ids=lambda t: t[:40])
def test_charz_copy_parses_as_jax(text):
    if text == "compiled":
        text = _compiled_text()
    for mesh in (MESH, [("data", 16), ("model", 16)]):
        want = JC.parse_collectives(text, mesh)
        got = TC.parse_collectives(text, mesh)
        assert [dataclasses.astuple(o) for o in got] == [dataclasses.astuple(o) for o in want]
        assert _summary(TC.summarize_traffic(text, mesh)) == \
            _summary(JC.summarize_traffic(text, mesh))
        for group in (JC._parse_groups(line) or [] for line in text.splitlines()):
            for g in group:
                assert TC.attribute_axes(g, mesh) == JC.attribute_axes(g, mesh)


@pytest.mark.parametrize("text", HLO + ["compiled"], ids=lambda t: t[:40])
def test_report_from_is_build_report(text):
    """The dry-run's summary of parsed ops and its report, against the
    copied ``summarize_traffic`` and ``build_report`` on the same text."""
    if text == "compiled":
        text = _compiled_text()
    cost = {"flops": 3.0e12, "bytes accessed": 5.0e9}
    traffic = TC.summarize_traffic(text, MESH)
    assert _summary(D.summarize_ops(TC.parse_collectives(text, MESH), MESH)) == \
        _summary(traffic)
    want = TR.build_report(arch="a", shape="s", mesh_name="2x16x16", mesh_axes=MESH,
                           cost=cost, hlo_text=text, model_flops=1e15, chips=512,
                           memory_bytes_per_chip=7e9)
    got = D.report_from(arch="a", shape="s", mesh_name="2x16x16", mesh_axes=MESH,
                        flops=cost["flops"], hbm_bytes=cost["bytes accessed"],
                        traffic=traffic, model_flops=1e15, chips=512,
                        memory_bytes_per_chip=7e9)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


JAX_SCRIPT = r'''
import json, os, sys
sys.path.insert(0, os.path.join(ROOT, "src"))
import repro.launch.dryrun as JD        # forces 512 host devices ...
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"   # ... 8 here
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch.mesh import make_test_mesh

JD.get_config = lambda arch: get_config(arch).reduced()
JD.make_production_mesh = lambda multi_pod=False: make_test_mesh((2, 2, 2))
JD.SHAPES = {n: ShapeConfig(n, s, b, k) for n, s, b, k in CELL_SHAPES}
out = {}
for arch, shape in CELLS:
    r = JD.lower_cell(arch, shape, verbose=False, save=False)
    out[arch + "/" + shape] = dict(
        {k: r[k] for k in ("model_flops", "params_b", "active_params_b", "chips",
                           "collective_op_counts")},
        argument_bytes=r["memory"]["argument_bytes"])
print("RESULT " + json.dumps(out))
'''

PORT_SCRIPT = r'''
import json, os, sys
sys.path.insert(0, os.path.join(ROOT, "src"))
import torch
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import RunConfig, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.models.params import init_params
from repro_torch.optim.adamw import adamw_init
from repro_torch.train.train_step import make_train_step

shapes = {n: ShapeConfig(n, s, b, k) for n, s, b, k in CELL_SHAPES}
mesh = (("pod", 2), ("data", 2), ("model", 2))
out = {}
for arch, shape in CELLS:
    r = D.lower_cell(arch, shape, cfg=get_config(arch).reduced(), shape=shapes[shape],
                     mesh_shape=mesh, verbose=False, save=False)
    out[arch + "/" + shape] = dict(
        {k: r[k] for k in ("model_flops", "params_b", "active_params_b", "chips",
                           "collective_op_counts", "collective_axes")},
        argument_bytes=r["memory"]["argument_bytes"])

# the depth fit against the whole trace, 6 groups
cfg = get_config("internlm2-1.8b").reduced(num_layers=6)
fit = {}
for ext in (True, False):
    r = D.lower_cell("internlm2-1.8b", "train_4k", cfg=cfg, shape=shapes["train_4k"],
                     mesh_shape=mesh, verbose=False, save=False, extrapolate=ext)
    fit[str(ext)] = dict({k: r[k] for k in ("flops_per_chip", "hbm_bytes_per_chip", "ops",
                                            "collective_op_counts",
                                            "collective_bytes_per_path",
                                            "groups_traced")},
                         temp_bytes=r["memory"]["temp_bytes"])
out["fit"] = fit

# one reduced train step: traced on fake tensors, and run on CPU tensors
cfg = get_config("internlm2-1.8b").reduced()
shape = ShapeConfig("train_small", 64, 4, "train")
run = RunConfig(microbatch=2, moments_int8=True)
traced = D.lower_cell("internlm2-1.8b", "train_small", cfg=cfg, shape=shape, run=run,
                      mesh_shape=(("data", 1), ("model", 1)), verbose=False, save=False)
gen = torch.Generator().manual_seed(0)
params = init_params(cfg, gen, "cpu")
g = torch.Generator().manual_seed(1)
tokens = torch.randint(0, cfg.vocab_size, (4, 64), generator=g, dtype=torch.int32)
batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1),
         "loss_mask": torch.ones((4, 64))}
with FlopCounterMode(display=False) as fc:
    make_train_step(cfg, run)(params, adamw_init(params, moments="int8"), batch, 0)
out["real_step"] = {"traced": traced["flops_per_chip"], "real": fc.get_total_flops()}
print("RESULT " + json.dumps(out))
'''


def _script(body):
    consts = (f"ROOT = {str(ROOT)!r}\nCELL_SHAPES = {CELL_SHAPES!r}\n"
              f"CELLS = {CELLS!r}\n")
    return consts + body


def _result(proc, name):
    out, err = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 0, f"{name} failed:\n{err[-4000:]}"
    line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def results():
    """(JAX's cells, the port's cells and checks), the two subprocesses
    run side by side."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    procs = {name: subprocess.Popen([sys.executable, "-c", _script(body)], env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
             for name, body in (("jax", JAX_SCRIPT), ("port", PORT_SCRIPT))}
    try:
        return {name: _result(p, name) for name, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()


@pytest.mark.parametrize("cell", [f"{a}/{s}" for a, s in CELLS])
def test_lower_cell_matches_jax(results, cell):
    want, got = results["jax"][cell], results["port"][cell]
    print(f"[parity] dryrun {cell}: JAX {want}, port {got}")
    for key in ("model_flops", "params_b", "active_params_b", "chips"):
        assert got[key] == want[key], key
    assert got["argument_bytes"] == want["argument_bytes"] + UNREAD_BY_JAX.get(cell, 0)
    assert got["collective_op_counts"] and all(got["collective_axes"]), got


#: the reduced EP train cell's all-gathers when the port's dry-run traced
#: its step on weights gathered whole from their shards (before the train
#: step took the blocks themselves)
WHOLE_WEIGHT_ALL_GATHERS = 55


def test_sharded_ep_cell_gathers_less(results):
    """The reduced granite-moe train cell on (2, 2, 2), traced on the
    blocks the launcher holds: the port's collectives by kind beside
    XLA's (printed), and fewer all-gathers than the whole-weight trace."""
    cell = "granite-moe-1b-a400m/train_4k"
    got, want = (results[k][cell]["collective_op_counts"] for k in ("port", "jax"))
    print(f"[parity] dryrun {cell} collectives: port {got}, JAX {want}")
    assert 0 < got["all-gather"] < WHOLE_WEIGHT_ALL_GATHERS


def test_depth_fit_matches_whole_trace(results):
    fit, whole = results["port"]["fit"]["True"], results["port"]["fit"]["False"]
    print(f"[parity] dryrun depth fit {fit} vs whole trace {whole}")
    assert fit["groups_traced"] == [2, 3, 4] and whole["groups_traced"] == [6]
    for key in ("flops_per_chip", "hbm_bytes_per_chip", "ops", "collective_op_counts"):
        assert fit[key] == whole[key], key
    assert fit["collective_bytes_per_path"] == pytest.approx(whole["collective_bytes_per_path"],
                                                             rel=1e-12)
    assert abs(fit["temp_bytes"] - whole["temp_bytes"]) <= FIT_TEMP_REL * whole["temp_bytes"]


def test_traced_flops_equal_a_real_step(results):
    r = results["port"]["real_step"]
    print(f"[parity] dryrun FLOPs of a reduced train step: traced {r['traced']}, "
          f"run on CPU tensors {r['real']}")
    assert r["traced"] == r["real"] > 0


def test_cli_runs_a_full_width_cell():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                           "internlm2-1.8b", "--shape", "decode_32k"], env=env,
                          capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "[dryrun] internlm2-1.8b x decode_32k x 16x16:" in proc.stdout
    assert "all requested cells traced OK" in proc.stdout
