"""The port holds every public name of the JAX package, name by name.

- For each module of ``src/repro/``, every public top-level name it
  defines (a ``def``, a ``class``, an assignment) is an attribute of the
  port's module of the same path.
- For each package ``__init__.py``, every name it imports or lists is an
  attribute of the port's package, and the two ``__all__`` lists are
  equal (both absent where JAX has none).
- Every ``from repro.X import Y`` of ``examples/*.py`` resolves as
  ``repro_torch.X.Y``.

``EXCLUDED`` is all that the port leaves out, each with its reason; each
entry must still be in the JAX package and still absent from the port,
so the list cannot go stale. Then the new names against JAX's on the
CPU: ``param_count_tree`` exactly, ``SINGLE_POD``/``MULTI_POD``,
``shape_applicable``/``all_configs``, and ``quantize_int8`` /
``dequantize_int8`` against the Pallas kernels in interpret mode."""
import ast
import dataclasses
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.kernels.quant import ops as jquant
from repro.kernels.quant.ref import quantize_ref as jquantize_ref
from repro.models import params as jparams
import repro_torch.configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels.quant import ops as tquant
from repro_torch.models import params as tparams

ROOT = Path(__file__).resolve().parents[1]
JAX_SRC = ROOT / "src" / "repro"

#: what the port leaves out: a module path of ``src/repro/``, or
#: ``path:name`` for one name of a module
EXCLUDED = {
    "_jax_compat.py": "patches old jax in place; the port has no jax",
    "__init__.py:_jax_compat": "the package's import of that patch",
    "kernels/flash_attention/kernel.py": "the Pallas TPU kernel; its counterpart is "
                                         "kernels/csrc/flash_attention.cu",
    "kernels/decode_attention/kernel.py": "the Pallas TPU kernel; its counterpart is "
                                          "kernels/csrc/decode_attention.cu",
    "kernels/ssd_scan/kernel.py": "the Pallas TPU kernel; its counterpart is "
                                  "kernels/csrc/ssd_scan.cu",
    "kernels/quant/kernel.py": "the Pallas TPU kernels; their counterpart is "
                               "kernels/csrc/quant.cu",
    "core/hw.py:VMEM_BYTES": "a TPU core's vector memory; a Hopper SM has none "
                             "(its shared memory is the kernels' own)",
}

JAX_MODULES = sorted(str(p.relative_to(JAX_SRC)) for p in JAX_SRC.rglob("*.py"))
PORTED = [rel for rel in JAX_MODULES if rel not in EXCLUDED]


def _dotted(rel: str, package: str = "repro_torch") -> str:
    parts = Path(rel).with_suffix("").parts
    return ".".join((package,) + (parts[:-1] if parts[-1] == "__init__" else parts))


def _targets(node):
    if isinstance(node, ast.Name):
        yield node.id
    elif isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            yield from _targets(e)


def _top_level(body):
    """The statements run at a module's top level, into ``if`` and ``try``."""
    for node in body:
        yield node
        if isinstance(node, ast.If):
            yield from _top_level(node.body + node.orelse)
        elif isinstance(node, ast.Try):
            yield from _top_level(node.body + node.orelse + node.finalbody
                                  + [s for h in node.handlers for s in h.body])


def jax_names(rel: str):
    """(defined public names, imported names, ``__all__`` or None) of a
    JAX module, read from its source."""
    tree = ast.parse((JAX_SRC / rel).read_text())
    defined, imported, all_ = set(), set(), None
    for node in _top_level(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            defined.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                defined.update(_targets(t))
            if any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
                all_ = ast.literal_eval(node.value)
        elif isinstance(node, ast.AnnAssign):
            defined.update(_targets(node.target))
        elif isinstance(node, ast.ImportFrom):
            imported.update(a.asname or a.name for a in node.names)
    return {n for n in defined if not n.startswith("_")}, imported, all_


def _port_has(module, name: str) -> bool:
    if hasattr(module, name):
        return True
    try:                                    # a submodule not imported yet
        importlib.import_module(f"{module.__name__}.{name}")
        return True
    except ModuleNotFoundError:
        return False


@pytest.mark.parametrize("rel", PORTED)
def test_port_module_has_every_public_name(rel):
    port = importlib.import_module(_dotted(rel))
    defined, imported, all_ = jax_names(rel)
    want = defined | (imported | set(all_ or ()) if rel.endswith("__init__.py") else set())
    missing = sorted(n for n in want if f"{rel}:{n}" not in EXCLUDED
                     and not _port_has(port, n))
    assert not missing, f"{_dotted(rel)} lacks {missing}"
    if rel.endswith("__init__.py"):
        assert getattr(port, "__all__", None) == all_


EXAMPLE_IMPORTS = sorted({
    (node.module, a.name)
    for path in (ROOT / "examples").glob("*.py")
    for node in ast.walk(ast.parse(path.read_text()))
    if isinstance(node, ast.ImportFrom) and node.module
    and node.module.split(".")[0] == "repro" for a in node.names})


def test_examples_import_from_the_jax_package():
    assert len(EXAMPLE_IMPORTS) >= 10


@pytest.mark.parametrize("module,name", EXAMPLE_IMPORTS, ids=lambda x: x)
def test_example_import_resolves_in_the_port(module, name):
    port = importlib.import_module(module.replace("repro", "repro_torch", 1))
    assert _port_has(port, name), f"{port.__name__}.{name}"


@pytest.mark.parametrize("key", EXCLUDED)
def test_exclusion_is_still_in_the_jax_package(key):
    rel, _, name = key.partition(":")
    assert (JAX_SRC / rel).exists(), key
    if name:
        defined, imported, _ = jax_names(rel)
        assert name in defined | imported, key
        assert not hasattr(importlib.import_module(_dotted(rel)), name), \
            f"the port has {key}: drop it from EXCLUDED"
    else:
        assert not (ROOT / "src" / "repro_torch" / rel).exists(), \
            f"the port has {rel}: drop it from EXCLUDED"
    assert EXCLUDED[key]


# -- the new names against JAX's --------------------------------------

@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_param_count_tree_equals_jax(arch):
    """Reduced configs: the JAX tree, bridged to torch, and the port's own
    init count what JAX counts and what ``param_count()`` computes."""
    jcfg, tcfg = jconfigs.get_config(arch).reduced(), tconfigs.get_config(arch).reduced()
    jp, _ = jparams.init_params(jcfg, jax.random.PRNGKey(0))
    want = jparams.param_count_tree(jp)
    bridged = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    own = tparams.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    got = (tparams.param_count_tree(bridged), tparams.param_count_tree(own))
    print(f"[parity] param_count_tree {arch} reduced: {got} vs JAX {want}, "
          f"param_count() {tcfg.param_count()}")
    assert got == (want, want) and want == tcfg.param_count() == jcfg.param_count()


def test_mesh_configs_equal_jax():
    for name in ("SINGLE_POD", "MULTI_POD"):
        j, t = getattr(jconfigs, name), getattr(tconfigs, name)
        assert (t.shape, t.axis_names, t.num_devices) == (j.shape, j.axis_names,
                                                          j.num_devices), name
    assert tconfigs.MeshConfig((2, 3), ("a", "b")).num_devices == 6
    with pytest.raises(dataclasses.FrozenInstanceError):
        tconfigs.SINGLE_POD.shape = (1,)


def test_shape_applicable_and_all_configs_equal_jax():
    jall, tall = jconfigs.all_configs(), tconfigs.all_configs()
    assert list(tall) == list(jall) == tconfigs.list_archs()
    for arch in tall:
        assert dataclasses.asdict(tall[arch]) == dataclasses.asdict(jall[arch]), arch
        for shape in tconfigs.SHAPES:
            assert tconfigs.shape_applicable(tall[arch], tconfigs.SHAPES[shape]) == \
                jconfigs.shape_applicable(jall[arch], jconfigs.SHAPES[shape]), (arch, shape)
    assert sorted(tconfigs.SHAPES) == sorted(jconfigs.SHAPES)


# tests/test_kernels.py::test_quant_kernel_vs_ref's cases and input
QUANT_CASES = [(1000, 128), (4096, 256), (17, 16)]


def _bits_differ(j, t) -> int:
    j, t = np.asarray(j), t.numpy() if isinstance(t, torch.Tensor) else t
    assert j.shape == t.shape and j.dtype == t.dtype, (j.shape, j.dtype, t.shape, t.dtype)
    return int((j.view(np.uint8) != t.view(np.uint8)).sum())


@pytest.mark.parametrize("n,block", QUANT_CASES)
def test_quantize_int8_against_pallas(n, block):
    """q is bit-equal to the Pallas kernel's, in shape (nblk, block) and
    value, and the scale has its shape (nblk, 1). The scale is the
    division ``max|x| / 127 + 1e-30`` bit for bit, as JAX's own oracle
    (``repro.kernels.quant.ref.quantize_ref``, eager) computes it; the
    jitted Pallas kernel gets XLA's multiply by the reciprocal of 127
    instead, bit for bit, which sits one f32 ulp off the division in
    some blocks: both formulas are held exactly, and the blocks where
    they part are counted."""
    x = jax.random.normal(jax.random.PRNGKey(0), (n,)) * 3
    qj, sj = jquant.quantize_int8(x, block=block)                     # interpret mode
    qt, st = tquant.quantize_int8(torch.from_numpy(np.array(x)), block=block)
    assert tuple(qt.shape) == qj.shape == (-(-n // block), block)
    assert tuple(st.shape) == sj.shape == (qj.shape[0], 1)
    assert _bits_differ(qj, qt) == 0
    blocks = jnp.pad(x, (0, (-n) % block)).reshape(-1, block)
    assert _bits_differ(jquantize_ref(blocks)[1], st) == 0
    m = np.abs(np.asarray(blocks)).max(axis=1, keepdims=True)
    tiny, d127 = np.float32(1e-30), np.float32(127)
    assert _bits_differ(m / d127 + tiny, st) == 0
    assert _bits_differ(sj, m * (np.float32(1) / d127) + tiny) == 0
    print(f"[parity] quantize_int8 n={n} block={block}: q bit-equal ({qj.size} values); "
          f"scale (nblk, 1) the division, Pallas's the reciprocal multiply: "
          f"{int((np.asarray(sj) != st.numpy()).sum())} of {sj.size} blocks one ulp apart")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,block", QUANT_CASES)
def test_dequantize_int8_against_pallas(n, block, dtype):
    """The Pallas kernel's own q and scale, dequantized by both: bit-equal
    in shape and value, in f32 and bf16."""
    x = jax.random.normal(jax.random.PRNGKey(0), (n,)) * 3
    qj, sj = jquant.quantize_int8(x, block=block)
    out_j = jquant.dequantize_int8(qj, sj, (n,), dtype=getattr(jnp, dtype))
    out_t = tquant.dequantize_int8(torch.from_numpy(np.array(qj)),
                                   torch.from_numpy(np.array(sj)), (n,),
                                   dtype=getattr(torch, dtype))
    if dtype == "bfloat16":
        out_j, out_t = np.asarray(out_j.astype(jnp.float32)), out_t.float()
    assert _bits_differ(out_j, out_t) == 0
    with pytest.raises(ValueError, match="scale"):
        tquant.dequantize_int8(torch.from_numpy(np.array(qj)),
                               torch.from_numpy(np.array(sj))[:, 0], (n,))
