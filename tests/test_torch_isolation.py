"""The port stands apart from the JAX package and from the CPU:

- nothing under ``src/repro_torch`` nor ``chip_smoke.py`` imports jax,
  the JAX package ``repro`` or ``msgpack`` (absent on the card's
  machine), and importing the port loads none of them;
- the modules it copies from the JAX package keep the JAX modules'
  statements (docstrings and the import prefix aside), and it holds none
  of the JAX package's TPU constants;
- its entry points default to ``cuda`` and raise without a card;
- its kernel wrappers take the plain version only for CPU tensors and
  count no launch for them, and refuse inputs that want a gradient
  (``refuse_grad``: the kernels are forward-only);
- on a card (``-m gpu``), each kernel agrees with its plain version.
"""
import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels import refuse_grad
from repro_torch.kernels.decode_attention.ops import decode_attention_kernel
from repro_torch.kernels.decode_attention.ref import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.quant.ops import dequantize, quantize
from repro_torch.kernels.quant.ref import dequantize_flat_ref, quantize_flat_ref
from repro_torch.kernels.ssd_scan.ops import ssd_scan, tensor_core_path
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref, ssd_sequential_ref
from repro_torch.models import model as TM
from repro_torch.models.params import init_params
from repro_torch.serve.engine import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(mod: str) -> bool:
    return mod.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    assert path.exists()
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_port_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.serve.engine, "
            "repro_torch.launch.serve, repro_torch.launch.train, repro_torch.bridge, "
            "repro_torch.ckpt, repro_torch.ft, repro_torch.offload, repro_torch.obs, "
            "repro_torch.train.cluster, repro_torch.train.pods, repro_torch.core.roofline, "
            "repro_torch.tenancy, repro_torch.scale, repro_torch.offload.kvfilter, "
            "repro_torch.serve.disagg, repro_torch.launch.colocate, repro_torch.launch.fleet\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'msgpack')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.launch.train import main as train_main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--arch", "internlm2-1.8b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--arch", "internlm2-1.8b", "--reduced", "--steps", "1",
                    "--ckpt-dir", str(tmp_path / "ck")])
    assert not (tmp_path / "ck").exists()
    for arch in ("internlm2-1.8b", "mamba2-2.7b"):
        cfg = get_config(arch).reduced()
        gen = torch.Generator()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_params(cfg, gen)
        params = init_params(cfg, gen, device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(cfg, params)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TM.init_cache(cfg, 2, 16)
        assert ServeEngine(cfg, params, device="cpu").device.type == "cpu"


#: the port's copies of jax-free JAX modules, held to them statement for
#: statement (``tests/test_torch_fabric.py`` holds the fabric's, runtime's,
#: tracer's and arrivals')
COPIES = ["obs/metrics.py", "offload/device.py", "offload/program.py",
          "offload/compression.py", "ckpt/replication.py", "ft/manager.py",
          "ft/straggler.py", "train/pods.py"]
#: modules the port holds only some functions of, each the JAX function's
PARTIAL_COPIES = {
    "core/compression.py": ["byte_codec", "default_codec", "offload_path_bandwidth",
                            "compression_wins", "grad_sync_seconds"],
    "core/roofline.py": ["model_flops_for"],
    "ft/elastic.py": ["best_mesh_for"],
    "train/cluster.py": ["_exact_split", "BucketSlice", "ClusterNode", "layer_group_weights",
                         "ClusterTimeModel"],
}


def _strip(tree):
    """The AST without docstrings, with ``repro_torch`` imports read as
    ``repro``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            node.module = node.module.replace("repro_torch", "repro", 1)
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return tree


def _defs(rel, package):
    tree = _strip(ast.parse((ROOT / "src" / package / rel).read_text()))
    return {n.name: ast.dump(n) for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_jax_module(rel):
    port = ast.dump(_strip(ast.parse((ROOT / "src" / "repro_torch" / rel).read_text())))
    assert port == ast.dump(_strip(ast.parse((ROOT / "src" / "repro" / rel).read_text())))


@pytest.mark.parametrize("rel", PARTIAL_COPIES)
def test_partial_copy_keeps_the_jax_functions(rel):
    port, jax_defs = _defs(rel, "repro_torch"), _defs(rel, "repro")
    for name in PARTIAL_COPIES[rel]:
        assert port[name] == jax_defs[name], name
    if rel == "core/compression.py":
        src = (ROOT / "src" / "repro_torch" / rel).read_text()
        jsrc = (ROOT / "src" / "repro" / rel).read_text()
        start = jsrc.index("BYTE_CODECS: Dict")
        table = jsrc[start:jsrc.index("}", start) + 1]
        assert table in src


#: the JAX package's TPU v5e constants (``repro/core/hw.py``) that the
#: ported fabric builders read
TPU_CONSTANTS = (197e12, 819e9, 16 * 2 ** 30, 16e9, 3e-6, 6.25e9, 10e-6)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_holds_no_tpu_constant(path):
    found = [node.value for node in ast.walk(ast.parse(path.read_text()))
             if isinstance(node, ast.Constant) and type(node.value) is float
             and node.value in TPU_CONSTANTS]
    assert not found, f"{path.name} holds {found}"


def test_wrappers_take_plain_version_on_cpu_and_count_nothing():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 16, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 16, 2, 16)).astype(np.float32))
    before = flash_attention.launches, decode_attention_kernel.launches
    torch.testing.assert_close(flash_attention(q, k, k), attention_ref(q, k, k),
                               rtol=0, atol=0)
    lens = torch.tensor([5])
    torch.testing.assert_close(decode_attention_kernel(q[:, :1], k, k, lens),
                               decode_attention(q[:, :1], k, k, lens), rtol=0, atol=0)
    n0 = ssd_scan.launches
    x, dt = q.to(torch.bfloat16), q[..., 0].abs()
    a, bm = -torch.ones(4), k[:, :, 0].contiguous()
    y, h = ssd_scan(x, dt, a, bm, bm, chunk=8)
    y_ref, h_ref = ssd_chunked_ref(x.float(), dt, a, bm, bm, chunk=8)
    assert y.dtype == torch.float32
    torch.testing.assert_close((y, h), (y_ref, h_ref), rtol=0, atol=0)
    assert (flash_attention.launches, decode_attention_kernel.launches) == before
    assert ssd_scan.launches == n0
    n0 = quantize.launches, dequantize.launches
    qt, s = quantize(q, 32)
    torch.testing.assert_close((qt, s), quantize_flat_ref(q, 32), rtol=0, atol=0)
    torch.testing.assert_close(dequantize(qt, s, q.shape),
                               dequantize_flat_ref(qt, s, q.shape), rtol=0, atol=0)
    assert (quantize.launches, dequantize.launches) == n0


def test_refuse_grad_helper():
    """``refuse_grad`` raises only when autograd would want a gradient
    through a kernel: grad mode on and an input that requires grad."""
    a, b = torch.zeros(3), torch.zeros(3, requires_grad=True)
    refuse_grad("k", a, a)
    with pytest.raises(RuntimeError, match="k: the CUDA kernel has no backward"):
        refuse_grad("k", a, b)
    with torch.no_grad():
        refuse_grad("k", a, b)
    refuse_grad("k", b.detach())


def test_unsupported_configs_raise():
    cfg = get_config("internlm2-1.8b").reduced(num_experts=4, num_experts_per_tok=2)
    with pytest.raises(NotImplementedError, match="MoE"):
        init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(KeyError):
        get_config("jamba-1.5-large-398b")


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_card():
    """Run with ``-m gpu`` on a machine with a card and nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for s, win, cap in ((256, None, None), (100, 32, 30.0)):
            q, k, v = (torch.randn((2, s, h, 64), generator=gen, device=dev).to(dtype)
                       for h in (4, 2, 2))
            n0 = flash_attention.launches
            out = flash_attention(q, k, v, window=win, softcap=cap)
            assert flash_attention.launches == n0 + 1
            ref = attention_ref(q, k, v, window=win, softcap=cap)
            assert (out.float() - ref.float()).abs().max().item() < tol
            if dtype == torch.bfloat16:
                # computed in f32 and rounded once: within half a bf16 step
                # of the f32 result, plus 2^-16 max|v| for the softmax
                # weights' 16-bit split on the tensor cores
                r32 = attention_ref(q.float(), k.float(), v.float(), window=win,
                                    softcap=cap)
                _, e = torch.frexp(torch.maximum(out.float().abs(), r32.abs()))
                excess = (out.float() - r32).abs() - torch.ldexp(torch.ones_like(r32), e - 9)
                assert excess.max().item() <= 2.0 ** -16 * v.float().abs().max().item()
    # the bf16 tensor-core path at ragged lengths with B=2: a partial last
    # tile, and tensor maps that must not read across the batch boundary
    for s in (37, 100, 300, 511):
        for d in (128, 64):
            q, k, v = (torch.randn((2, s, h, d), generator=gen, device=dev).to(torch.bfloat16)
                       for h in (4, 2, 2))
            out = flash_attention(q, k, v)
            torch.cuda.synchronize()
            assert (out.float() - attention_ref(q, k, v).float()).abs().max().item() < 2e-2
            r32 = attention_ref(q.float(), k.float(), v.float())
            _, e = torch.frexp(torch.maximum(out.float().abs(), r32.abs()))
            excess = (out.float() - r32).abs() - torch.ldexp(torch.ones_like(r32), e - 9)
            assert excess.max().item() <= 2.0 ** -16 * v.float().abs().max().item()
    q = torch.randn((3, 1, 8, 128), generator=gen, device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn((3, 256, 2, 128), generator=gen, device=dev) for _ in range(2))
    lens = torch.tensor([1, 256, 0], device=dev)
    out = decode_attention_kernel(q, kc, vc, lens)
    torch.cuda.synchronize()
    ref = decode_attention(q, kc, vc, lens)
    assert (out[:2] - ref[:2]).abs().max().item() < 2e-5
    assert out[2].abs().max().item() == 0.0          # no visible key: 0, not NaN
    # its split pass and LSE merge at split edges: chip_smoke.py's
    # DEC_SPLIT_CASES, per-row lengths, in f32 and bf16 (2e-5, 2e-2, and
    # within half a bf16 step of the f32 result plus 2^-16 max|v|)
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for b, s, hq, hkv, d, win, cap, lengths in smoke.DEC_SPLIT_CASES:
            qs = torch.randn((b, 1, hq, d), generator=gen, device=dev).to(dtype)
            ks, vs = (torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
                      for _ in range(2))
            ls = torch.tensor(lengths, dtype=torch.int32, device=dev)
            n0 = decode_attention_kernel.launches
            out = decode_attention_kernel(qs, ks, vs, ls, window=win, softcap=cap)
            torch.cuda.synchronize()
            assert decode_attention_kernel.launches == n0 + 1
            ref = decode_attention(qs, ks, vs, ls, window=win, softcap=cap)
            assert (out.float() - ref.float()).abs().max().item() < tol, (b, s, d, win, cap)
            if dtype == torch.bfloat16:
                r32 = decode_attention(qs.float(), ks.float(), vs.float(), ls, window=win,
                                       softcap=cap)
                _, e = torch.frexp(torch.maximum(out.float().abs(), r32.abs()))
                excess = (out.float() - r32).abs() - torch.ldexp(torch.ones_like(r32), e - 9)
                assert excess.max().item() <= 2.0 ** -16 * vs.float().abs().max().item()
    # the SSD scan: an f32 SSD_CASES case, and a ragged length in bf16
    # against the recurrence (5e-3, tests/test_kernels.py)
    for (b, s, h, p, n, chunk), dtype in (((2, 256, 8, 16, 32, 64), torch.float32),
                                         ((1, 100, 3, 64, 128, 128), torch.bfloat16)):
        x = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
        dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=dev))
        a = -torch.exp(torch.randn((h,), generator=gen, device=dev))
        bm, cm = (torch.randn((b, s, n), generator=gen, device=dev).to(dtype) for _ in range(2))
        n0 = ssd_scan.launches
        y, hf = ssd_scan(x, dt, a, bm, cm, chunk=chunk)
        torch.cuda.synchronize()
        assert ssd_scan.launches == n0 + 1
        y_ref, h_ref = ssd_sequential_ref(x.float(), dt, a, bm, cm)
        assert (y - y_ref).abs().max().item() < 5e-3
        assert (hf - h_ref).abs().max().item() < 5e-3
    # its bf16 tensor-core path (the state pass and the output pass, one
    # launch at S <= 64) at B=2: one chunk (S = 8, 64), a chunk edge (65)
    # and ragged lengths at mamba2's head shape, and head dims that are not
    # a whole 64-wide tile; 5e-3 abs and 1e-4 of the largest magnitude
    # against the f32 recurrence
    for s, h, p, n in ((8, 4, 64, 128), (64, 4, 64, 128), (65, 4, 64, 128),
                       (300, 4, 64, 128), (512, 4, 64, 128), (100, 3, 80, 64),
                       (130, 2, 32, 128)):
        x = F.silu(torch.randn((2, s, h, p), generator=gen, device=dev)).to(torch.bfloat16)
        dt = F.softplus(torch.randn((2, s, h), generator=gen, device=dev) - 4.0)
        a = -(1.0 + 15.0 * torch.rand((h,), generator=gen, device=dev))
        bm, cm = (F.silu(torch.randn((2, s, n), generator=gen, device=dev)).to(torch.bfloat16)
                  for _ in range(2))
        assert tensor_core_path(x, bm)
        n0 = ssd_scan.launches
        y, hf = ssd_scan(x, dt, a, bm, cm, chunk=256)
        torch.cuda.synchronize()
        assert ssd_scan.launches == n0 + 1
        y_ref, h_ref = ssd_sequential_ref(x.float(), dt, a, bm.float(), cm.float())
        for out, ref in ((y, y_ref), (hf, h_ref)):
            e = (out - ref).abs().max().item()
            assert e < 5e-3 and e < 1e-4 * ref.abs().max().item(), (s, h, p, n, e)
    # the library's path rule: bf16 with P a multiple of 16 and N 64 or
    # 128 on the tensor cores, the rest on the CUDA-core kernel
    for dtype, p, n, path in ((torch.bfloat16, 64, 128, True), (torch.bfloat16, 80, 64, True),
                              (torch.bfloat16, 32, 128, True), (torch.bfloat16, 8, 16, False),
                              (torch.bfloat16, 64, 32, False), (torch.bfloat16, 24, 128, False),
                              (torch.float32, 64, 128, False)):
        xz, bz = (torch.zeros(shape, dtype=dtype, device=dev)
                  for shape in ((1, 8, 2, p), (1, 8, n)))
        assert tensor_core_path(xz, bz) is path, (dtype, p, n)
    # no token, on either path: an empty y and the zero state
    for dtype in (torch.bfloat16, torch.float32):
        y, hf = ssd_scan(torch.zeros((2, 0, 4, 64), dtype=dtype, device=dev),
                         torch.zeros((2, 0, 4), device=dev), -torch.ones(4, device=dev),
                         *(torch.zeros((2, 0, 128), dtype=dtype, device=dev) for _ in range(2)))
        torch.cuda.synchronize()
        assert y.shape == (2, 0, 4, 64) and hf.shape == (2, 4, 64, 128)
        assert hf.abs().max().item() == 0.0
    # forward-only kernels refuse inputs that want a gradient
    qg = q.float().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(qg.expand(3, 256, 8, 128).contiguous(), kc, vc)
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention_kernel(qg, kc, vc, lens)
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_scan(x.float().requires_grad_(), dt, a, bm.float(), cm.float(), chunk=chunk)
    with torch.no_grad():
        decode_attention_kernel(qg, kc, vc, lens)
    # int8 quantize / dequantize: bit-equal to the plain versions, ragged n
    for n, dtype in ((1, torch.float32), (257, torch.bfloat16), (100_003, torch.float32)):
        x = torch.randn((n,), generator=gen, device=dev).to(dtype)
        n0 = quantize.launches, dequantize.launches
        qt, s = quantize(x)
        qr, sr = quantize_flat_ref(x)
        assert torch.equal(qt, qr) and torch.equal(s, sr)
        for out in (torch.float32, torch.bfloat16):
            assert torch.equal(dequantize(qt, s, (n,), out),
                               dequantize_flat_ref(qr, sr, (n,), out))
        assert (quantize.launches, dequantize.launches) == (n0[0] + 1, n0[1] + 2)
