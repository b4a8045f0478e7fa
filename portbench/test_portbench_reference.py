"""The plain reference against the program at reduced sizes on the CPU.

The program computes its products in bf16 and the reference in f32, so
whole-model logits and losses agree to bf16's rounding; the pieces the
program also has in f32 (the SSD recurrence, the rotary embedding, the
int8 AdamW step) agree to f32's."""
import math

import pytest
import torch

from portbench import reference as R
from portbench import tiny, weights
from portbench.reference import adamw, common, ssm as ref_ssm
from portbench.reference.adamw import AdamW
from portbench.train import batch


def _program(model, registry):
    from portbench.harness import program_config
    return program_config({"registry": registry, "model": model})


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("model,registry", [(tiny.DENSE, "internlm2-1.8b"),
                                            (tiny.SSM, "mamba2-2.7b")], ids=["dense", "ssm"])
def test_logits_match_the_program_to_bf16(model, registry):
    from repro_torch.models import model as M
    cfg = _program(model, registry)
    params = weights.make(model, 3, "cpu")
    toks = torch.randint(0, model["vocab_size"], (37,), generator=torch.Generator().manual_seed(1))
    prog, _, _ = M.prefill(cfg, params, toks[None], 64)
    ref = R.family(model).logits_rows(model, params, toks, [36])
    assert _rel(prog[0, -1].float(), ref[0]) < 3e-2
    # the fp8 control is further off than the program
    low = R.family(model).logits_rows(model, params, toks, [36], lowp="fp8")
    assert _rel(low[0], ref[0]) > _rel(prog[0, -1].float(), ref[0])


def test_chunked_ssd_is_the_recurrence():
    from repro_torch.models.ssm import ssd_ref
    g = torch.Generator().manual_seed(0)
    s, h, p, n = 50, 3, 4, 5
    x = torch.randn(s, h, p, generator=g)
    dt = torch.rand(s, h, generator=g) * 0.5
    A = -torch.rand(h, generator=g) * 2
    B, C = torch.randn(s, n, generator=g), torch.randn(s, n, generator=g)
    want, _ = ssd_ref(x[None], dt[None], A, B[None], C[None])
    got = ref_ssm.ssd(x, dt, A, B, C, chunk=16)
    assert torch.allclose(got, want[0], rtol=1e-5, atol=1e-5)


def test_rope_is_the_half_split_rotation():
    from repro_torch.models.layers import rope
    x = torch.randn(9, 2, 8, generator=torch.Generator().manual_seed(2))
    pos = torch.arange(9)
    assert torch.allclose(common.rope(x, pos, 1e4), rope(x, pos, 1e4), atol=1e-5)


def test_train_loss_and_grads_match_the_program():
    from repro_torch.train.train_step import loss_fn
    model = tiny.DENSE
    cfg = _program(model, "internlm2-1.8b")
    paths = list(weights.paths(model))
    bt = batch(model, tiny.TRAIN, 4, 0, "cpu")
    prog = weights.make(model, 4, "cpu", masters=True)
    pl = [weights.get(prog, p).requires_grad_() for p in paths]
    loss, _ = loss_fn(cfg, prog, bt)
    pg = torch.autograd.grad(loss, pl)
    ref = weights.make(model, 4, "cpu", masters=True)
    rl = [weights.get(ref, p).requires_grad_() for p in paths]
    n = bt["tokens"].numel()
    tot = sum(R.family(model).loss_sum(model, ref, bt["tokens"][b], bt["labels"][b], 1e-4) / n
              for b in range(bt["tokens"].shape[0]))
    rg = torch.autograd.grad(tot, rl)
    assert abs(float(loss) - float(tot)) / float(tot) < 1e-2
    for p, a, b in zip(paths, pg, rg):
        assert _rel(a, b) < 5e-2, p


@pytest.mark.parametrize("moments", ["int8", "f32"])
def test_adamw_matches_the_program(moments):
    from repro_torch.optim.adamw import adamw_init, adamw_update
    g = torch.Generator().manual_seed(5)
    shapes = [(4, 300), (7,), (2, 3, 256)]
    p0 = [torch.randn(s, generator=g) for s in shapes]
    grads = [[torch.randn(s, generator=g) * 1e-3 for s in shapes] for _ in range(3)]
    prog = [t.clone() for t in p0]
    st = adamw_init(prog, moments=moments)
    ref = [t.clone() for t in p0]
    opt = AdamW(ref, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0,
                moments=moments)
    for i, gs in enumerate(grads):
        lr = adamw.lr_at(i + 1, 3e-4, 2, 100)
        prog, st, _ = adamw_update(gs, st, prog, lr=lr, b1=0.9, b2=0.95, eps=1e-8,
                                   weight_decay=0.1, grad_clip=1.0, moments=moments)
        opt.step(gs, lr)
    for a, b, c in zip(prog, ref, p0):
        assert _rel(a - c, b - c) < 1e-4
    assert math.isclose(adamw.lr_at(50, 3e-4, 100, 1000), 1.5e-4)


def _two_steps(model, moments, grad_fn, seed=5):
    """Each leaf's change (of two or more dims) over two steps of the reference's AdamW
    fed ``grad_fn``'s gradients, and where v was stored as 0 after step 1."""
    paths = list(weights.paths(model))
    tree = weights.make(model, seed, "cpu", masters=True)
    leaves = [weights.get(tree, p) for p in paths]
    start = [t.clone() for t in leaves]
    opt = AdamW(leaves, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0,
                moments=moments)
    zero = None
    for i in range(2):
        for t in leaves:
            t.requires_grad_(True)
        loss = grad_fn(tree, batch(model, dict(tiny.TRAIN, seq=128), seed, i, "cpu"))
        grads = [g.float() for g in torch.autograd.grad(loss, leaves)]
        for t in leaves:
            t.requires_grad_(False)
        opt.step(grads, adamw.lr_at(1 + i, 3e-4, 100, 10000))
        if i == 0 and moments == "int8":
            zero = [adamw.dequantize(*v, t) == 0 for v, t in zip(opt.v, leaves)]
    return {p: (t - s, None if zero is None else z)
            for p, t, s, z in zip(paths, leaves, start, zero or [None] * len(paths))
            if t.dim() >= 2}


def test_int8_moments_amplify_the_products_rounding():
    """The int8 train cell compares its change by the median leaf: the
    reference's own optimizer, fed the program's gradients (bf16
    products) in place of its f32 ones, moves a leaf far more differently
    with int8 moments than with f32 ones, and the difference sits in the
    entries whose v was stored as 0."""
    from repro_torch.train.train_step import loss_fn
    model = dict(tiny.DENSE, d_model=128, head_dim=32, d_ff=512, vocab_size=512)
    cfg = _program(model, "internlm2-1.8b")
    R.exact_f32()

    def prog(tree, bt):
        return loss_fn(cfg, tree, bt)[0]

    def ref(tree, bt):
        n = bt["tokens"].numel()
        return sum(R.family(model).loss_sum(model, tree, bt["tokens"][b], bt["labels"][b], 1e-4)
                   / n for b in range(bt["tokens"].shape[0]))

    for moments, worst in (("f32", 1e-2), ("int8", None)):
        a, b = _two_steps(model, moments, prog), _two_steps(model, moments, ref)
        gaps = {p: abs(float(a[p][0].norm()) - float(b[p][0].norm())) / float(b[p][0].norm())
                for p in a}
        if worst is not None:
            assert max(gaps.values()) < worst, gaps
            continue
        assert max(gaps.values()) > 0.2, gaps
        for p in (p for p in a if gaps[p] > 0.05):
            d2 = (a[p][0] - b[p][0]) ** 2
            assert float(d2[b[p][1]].sum()) > 0.5 * float(d2.sum()), p
