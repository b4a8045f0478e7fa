"""The comparison that decides ``correct``, against the plain reference.

Serving: the sampled requests' prompts and served tokens run once
through the reference; at each served position the gap by which the
served token's reference logit lies below the reference's best, the
widest over the sample (``logit_gap``; none, and so not correct, where
no request finished in the window). The control reads, at the same
positions, the gap of the token that the reference in fp8 puts first.

Training: the reference, from the same seed and batches, follows the
program's set-up steps. ``loss_rel``: the worst step's |loss - ref| /
|ref|. ``grad_norm_gap`` and ``change_norm_gap``: by the worst leaf,
|norm - ref norm| / max(ref norm of the leaf, median leaf's ref norm),
of the first gradient as the optimizer holds it and of each leaf's
change over the set-up steps; leaves whose reference gradient is under
a thousandth of the median leaf's are left out of the change.
``change_norm_gap.median`` is the median over those leaves of the same
gap, steady where a few entries of a leaf swing (int8 moments).

Every number that ``limits/<cell>.json`` names is held to its limit
(``judge``). A control is judged the same way, its numbers in the
program's place (``controls``).
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, Iterable, List, Optional

import torch

from portbench import reference as R
from portbench import weights
from portbench.reference.adamw import AdamW, lr_at
from portbench.train import FIRST_STEP, change_norms


def serve(model: Dict, params: Dict, sample: List[Dict], device,
          controls: Iterable[str] = ()) -> Dict[str, float]:
    R.exact_f32()
    fam = R.family(model)
    out = {"logit_gap": 0.0, "tokens": 0}
    out.update({f"logit_gap.{c}": 0.0 for c in controls})
    for r in sample:
        prompt = torch.as_tensor(r["prompt"], device=device).long()
        served = torch.as_tensor(r["out"], device=device).long()
        seq = torch.cat([prompt, served[:-1]])
        rows = range(len(prompt) - 1, len(seq))
        ref = fam.logits_rows(model, params, seq, rows)
        best = ref.max(dim=-1).values
        idx = torch.arange(len(served), device=device)
        out["logit_gap"] = max(out["logit_gap"], float((best - ref[idx, served]).max()))
        out["tokens"] += len(served)
        for c in controls:
            pick = fam.logits_rows(model, params, seq, rows, lowp=c).argmax(dim=-1)
            out[f"logit_gap.{c}"] = max(out[f"logit_gap.{c}"],
                                        float((best - ref[idx, pick]).max()))
        del ref
    if not out["tokens"]:               # nothing finished in the window: nothing to judge
        out["logit_gap"] = None
    return out


def leaf_gaps(prog: Dict, ref: Dict, keep: Optional[Iterable] = None) -> List[float]:
    keys = list(ref if keep is None else keep)
    med = statistics.median(ref[k] for k in ref)
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def train_reference(model: Dict, traffic: Dict, seed: int, steps: int, device,
                    lowp: Optional[str] = None, rows: Optional[int] = None) -> Dict:
    """The reference's losses, first clipped gradient and change by leaf
    over ``steps`` steps; ``rows`` keeps only the first rows of each
    batch (a planted fault: the mean over part of the batch)."""
    from portbench.train import batch
    R.exact_f32()
    fam = R.family(model)
    o = traffic["optimizer"]
    paths = list(weights.paths(model))
    tree = weights.make(model, seed, device, masters=True)
    leaves = [weights.get(tree, p).requires_grad_() for p in paths]
    opt = AdamW(leaves, b1=o["b1"], b2=o["b2"], eps=o["eps"], weight_decay=o["weight_decay"],
                grad_clip=o["grad_clip"], moments=traffic["moments"])
    losses, grad1 = [], None
    for i in range(steps):
        bt = batch(model, traffic, seed, i, device)
        toks, labs = bt["tokens"], bt["labels"]
        if rows is not None:
            toks, labs = toks[:rows], labs[:rows]
        count = toks.numel()
        total = 0.0
        for b in range(toks.shape[0]):
            part = fam.loss_sum(model, tree, toks[b], labs[b], traffic["z_loss"], lowp) / count
            part.backward()
            total += float(part.detach())
        grads = [p.grad for p in leaves]
        if i == 0:
            scale = opt.clip_scale(grads)
            grad1 = {p: float(torch.linalg.vector_norm(g.float() * scale))
                     for p, g in zip(paths, grads)}
        opt.step(grads, lr_at(FIRST_STEP + i, o["lr"], o["warmup_steps"], o["total_steps"]))
        for p in leaves:
            p.grad = None
        losses.append(total)
    change = change_norms(model, tree, seed, device)
    del tree, leaves, opt
    return {"losses": losses, "grad1": grad1, "change": change}


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    med = statistics.median(ref["grad1"].values())
    moved = [k for k, g in ref["grad1"].items() if g >= 1e-3 * med]
    change = leaf_gaps(prog["change"], ref["change"], moved)
    return {"loss_rel": loss_rel,
            "grad_norm_gap": max(leaf_gaps(prog["grad1"], ref["grad1"])),
            "change_norm_gap": max(change),
            "change_norm_gap.median": statistics.median(change)}


def train(model: Dict, traffic: Dict, seed: int, program: Dict, device,
          controls: Iterable[str] = ()) -> Dict[str, float]:
    steps = len(program["losses"])
    t = time.perf_counter()
    ref = train_reference(model, traffic, seed, steps, device)
    out = train_numbers(program, ref)
    out["reference_s"] = time.perf_counter() - t
    for c in controls:
        if c == "half_batch":
            alt = train_reference(model, traffic, seed, steps, device,
                                  rows=int(traffic["batch"]) // 2)
        else:
            alt = train_reference(model, traffic, seed, steps, device, lowp=c)
        out.update({f"{k}.{c}": v for k, v in train_numbers(alt, ref).items()})
    return out


def control_numbers(numbers: Dict[str, float], control: str) -> Dict[str, float]:
    """What a control read (``<name>.<control>``), under the program's names."""
    tail = "." + control
    return {k[:-len(tail)]: v for k, v in numbers.items() if k.endswith(tail)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """{name: {"value", "limit"}} of every limited number; a number not
    read (None) counts as failed."""
    return {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}


def passed(judged: Dict[str, Dict]) -> bool:
    return all(v["value"] is not None and v["value"] <= v["limit"] for v in judged.values())

