"""What decides ``correct``: the numbers compared with the reference, each
against a limit that the workload file states.

Training (the first three optimizer steps of the object the window drives):

* ``loss_gap``: the largest relative gap of a step's mean loss;
* ``grad_gap``: the first gradient as the optimizer got it (after the
  division by the count and the clip), leaf by leaf: the gap between the
  program's norm and the reference's, over the larger of the reference's
  norm of that leaf and the median leaf's; the worst leaf;
* ``change_gap``: the same of each leaf's change over the three steps,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (Adam moves them by round-off alone);
* ``direction_median_gap``: 1 - cos of the angle between the program's and
  the reference's first gradient, leaf by leaf, the median over the same
  leaves (steady where the worst leaf swings with bf16's rounding);
* ``head_bias_gap``: the same of the head bias's first gradient, the
  batch's mean of softmax minus one-hot: the leaf that reads which targets
  the step saw.

Which of them a cell compares is its workload file's ``limits``.

Serving (a sample of the requests the window finished):

* ``served_gap``: at each position of each sampled sentence, how far the
  reference's logit of what the response says lies below the reference's
  best logit. An edited char says "this token"; an unchanged char says "the
  input token, or a token the splice cannot place" (one that is not one
  char wide, or [UNK]); the gap is to the best of the tokens it allows;
* ``step_gap``: at each real position of a sample of device steps, the gap
  of the argmax the step served.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

import torch

from benchmark.reference import reference_class
from benchmark.reference.dropout import Draws
from benchmark.reference.optim import AdamW, clip

BUFFER_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked")
# The gap of a served char that no token of the vocabulary is, or of a
# sentence served at another length: larger than any logit gap.
UNPLACED_GAP = 1e9
# The tied head's own parameter. Its gradient is the batch's mean of
# softmax minus one-hot over the loss positions: the one leaf that reads the
# batch's targets directly.
HEAD_BIAS = "classifier.bias"


def is_parameter(name: str) -> bool:
    return name != "char_images_multifonts" and not name.endswith(
        BUFFER_SUFFIXES)


def reference_steps(cfg: Dict, weights: Dict[str, torch.Tensor], pho,
                    batches: Sequence[Dict[str, torch.Tensor]],
                    trainer_seed: int, precision: str = "f32") -> Dict:
    """The reference's readings of the first ``len(batches)`` steps from
    ``weights``: {'losses', 'grad_norms' (first step), 'change_norms'}.
    Each step is a list of the data-parallel ranks' slices (one without):
    each slice runs as its rank runs it (its own dropout draws, its own
    BatchNorm statistics) and the loss sums and counts add up, the sums the
    ranks all-reduce."""
    names = [n for n in weights if is_parameter(n)]
    start = {n: weights[n].detach().clone() for n in names}
    params = {n: weights[n].detach().clone().requires_grad_(True)
              for n in names}
    P = dict(weights)
    P.update(params)
    ref = reference_class(cfg)(cfg, P, *pho, precision=precision)
    ranks = len(batches[0])
    draws = [Draws(trainer_seed, stream=k) for k in range(ranks)]
    opt = AdamW(names, cfg["optimizer"])
    losses, grad_norms = [], None
    for step, slices in enumerate(batches):
        loss_sum = count = 0.0
        for k, batch in enumerate(slices):
            part, n = ref.forward(batch["src_idx"], batch["masks"],
                                  train=True, draws=draws[k],
                                  tgt_idx=batch["tgt_idx"],
                                  loss_masks=batch["loss_masks"])
            loss_sum, count = loss_sum + part, count + n
        leaves = [params[n] for n in names]
        got = torch.autograd.grad(loss_sum, leaves, allow_unused=True)
        denom = count.clamp(min=1.0)
        grads = {n: (torch.zeros_like(p) if g is None else g / denom)
                 for n, p, g in zip(names, leaves, got)}
        del got
        norm = clip(grads, cfg["optimizer"]["max_grad_norm"])
        if grad_norms is None:
            grad_norms = {n: float(torch.linalg.vector_norm(g))
                          for n, g in grads.items()}
            first = {n: g.clone() for n, g in grads.items()}
            first_norm = float(norm)
        losses.append(float(loss_sum.detach() / denom))
        opt.step(params, grads, step)
        del grads, loss_sum
    change = {n: float(torch.linalg.vector_norm(params[n].detach() - start[n]))
              for n in names}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
            "first_grads": first, "clip_norm": first_norm}


def _leaf_gap(got: Dict[str, float], want: Dict[str, float],
              names: List[str]) -> float:
    floor = statistics.median(want[n] for n in names)
    worst = 0.0
    for n in names:
        scale = max(want[n], floor)
        if scale > 0:
            worst = max(worst, abs(got[n] - want[n]) / scale)
    return worst


def directions(got: Dict[str, torch.Tensor],
               want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """1 - cos of the angle between two gradients, leaf by leaf."""
    out = {}
    for n, w in want.items():
        g = got[n].to(w.device, torch.float64)
        w = w.double()
        d, a, b = float((g * w).sum()), float((g * g).sum()), float((w * w).sum())
        out[n] = 1.0 - d / max((a * b) ** 0.5, 1e-300)
    return out


def worst(got: Dict[str, float], want: Dict[str, float], names, k: int = 4):
    floor = statistics.median(want[n] for n in names)
    return sorted(((abs(got[n] - want[n]) / max(want[n], floor, 1e-300), n)
                   for n in names), reverse=True)[:k]


def train_numbers(program: Dict, reference: Dict) -> Dict[str, float]:
    losses = [abs(p - r) / abs(r)
              for p, r in zip(program["losses"], reference["losses"])]
    g_ref = reference["grad_norms"]
    names = sorted(g_ref)
    median_g = statistics.median(g_ref[n] for n in names)
    moving = [n for n in names if g_ref[n] >= 1e-3 * median_g]
    return {"loss_gap": max(losses),
            "grad_gap": _leaf_gap(program["grad_norms"], g_ref, names),
            "change_gap": _leaf_gap(program["change_norms"],
                                    reference["change_norms"], moving),
            **direction_numbers(program, reference, moving)}


def direction_numbers(program, reference, moving) -> Dict[str, float]:
    d = directions(program["first_grads"], reference["first_grads"])
    return {"head_bias_gap": d[HEAD_BIAS],
            "direction_median_gap": statistics.median(d[n] for n in moving)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """{name: {'value', 'limit'}} of every number, and whether all hold."""
    checks = {n: {"value": numbers[n], "limit": limits[n]} for n in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return {"ok": ok, "checks": checks}


# ------------------------------------------------------------------ serving
def allowed_sets(vocab: List[str]):
    """(id of each char token, mask of the tokens the splice cannot place)."""
    char_ids: Dict[str, List[int]] = {}
    unplaceable = torch.zeros(len(vocab), dtype=torch.bool)
    for i, t in enumerate(vocab):
        piece = t[2:] if t.startswith("##") else t
        if len(piece) == 1 and t != "[UNK]":
            char_ids.setdefault(piece, []).append(i)
        else:
            unplaceable[i] = True
    return char_ids, unplaceable


def served_gap(logits: torch.Tensor, sentence: str, corrected: str,
               input_ids: Sequence[int], char_ids, unplaceable) -> float:
    """Widest gap of one served sentence; ``logits`` (len + 2, V) over
    [CLS] sentence [SEP], float32."""
    if len(corrected) != len(sentence):
        return UNPLACED_GAP
    unplaceable = unplaceable.to(logits.device)
    worst = 0.0
    for i, (a, b) in enumerate(zip(sentence, corrected)):
        row = logits[i + 1]
        best = float(row.max())
        if a != b:
            ids = char_ids.get(b)
            if not ids:
                return UNPLACED_GAP
            said = float(row[ids].max())
        else:
            said = max(float(row[input_ids[i]]),
                       float(row[unplaceable].max()))
        worst = max(worst, best - said)
    return worst


def token_gap(logits: torch.Tensor, pred: torch.Tensor,
              mask: torch.Tensor) -> float:
    """Widest gap of the argmax ``pred`` (B, S) at the mask's positions."""
    best = logits.max(-1).values
    said = logits.gather(-1, pred[..., None])[..., 0]
    gap = (best - said)[mask.bool()]
    return float(gap.max()) if gap.numel() else 0.0


def control_gap(ref, control, src_idx, masks) -> float:
    """The gap of the control's argmax under the reference."""
    with torch.no_grad():
        want = ref.forward(src_idx, masks)
        pred = control.forward(src_idx, masks).argmax(-1)
    return token_gap(want, pred, masks)
