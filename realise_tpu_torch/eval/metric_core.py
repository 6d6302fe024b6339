"""SIGHAN sentence-level detection / correction metrics (the port's own copy
of ``realise_tpu.eval.metric_core``).

Behavioral parity with the reference scorer (reference: src/metric_core.py:20-86):

* Label-file line format: ``id, pos, char, pos, char, ...`` or ``id, 0`` for a
  sentence with no errors (src/metric_core.py:4-17).
* Detection hit: the sorted multiset of predicted error *positions* equals the
  target's (src/metric_core.py:43-46).
* Correction hit: sorted (position, char) pairs equal (src/metric_core.py:71-74).
* Precision = tp / #sentences-with-predicted-errors, recall = tp /
  #sentences-with-target-errors; accuracy counts no-error sentences too
  (src/metric_core.py:48-51).

The reference's ``metric_file`` has a 2-arg signature; its caller passes a
nonexistent ``do_char_metric`` kwarg (src/metric.py:23) — a latent TypeError we
deliberately do not replicate (SURVEY.md §2.4).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

Edit = Tuple[int, str]
LabelItem = Tuple[str, List[Edit]]  # (sentence id, list of (1-based pos, char))


def parse_label_line(line: str) -> LabelItem:
    """Parse one SIGHAN label line into ``(id, [(pos, char), ...])``.

    Lenient comma split (``,`` with optional whitespace), matching the
    corpus parser (data/corpus.py parse_sighan_test): raw truth files
    without a space after commas — 'A2-0001-1,2,俊' — must not collapse
    into a single bogus id."""
    import re

    parts = [p for p in re.split(r",\s*", line.strip())]
    sid = parts[0]
    if len(parts) == 2 and parts[1] == "0":
        return sid, []
    edits: List[Edit] = []
    for i in range(1, len(parts) - 1, 2):
        edits.append((int(parts[i]), parts[i + 1]))
    return sid, edits


def read_label_file(path: str) -> List[LabelItem]:
    with open(path, "r", encoding="utf-8") as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    return [parse_label_line(ln) for ln in lines]


def format_label_line(sid: str, edits: Sequence[Edit]) -> str:
    """Inverse of :func:`parse_label_line` (reference: src/metric.py:69-76)."""
    if not edits:
        return f"{sid}, 0"
    parts = [sid]
    for pos, char in edits:
        parts.append(str(pos))
        parts.append(char)
    return ", ".join(parts)


def _prf(tp: int, pred_p: int, targ_p: int, hit: int, n: int, prefix: str) -> Dict[str, float]:
    acc = hit / n if n else 0.0
    p = tp / pred_p if pred_p else 0.0
    r = tp / targ_p if targ_p else 0.0
    f1 = 2 * p * r / (p + r) if p + r > 0 else 0.0
    return {
        f"{prefix}-acc": acc * 100,
        f"{prefix}-p": p * 100,
        f"{prefix}-r": r * 100,
        f"{prefix}-f1": f1 * 100,
    }


def sent_metric_detect(preds: Sequence[LabelItem], targs: Sequence[LabelItem]) -> Dict[str, float]:
    """Sentence-level detection A/P/R/F1 (reference: src/metric_core.py:33-58)."""
    if len(preds) != len(targs):
        raise ValueError(f"pred/target length mismatch: {len(preds)} vs {len(targs)}")
    tp = targ_p = pred_p = hit = 0
    for (pid, pedits), (tid, tedits) in zip(preds, targs):
        if pid != tid:
            raise ValueError(f"id mismatch: {pid!r} vs {tid!r}")
        pred = sorted(pedits)
        targ = sorted(tedits)
        if targ:
            targ_p += 1
        if pred:
            pred_p += 1
        positions_match = (
            len(pred) == len(targ)
            and all(p[0] == t[0] for p, t in zip(pred, targ))
        )
        if positions_match:
            hit += 1
            if pred:
                tp += 1
    return _prf(tp, pred_p, targ_p, hit, len(targs), "sent-detect")


def sent_metric_correct(preds: Sequence[LabelItem], targs: Sequence[LabelItem]) -> Dict[str, float]:
    """Sentence-level correction A/P/R/F1 (reference: src/metric_core.py:61-86)."""
    if len(preds) != len(targs):
        raise ValueError(f"pred/target length mismatch: {len(preds)} vs {len(targs)}")
    tp = targ_p = pred_p = hit = 0
    for (pid, pedits), (tid, tedits) in zip(preds, targs):
        if pid != tid:
            raise ValueError(f"id mismatch: {pid!r} vs {tid!r}")
        pred = sorted(pedits)
        targ = sorted(tedits)
        if targ:
            targ_p += 1
        if pred:
            pred_p += 1
        if pred == targ:
            hit += 1
            if pred:
                tp += 1
    return _prf(tp, pred_p, targ_p, hit, len(targs), "sent-correct")


def metric_items(preds: Sequence[LabelItem], targs: Sequence[LabelItem]) -> Dict[str, float]:
    results: Dict[str, float] = {}
    results.update(sent_metric_detect(preds, targs))
    results.update(sent_metric_correct(preds, targs))
    return results


def metric_file(pred_path: str, targ_path: str) -> Dict[str, float]:
    """Score a prediction label file against a target label file."""
    return metric_items(read_label_file(pred_path), read_label_file(targ_path))


def main(argv: Sequence[str] | None = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input", "-i", required=True)
    parser.add_argument("--target", "-t", required=True)
    args = parser.parse_args(argv)
    for k, v in metric_file(args.input, args.target).items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
