"""SIGHAN13 convention: drop 地/得 corrections before scoring (the port's own
copy of ``realise_tpu.eval.remove_de``; ``remove_de`` also returns how many
edits it dropped).

The SIGHAN13 test set does not annotate 的/地/得 confusions consistently, so the
reference deletes any predicted correction whose char is 地 or 得 from the label
file before scoring year 13 (reference: src/remove_de.py:9-19, applied at
src/test.py:158). We implement it structurally on parsed label items instead of
regex-on-raw-text, which also removes the reference's implicit assumption that
every sentence id is exactly 5 digits (src/remove_de.py:16)."""

from __future__ import annotations

from typing import List

from realise_tpu_torch.eval.metric_core import (
    LabelItem,
    format_label_line,
    parse_label_line,
)


def remove_de_items(items: List[LabelItem]) -> List[LabelItem]:
    out: List[LabelItem] = []
    for sid, edits in items:
        out.append((sid, [(p, c) for p, c in edits if c not in ("地", "得")]))
    return out


def remove_de(input_path: str, output_path: str) -> int:
    """Filter a label file; returns the number of edits dropped."""
    with open(input_path, "r", encoding="utf-8") as f:
        items = [parse_label_line(ln) for ln in f.read().splitlines()
                 if ln.strip()]
    kept = remove_de_items(items)
    with open(output_path, "w", encoding="utf-8") as f:
        f.write("\n".join(format_label_line(sid, edits)
                          for sid, edits in kept) + "\n")
    return sum(len(e) for _, e in items) - sum(len(e) for _, e in kept)


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--output_path", required=True)
    args = parser.parse_args()
    remove_de(args.input_path, args.output_path)
