"""Prediction → SIGHAN label files and their scores: the reference's Metric
(src/metric.py), the port's copy of ``realise_tpu.eval.metric.Metric``.

Token ids go back to text by token width — ``##`` prefixes stripped, the UNK
token mapped to the literal ``'U'``, each token re-expanded to its source
width from ``tokens_size`` (padded with ``'x'``) — and the label line lists
the 1-based positions where the prediction differs from the source. The
serving reconstruction falls back to it. SIGHAN13 is scored after
``remove_de`` (src/metric.py:15-19).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Mapping, Tuple

import numpy as np

from realise_tpu_torch.eval.metric_core import metric_file
from realise_tpu_torch.eval.remove_de import remove_de


class Metric:
    """``tokenizer`` needs ``convert_ids_to_tokens`` and ``unk_token``."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer

    def metric(self, batches: Iterable[Mapping], pred_txt_path: str,
               pred_lbl_path: str, label_path: str,
               should_remove_de: bool = False) -> Dict[str, float]:
        """Write the predictions of ``batches`` (host batches with
        ``pred_idx``) and score them against the label file."""
        self.write_pred(batches, pred_txt_path, pred_lbl_path)
        if should_remove_de:
            remove_de(input_path=pred_lbl_path, output_path=pred_lbl_path)
        return metric_file(pred_path=pred_lbl_path, targ_path=label_path)

    def write_pred(self, batches: Iterable[Mapping], pred_txt_path: str,
                   pred_lbl_path: str) -> None:
        """One text line (``id\\tpredicted text``) and one label line per
        example."""
        txt_lines: List[str] = []
        lbl_lines: List[str] = []
        for batch in batches:
            for i in range(np.asarray(batch["src_idx"]).shape[0]):
                pred_txt, pred_lbl = self.process_batch_item(batch, i)
                txt_lines.append(pred_txt)
                lbl_lines.append(pred_lbl)
        for path in (pred_lbl_path, pred_txt_path):
            if os.path.dirname(path):
                os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(pred_lbl_path, "w", encoding="utf-8") as f:
            f.write("\n".join(lbl_lines))
        with open(pred_txt_path, "w", encoding="utf-8") as f:
            f.write("\n".join(txt_lines))

    def process_batch_item(self, batch: Mapping, idx: int) -> Tuple[str, str]:
        """Reconstruct predicted text for one example and diff it vs source."""
        length = int(batch["lengths"][idx])
        # Truncated examples keep [CLS] + width-2 content + [SEP].
        length = min(length, int(np.asarray(batch["src_idx"]).shape[1]) - 2)

        pred_idx = np.asarray(batch["pred_idx"][idx]).tolist()
        # Positions 1..length hold the sentence (src/metric.py:50-51).
        pred_idx = pred_idx[1 : 1 + length]
        tokens = self.tokenizer.convert_ids_to_tokens(pred_idx)
        tokens = [t[2:] if t.startswith("##") else t for t in tokens]
        unk = self.tokenizer.unk_token
        tokens = ["U" if t == unk else t for t in tokens]

        sized: List[str] = []
        for size, tok in zip(batch["tokens_size"][idx], tokens):
            piece = tok[:size]
            if len(piece) < size:
                piece += "x" * (size - len(piece))
            sized.append(piece)
        pred = "".join(sized)
        sid = batch["id"][idx]
        pred_txt = f"{sid}\t{pred}"

        src = batch["src"][idx]
        # Reference semantics (src/metric.py:65-66): a reconstruction shorter
        # than the source drops the source tail before diffing.
        if len(src) > len(pred):
            src = src[: len(pred)]
        if len(pred) != len(src):
            raise ValueError(
                f"prediction/source length mismatch for {sid}: "
                f"{len(pred)} vs {len(src)}")

        edits = []
        for pos, (a, b) in enumerate(zip(src, pred), start=1):
            if a != b:
                edits.append(str(pos))
                edits.append(b)
        pred_lbl = ", ".join([sid] + edits) if edits else f"{sid}, 0"
        return pred_txt, pred_lbl
