"""Prediction → text reconstruction of the reference's Metric (src/metric.py).

The port's copy of ``realise_tpu.eval.metric.Metric.process_batch_item``:
token ids back to text by token width — ``##`` prefixes stripped, the UNK
token mapped to the literal ``'U'``, each token re-expanded to its source
width from ``tokens_size`` (padded with ``'x'``) — plus the label line of
1-based positions where the prediction differs from the source. The serving
reconstruction falls back to it. Scoring (``metric_core``, ``remove_de``) is
not ported yet.
"""

from __future__ import annotations

from typing import List, Mapping, Tuple

import numpy as np


class Metric:
    """``tokenizer`` needs ``convert_ids_to_tokens`` and ``unk_token``."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer

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
