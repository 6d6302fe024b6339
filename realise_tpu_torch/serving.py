"""Serving core: load a checkpoint once, correct sentences fast.

The port of ``realise_tpu.serving.Corrector`` without the cross-request
batcher (a later slice). It owns the checkpoint and config, the tokenizer
and featurizer, the precomputed per-vocab GRU/glyph tables (the fast path
that takes the conv stack and the GRU loop off the hot loop), the model on
its device and the prediction → text splice. One device step is one
deterministic forward under ``torch.inference_mode()`` ending in argmax;
with ``use_kernels`` every encoder layer runs the two fused block kernels.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from realise_tpu_torch.data.features import Featurizer, to_device
from realise_tpu_torch.device import resolve_device
from realise_tpu_torch.eval.metric import Metric
from realise_tpu_torch.models.realise import Realise, precompute_inference_tables
from realise_tpu_torch.ops.kernels import kernels_unviable_reason
from realise_tpu_torch.text.tokenizer import WordPieceTokenizer
from realise_tpu_torch.text.vocab import (
    REAL_VOCAB_CJK_CHARS,
    build_synthetic_vocab,
    vocab_to_dict,
)
from realise_tpu_torch.training.checkpoint import (
    list_checkpoints,
    load_checkpoint,
    load_config,
)


class Corrector:
    """Spelling-correction engine over a port checkpoint.

    ``device``: None → CUDA (raises without one). ``use_kernels``: None → on
    for CUDA; a config the kernels cannot run raises with the reason unless
    the caller passes ``use_kernels=False``. ``synthetic_vocab``: a seeded
    synthetic vocab of the checkpoint's size with the real vocab's share of
    single CJK chars (``build_synthetic_vocab``)."""

    def __init__(
        self,
        ckpt_dir: str,
        vocab_path: Optional[str] = None,
        batch_size: int = 32,
        use_kernels: Optional[bool] = None,
        fast_path: bool = True,
        synthetic_vocab: bool = False,
        length_buckets: Sequence[int] = (32, 64, 128),
        device=None,
    ):
        self.device = resolve_device(device)
        ckpts = list_checkpoints(ckpt_dir)
        ckpt_path = ckpts[-1][1] if ckpts else ckpt_dir
        self.cfg = load_config(ckpt_path)
        dtype = getattr(torch, self.cfg.dtype)
        if use_kernels is None:
            use_kernels = self.device.type == "cuda"
        if use_kernels:
            reason = kernels_unviable_reason(self.cfg, dtype, self.device)
            if reason is not None:
                raise ValueError(
                    f"the fused block kernels cannot serve this checkpoint: "
                    f"{reason}; pass use_kernels=False for the plain path")
        self.use_kernels = use_kernels
        self.batch_size = batch_size

        if vocab_path:
            self.tokenizer = WordPieceTokenizer.from_pretrained(vocab_path)
        elif synthetic_vocab:
            self.tokenizer = WordPieceTokenizer(vocab_to_dict(
                build_synthetic_vocab(size=self.cfg.vocab_size,
                                      cjk_chars=REAL_VOCAB_CJK_CHARS)))
        else:
            raise ValueError("need vocab_path (or synthetic_vocab=True)")
        if len(self.tokenizer) != self.cfg.vocab_size:
            raise ValueError(
                f"tokenizer vocab ({len(self.tokenizer)}) != model vocab "
                f"({self.cfg.vocab_size})")
        self.featurizer = Featurizer(self.tokenizer, self.cfg)
        self.metric = Metric(self.tokenizer)

        # Built on the meta device: the checkpoint's tensors replace every
        # parameter and buffer, so no init is computed only to be discarded.
        with torch.device("meta"):
            model = Realise(self.cfg)
        model.load_state_dict(load_checkpoint(ckpt_path), assign=True)
        self.model = model.to(self.device).eval()

        self.tables = None
        if fast_path:
            idx, lens = self.featurizer.pho2_tables()
            self.tables = precompute_inference_tables(self.model, idx, lens)
        self.steps = 0  # device steps run, for callers that count launches

        s_max = self.cfg.max_seq_length
        self._buckets = sorted({min(int(b), s_max)
                                for b in length_buckets} | {s_max})
        # Batch-dim buckets: a single-sentence request computes 1 row, not
        # batch_size rows.
        self._batch_buckets = sorted(
            {1} | {b for b in (8, 16, 32, 64, 128) if b < batch_size}
            | {batch_size})

    def _bucket_for(self, sentences: Sequence[str]) -> int:
        # +2 for [CLS]/[SEP]; WordPiece can only shrink char counts for CJK.
        need = max((len(s) for s in sentences), default=0) + 2
        for b in self._buckets:
            if need <= b:
                return b
        return self._buckets[-1]

    def _batch_bucket_for(self, n: int) -> int:
        for b in self._batch_buckets:
            if n <= b:
                return b
        return self._batch_buckets[-1]

    def warmup(self) -> None:
        """Run one small request so the first real one finds the kernels
        built and loaded."""
        self.correct(["好"])

    @torch.inference_mode()
    def logits(self, device_arrays: Dict[str, np.ndarray]) -> torch.Tensor:
        """(B, S, V) logits of a featurized device batch."""
        batch = to_device(device_arrays, self.device)
        return self.model(batch, tables=self.tables,
                          use_kernels=self.use_kernels)["logits"]

    def _device_step(self, device_arrays: Dict[str, np.ndarray]) -> np.ndarray:
        """One step over a bucket-shaped batch → (B, S) predicted ids."""
        preds = self.logits(device_arrays).argmax(-1).cpu().numpy()
        self.steps += 1
        return preds

    def correct_batch(self, sentences: Sequence[str],
                      seq_len: Optional[int] = None) -> List[str]:
        """One device batch (≤ batch_size sentences) → corrected strings.

        Requests are padded with copies of the last sentence to the smallest
        batch bucket that fits, so a step sees one of a few shapes."""
        n = len(sentences)
        if n == 0:
            return []
        seq = seq_len or self._bucket_for(sentences)
        rows = self._batch_bucket_for(n)
        padded = list(sentences) + [sentences[-1]] * (rows - n)
        host = self.featurizer.featurize_raw(padded, seq_len=seq)
        host["pred_idx"] = self._device_step(self.featurizer.device_batch(host))
        return [self._reconstruct(sentences[i], host, i) for i in range(n)]

    def _reconstruct(self, src: str, host, i) -> str:
        """Splice predicted tokens back into the ORIGINAL sentence.

        Each token maps to its source span (tokenize_with_spans) and only
        clean same-width corrections are substituted, so whitespace, casing
        and un-tokenizable characters of the input survive. Where the span
        tokenization disagrees with the featurizer, the reference's width
        reconstruction (eval/metric.py) is used instead."""
        spans = self.tokenizer.tokenize_with_spans(src)
        length = int(host["lengths"][i])
        pred_ids = np.asarray(host["pred_idx"][i]).tolist()[1 : 1 + length]
        pred_tokens = self.tokenizer.convert_ids_to_tokens(pred_ids)
        if len(spans) != length:
            pred_txt, _ = self.metric.process_batch_item(host, i)
            return pred_txt.split("\t", 1)[1]
        out = list(src)
        unk = self.tokenizer.unk_token
        for (tok, a, b), pred in zip(spans, pred_tokens):
            if pred == tok or pred == unk or tok == unk:
                # tok == unk: the model never saw the original char — keep it.
                continue
            piece = pred[2:] if pred.startswith("##") else pred
            if len(piece) == b - a:
                out[a:b] = piece
            # width mismatch: no faithful per-char mapping — keep the original.
        return "".join(out)

    def correct(self, sentences: Sequence[str]) -> List[str]:
        """Any number of sentences, chunked into device batches."""
        out: List[str] = []
        for start in range(0, len(sentences), self.batch_size):
            out.extend(self.correct_batch(
                sentences[start : start + self.batch_size]))
        return out

    @staticmethod
    def edits(src: str, corrected: str) -> List[Tuple[int, str, str]]:
        """1-based (pos, wrong, correct) diffs."""
        return [(i, a, b)
                for i, (a, b) in enumerate(zip(src, corrected), start=1)
                if a != b]

    def correct_with_edits(self, sentences: Sequence[str]) -> List[Dict]:
        corrected = self.correct(sentences)
        return [{"input": s, "corrected": c,
                 "edits": [{"pos": p, "wrong": w, "correct": r}
                           for p, w, r in self.edits(s, c)]}
                for s, c in zip(sentences, corrected)]
