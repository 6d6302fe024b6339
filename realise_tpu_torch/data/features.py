"""Featurization: sentences → fixed-shape arrays (the port's own copy of the
serving half of ``realise_tpu.data.features``).

Pinyin features depend only on the token id, so one (V, P) pinyin-id table
and a (V,) length table are built per vocabulary and a batch gathers from
them. The host batch holds numpy arrays in the reference batch contract
(run.py:68-101):

    src_idx/tgt_idx  (B, S) int32, zero-padded
    masks            (B, S) int32, 1 on [CLS]+sentence+[SEP]
    loss_masks       (B, S) int32, 1 on sentence positions 1..length
    pho_idx          (B, S, P) int32   (pho2 models)
    pho_lens         (B, S) int32
    pho1_idx         (B, S, 3) int32   (pho1 models)

plus the host-only fields (id, src, tgt, tokens_size, lengths) that the text
reconstruction reads. The glyph pretraining's batches are ``char_idx`` (N,)
alone; the pinyin pretraining's come from :meth:`Featurizer.
featurize_pho_pretrain`. The pinyin features are a gather of the vocab tables
on ``src_idx`` after either featurizer. :func:`to_device` turns the device
part into int64 tensors, the conv stream's distinct rows of a call
(``res_rows``, ``res_inverse``, ``res_counts``, ``Realise.conv_rows``) too. Raw sentences
are tokenized by the Python tokenizer or, given a
``data.native.NativeFeaturizer``, by the C++ one
(``Featurizer.featurize_raw``); both give the same arrays.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.text.pinyin import Pinyin1Convertor, Pinyin2Convertor
from realise_tpu_torch.text.tokenizer import WordPieceTokenizer, is_chinese_char

DEVICE_KEYS = ("src_idx", "tgt_idx", "masks", "loss_masks", "pho_idx",
               "pho_lens", "pho1_idx", "char_idx", "res_rows", "res_inverse",
               "res_counts")


def make_example(sid: str, src: str, tgt: str, tokenizer: WordPieceTokenizer) -> Dict:
    """Build one example in the reference pkl schema (process_data.py:33-36:
    len(src_idx)==len(tgt_idx)==lengths+2, lengths==len(tokens_size))."""
    src_tokens = tokenizer.tokenize(src)
    tgt_tokens = tokenizer.tokenize(tgt)
    # CSC is char-aligned; enforce equal token counts.
    if len(src_tokens) != len(tgt_tokens):
        raise ValueError(
            f"source/target token mismatch for {sid}: "
            f"{len(src_tokens)} vs {len(tgt_tokens)}")
    tokens_size = []
    for t in src_tokens:
        if t == tokenizer.unk_token:
            tokens_size.append(1)
        elif t.startswith("##"):
            tokens_size.append(len(t) - 2)
        else:
            tokens_size.append(len(t))
    src_idx = tokenizer.convert_tokens_to_ids(
        [tokenizer.cls_token] + src_tokens + [tokenizer.sep_token])
    tgt_idx = tokenizer.convert_tokens_to_ids(
        [tokenizer.cls_token] + tgt_tokens + [tokenizer.sep_token])
    return {
        "id": sid,
        "src": src,
        "tgt": tgt,
        "tokens_size": tokens_size,
        "src_idx": src_idx,
        "tgt_idx": tgt_idx,
        "lengths": len(src_tokens),
    }


class Featurizer:
    """Vocab-level pinyin tables + batch assembly."""

    def __init__(self, tokenizer: WordPieceTokenizer, cfg: RealiseConfig):
        self.tokenizer = tokenizer
        self.cfg = cfg
        self._pho2_table: Optional[np.ndarray] = None
        self._pho2_lens: Optional[np.ndarray] = None
        self._pho1_table: Optional[np.ndarray] = None
        self._cjk_mask: Optional[np.ndarray] = None

    def pho2_tables(self):
        """(V, P) pinyin char ids + (V,) lens for every vocab token."""
        if self._pho2_table is None:
            conv = Pinyin2Convertor(max_len=self.cfg.pho2_max_len)
            vocab = self.tokenizer.convert_ids_to_tokens(
                range(len(self.tokenizer)))
            self._pho2_table, self._pho2_lens = conv.convert(vocab)
        return self._pho2_table, self._pho2_lens

    def pho1_table(self) -> np.ndarray:
        """(V, 3) initial/final/tone ids for every vocab token."""
        if self._pho1_table is None:
            vocab = self.tokenizer.convert_ids_to_tokens(
                range(len(self.tokenizer)))
            self._pho1_table = np.asarray(Pinyin1Convertor().convert(vocab),
                                          dtype=np.int32)
        return self._pho1_table

    def cjk_token_mask(self) -> np.ndarray:
        """(V,) bool: the vocab tokens that are single Chinese chars
        (memoized: the pinyin pretraining's loader reads it every batch)."""
        if self._cjk_mask is None:
            vocab = self.tokenizer.convert_ids_to_tokens(
                range(len(self.tokenizer)))
            self._cjk_mask = np.asarray(
                [len(t) == 1 and is_chinese_char(ord(t)) for t in vocab], bool)
        return self._cjk_mask

    def featurize(self, examples: Sequence[Dict], with_labels: bool = True,
                  seq_len: Optional[int] = None) -> Dict:
        """Examples → fixed-shape arrays + passthrough fields.

        ``seq_len`` overrides the padded length (length buckets)."""
        return self._add_pho(self._arrays(examples, with_labels, seq_len))

    def featurize_pho_pretrain(self, examples: Sequence[Dict]) -> Dict:
        """The pinyin pretraining's features (``featurize_pho_pretrain`` of
        the JAX package; reference run_pretrain.py:56-69): the model recovers
        each char from its pinyin alone, so the inputs are the *target* ids,
        the loss covers the Chinese chars among the loss positions, and the
        pinyin features are gathered for the new ``src_idx``."""
        batch = self._arrays(examples, with_labels=True)
        batch["src_idx"] = batch["tgt_idx"].copy()
        cjk = self.cjk_token_mask()
        batch["loss_masks"] = (batch["loss_masks"].astype(bool)
                               & cjk[batch["tgt_idx"]]).astype(np.int32)
        return self._add_pho(batch)

    def _arrays(self, examples: Sequence[Dict], with_labels: bool = True,
                seq_len: Optional[int] = None) -> Dict:
        """The id, mask and passthrough fields of :meth:`featurize`."""
        cfg = self.cfg
        s = seq_len or cfg.max_seq_length
        b = len(examples)
        src_idx = np.zeros((b, s), dtype=np.int32)
        tgt_idx = np.zeros((b, s), dtype=np.int32)
        masks = np.zeros((b, s), dtype=np.int32)
        loss_masks = np.zeros((b, s), dtype=np.int32)

        for i, ex in enumerate(examples):
            seq = ex["src_idx"]
            tseq = ex["tgt_idx"]
            if len(seq) > s:
                # Truncate BERT-style: keep [CLS] + s-2 content + [SEP].
                seq = list(seq[: s - 1]) + [seq[-1]]
                tseq = list(tseq[: s - 1]) + [tseq[-1]]
            src_idx[i, : len(seq)] = seq
            masks[i, : len(seq)] = 1
            tgt_idx[i, : len(tseq)] = tseq
            # loss positions 1..length (excl [CLS]/[SEP], run.py:87-92).
            upper = min(1 + ex["lengths"], s - 1)
            loss_masks[i, 1:upper] = 1

        batch = {
            "id": [ex["id"] for ex in examples],
            "src": [ex["src"] for ex in examples],
            "tgt": [ex["tgt"] for ex in examples],
            "tokens_size": [ex["tokens_size"] for ex in examples],
            "lengths": np.asarray([ex["lengths"] for ex in examples], np.int32),
            "src_idx": src_idx,
            "masks": masks,
            "loss_masks": loss_masks,
        }
        if with_labels:
            batch["tgt_idx"] = tgt_idx
        return batch

    def _add_pho(self, batch: Dict) -> Dict:
        """The pinyin features of ``batch['src_idx']``: a table gather."""
        pho_encoder = self.cfg.pho_encoder
        if pho_encoder == "pho2":
            table, lens = self.pho2_tables()
            batch["pho_idx"] = table[batch["src_idx"]]   # (B, S, P) gather
            batch["pho_lens"] = lens[batch["src_idx"]]   # (B, S)
        elif pho_encoder == "pho1":
            batch["pho1_idx"] = self.pho1_table()[batch["src_idx"]]  # (B, S, 3)
        return batch

    def featurize_raw(self, sentences: Sequence[str], native=None,
                      seq_len: Optional[int] = None) -> Dict:
        """Raw sentences → the same host-batch contract as :meth:`featurize`.

        ``native``: an optional ``data.native.NativeFeaturizer``; the C++
        tokenizer then does tokenization and batch assembly in one call and
        only the pinyin gather stays in numpy. Without it the Python
        tokenizer path (:func:`make_example`) runs. Both give the same
        arrays."""
        s = seq_len or self.cfg.max_seq_length
        if native is None:
            examples = [make_example(str(i), t, t, self.tokenizer)
                        for i, t in enumerate(sentences)]
            return self.featurize(examples, with_labels=False, seq_len=s)
        enc = native.encode_batch(list(sentences), max_len=s)
        lengths = enc["lengths"]

        def sizes(i: int):
            # The full token widths (lengths == len(tokens_size)); the
            # (B, S) transport array holds at most S - 2, so a truncated
            # sentence takes its widths from the Python tokenizer (the id
            # arrays stay the native ones).
            n_tok = int(lengths[i])
            if n_tok <= s - 2:
                return enc["tokens_size"][i][:n_tok].tolist()
            return make_example(str(i), sentences[i], sentences[i],
                                self.tokenizer)["tokens_size"]

        return self._add_pho({
            "id": [str(i) for i in range(len(sentences))],
            "src": list(sentences),
            "tgt": list(sentences),
            "tokens_size": [sizes(i) for i in range(len(sentences))],
            "lengths": lengths,
            "src_idx": enc["src_idx"],
            "masks": enc["masks"],
            "loss_masks": enc["loss_masks"],
        })

    @staticmethod
    def device_batch(batch: Dict) -> Dict[str, np.ndarray]:
        """Strip host-only fields; what remains goes to the device."""
        return {k: v for k, v in batch.items() if k in DEVICE_KEYS}


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The device part of a host batch as int64 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.int64).to(device)
            for k, v in batch.items() if k in DEVICE_KEYS}
