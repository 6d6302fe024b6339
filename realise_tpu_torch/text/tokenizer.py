"""Self-contained BERT WordPiece tokenizer (the port's own copy of
``realise_tpu.text.tokenizer``).

A from-scratch implementation of the tokenization contract ReaLiSe depends on
(reference: transformers/tokenization_bert.py — BasicTokenizer :269,
WordpieceTokenizer :405, BertTokenizer :109): whitespace/control cleanup,
per-CJK-character splitting, punctuation splitting, optional lowercasing +
accent stripping, then greedy longest-match WordPiece with ``##``
continuations. Only the pieces the CSC pipeline uses are implemented; the HF
library is not required at runtime.

The metric reconstruction path (realise_tpu_torch.eval.metric) relies on
``convert_ids_to_tokens`` and ``unk_token`` exactly as the reference does
(src/metric.py:52-54).
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence


def is_chinese_char(cp: int) -> bool:
    """CJK codepoint predicate (reference: src/models.py:20-30 and
    transformers/tokenization_bert.py CJK ranges)."""
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges treated as punctuation even when unicode says otherwise
    # (^, $, ` etc.), matching BERT's tokenizer.
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def load_vocab(vocab_file: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(vocab_file, "r", encoding="utf-8") as f:
        for idx, line in enumerate(f):
            # rstrip CR too: a CRLF vocab.txt (Windows checkout) would
            # otherwise load every token with a trailing '\r' — specials
            # included, so even '[UNK]' lookups KeyError. The C++ loader
            # (csrc/featurizer.cpp) already pops the '\r'.
            token = line.rstrip("\r\n")
            vocab[token] = idx
    return vocab


class BasicTokenizer:
    """Cleanup + CJK/punctuation splitting + optional lowercasing."""

    def __init__(self, do_lower_case: bool = True, never_split: Optional[Sequence[str]] = None):
        self.do_lower_case = do_lower_case
        self.never_split = set(never_split or ())

    def tokenize(self, text: str) -> List[str]:
        text = self._clean_text(text)
        text = self._tokenize_chinese_chars(text)
        tokens: List[str] = []
        for tok in text.strip().split():
            if tok in self.never_split:
                tokens.append(tok)
                continue
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            tokens.extend(self._split_on_punc(tok))
        return tokens

    @staticmethod
    def _clean_text(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _tokenize_chinese_chars(text: str) -> str:
        out = []
        for ch in text:
            if is_chinese_char(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_on_punc(text: str) -> List[str]:
        out: List[List[str]] = []
        start_new = True
        for ch in text:
            if _is_punctuation(ch):
                out.append([ch])
                start_new = True
            else:
                if start_new:
                    out.append([])
                    start_new = False
                out[-1].append(ch)
        return ["".join(chunk) for chunk in out if chunk]


class WordpiecePiece:
    """Greedy longest-match-first WordPiece splitter."""

    def __init__(self, vocab: Dict[str, int], unk_token: str, max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word

    def tokenize(self, token: str) -> List[str]:
        if len(token) > self.max_input_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        n = len(token)
        while start < n:
            end = n
            piece = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces


class WordPieceTokenizer:
    """BERT-compatible tokenizer over a ``vocab.txt``.

    Mirrors the reference surface used by the runners and metric
    (src/run.py:426-428, src/metric.py:11): ``tokenize``, ``convert_tokens_to_ids``,
    ``convert_ids_to_tokens``, ``encode`` (adds [CLS]/[SEP]), special-token
    attributes.
    """

    def __init__(
        self,
        vocab: Dict[str, int],
        do_lower_case: bool = True,
        unk_token: str = "[UNK]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        cls_token: str = "[CLS]",
        mask_token: str = "[MASK]",
    ):
        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.unk_token = unk_token
        self.sep_token = sep_token
        self.pad_token = pad_token
        self.cls_token = cls_token
        self.mask_token = mask_token
        never_split = [unk_token, sep_token, pad_token, cls_token, mask_token]
        self.basic = BasicTokenizer(do_lower_case=do_lower_case, never_split=never_split)
        self.wordpiece = WordpiecePiece(vocab, unk_token=unk_token)

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_pretrained(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab_file = path
        if os.path.isdir(path):
            vocab_file = os.path.join(path, "vocab.txt")
        return cls(load_vocab(vocab_file), **kw)

    def save_pretrained(self, directory: str) -> str:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, "vocab.txt")
        items = sorted(self.vocab.items(), key=lambda kv: kv[1])
        with open(path, "w", encoding="utf-8") as f:
            for token, _ in items:
                f.write(token + "\n")
        return path

    # -- core ops -----------------------------------------------------------
    def tokenize(self, text: str) -> List[str]:
        pieces: List[str] = []
        for token in self.basic.tokenize(text):
            pieces.extend(self.wordpiece.tokenize(token))
        return pieces

    def tokenize_with_spans(self, text: str):
        """``tokenize`` plus [start, end) char offsets into the ORIGINAL text.

        The eval/metric path reconstructs text the reference's way (token
        widths only, src/metric.py:47-61) — faithful but lossy for inputs
        the tokenizer drops chars from (whitespace, control) or collapses
        (multi-char [UNK]). Serving uses these spans to splice corrections
        back into the user's original string instead (serving.Corrector).

        Token sequence equals ``tokenize(text)`` for text without
        never-split specials. Pieces whose normalized length differs from
        the source span (accent stripping) share the word's span: the first
        piece gets it, the rest are zero-width at its end.
        """
        spans: List[tuple] = []
        for word, a, b in self._basic_word_spans(text):
            norm = word
            if self.basic.do_lower_case:
                norm = self.basic._strip_accents(norm.lower())
            if not norm:
                continue
            pieces = self.wordpiece.tokenize(norm)
            widths = [len(p) - 2 if p.startswith("##") else len(p)
                      for p in pieces]
            if len(pieces) > 1 and sum(widths) == b - a:
                off = a
                for p, w in zip(pieces, widths):
                    spans.append((p, off, off + w))
                    off += w
            else:
                spans.append((pieces[0], a, b))
                for p in pieces[1:]:
                    spans.append((p, b, b))
        return spans

    def _basic_word_spans(self, text: str):
        """(word, start, end) triples replicating BasicTokenizer's splitting
        (clean → CJK isolation → whitespace split → punct split) while
        keeping offsets into the raw input. Dropped chars (control, U+0000,
        U+FFFD) simply never start or extend a word."""
        words: List[tuple] = []
        cur: List[str] = []
        cur_start = 0

        def flush(end: int):
            if cur:
                words.append(("".join(cur), cur_start, end))
                cur.clear()

        for i, ch in enumerate(text):
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                flush(i)
                continue
            if _is_whitespace(ch):
                flush(i)
                continue
            if is_chinese_char(cp) or _is_punctuation(ch):
                flush(i)
                words.append((ch, i, i + 1))
                continue
            if not cur:
                cur_start = i
            cur.append(ch)
        flush(len(text))
        return words

    def convert_tokens_to_ids(self, tokens: Iterable[str]) -> List[int]:
        unk_id = self.vocab[self.unk_token]
        return [self.vocab.get(t, unk_id) for t in tokens]

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.ids_to_tokens.get(int(i), self.unk_token) for i in ids]

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if add_special_tokens:
            ids = [self.cls_token_id] + ids + [self.sep_token_id]
        return ids

    # -- special token ids --------------------------------------------------
    @property
    def unk_token_id(self) -> int:
        return self.vocab[self.unk_token]

    @property
    def pad_token_id(self) -> int:
        return self.vocab[self.pad_token]

    @property
    def cls_token_id(self) -> int:
        return self.vocab[self.cls_token]

    @property
    def sep_token_id(self) -> int:
        return self.vocab[self.sep_token]

    @property
    def mask_token_id(self) -> int:
        return self.vocab[self.mask_token]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def __len__(self) -> int:
        return len(self.vocab)
