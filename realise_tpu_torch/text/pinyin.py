"""Pinyin featurization for the phonetic ("Listen") stream.

The port's own copy of the tone-first scheme of ``realise_tpu.text.pinyin``
(reference: src/utils.py:58-99): char → tone-first pinyin string
("hao3" → "3hao") over a 33-symbol alphabet: 'P' (pad) + '1'-'5' + 'a'-'z' +
'U' (unknown). ``convert`` pads to a fixed width so every batch has one shape.

The char → pinyin source of truth is pypinyin (TONE3 style,
``neutral_tone_with_five=True``, errors → 'U', src/utils.py:26-31) when it is
installed, else the table shipped with the package (assets/pinyin_table.tsv).
The pho1 (initial/final/tone) scheme belongs to presets outside the arch3
serving path and is not ported yet.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Sequence, Tuple

import numpy as np

_ASSET_TABLE = os.path.join(os.path.dirname(__file__), "assets", "pinyin_table.tsv")


def _load_builtin_table(path: str = _ASSET_TABLE) -> Dict[str, str]:
    table: Dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            # col 3 (optional) is reading provenance — not needed at runtime.
            ch, py = line.split("\t")[:2]
            table[ch] = py
    return table


@functools.lru_cache(maxsize=1)
def _pypinyin_module():
    try:
        import pypinyin  # type: ignore

        return pypinyin
    except ImportError:
        return None


@functools.lru_cache(maxsize=1)
def _builtin_table() -> Dict[str, str]:
    return _load_builtin_table()


@functools.lru_cache(maxsize=200_000)
def tone3(char: str) -> str:
    """Return the TONE3 pinyin (e.g. ``'hao3'``) of a single char, or ``'U'``.

    Multi-char tokens (WordPiece pieces, [UNK], …) are 'U' (src/utils.py:74-75).
    """
    if len(char) != 1:
        return "U"
    mod = _pypinyin_module()
    if mod is not None:
        s = mod.pinyin(
            char,
            style=mod.Style.TONE3,
            neutral_tone_with_five=True,
            errors=lambda x: ["U" for _ in x],
        )[0][0]
        if s == "U" or s[-1] not in "12345":
            return "U"
        return s
    return _builtin_table().get(char, "U")


class Pinyin2Convertor:
    """Tone-first character-sequence scheme (reference: src/utils.py:58-99)."""

    def __init__(self, max_len: int = 8):
        vocab = ["P"]
        vocab += [chr(x) for x in range(ord("1"), ord("5") + 1)]
        vocab += [chr(x) for x in range(ord("a"), ord("z") + 1)]
        vocab += ["U"]
        self.vocab_list = vocab
        self.vocab = {c: i for i, c in enumerate(vocab)}
        self.max_len = max_len

    def get_pho_size(self) -> int:
        return len(self.vocab_list)

    def get_pinyin(self, char: str) -> str:
        s = tone3(char)
        if s == "U":
            return "U"
        # Move the tone digit to the front: 'hao3' → '3hao' (src/utils.py:87).
        return s[-1] + s[:-1]

    def convert(self, tokens: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """tokens → (ids [N, max_len] int32 padded with 0, lens [N] int32)."""
        n = len(tokens)
        ids = np.zeros((n, self.max_len), dtype=np.int32)
        lens = np.zeros((n,), dtype=np.int32)
        unk = self.vocab["U"]
        for i, tok in enumerate(tokens):
            s = self.get_pinyin(tok)[: self.max_len]
            lens[i] = len(s)
            for j, c in enumerate(s):
                ids[i, j] = self.vocab.get(c, unk)
        return ids, lens
