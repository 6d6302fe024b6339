"""Pinyin featurization for the phonetic ("Listen") stream.

The port's own copy of the two schemes of ``realise_tpu.text.pinyin``:

* :class:`Pinyin1Convertor` (pho1 presets, reference: src/utils.py:5-55):
  char → (initial, final, tone) triple over a 65-symbol vocabulary: 3
  specials + 23 initials + 34 finals + 5 tone digits, with the 嗯 special
  case (src/utils.py:25);
* :class:`Pinyin2Convertor` (pho2 presets, src/utils.py:58-99): char →
  tone-first pinyin string ("hao3" → "3hao") over a 33-symbol alphabet:
  'P' (pad) + '1'-'5' + 'a'-'z' + 'U' (unknown). ``convert`` pads to a fixed
  width so every batch has one shape.

The char → pinyin source of truth is pypinyin (TONE3 style,
``neutral_tone_with_five=True``, errors → 'U', src/utils.py:26-31) when it is
installed, else the table shipped with the package (assets/pinyin_table.tsv).
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

_ASSET_TABLE = os.path.join(os.path.dirname(__file__), "assets", "pinyin_table.tsv")

# The reference maps 嗯 to (no initial, 'en', tone 2) in its Pinyin(1) only
# (src/utils.py:24-25); its Pinyin2 reads pypinyin's output for 嗯.
_PINYIN1_SPECIAL = {"嗯": ("[NULL]", "en", "2")}


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


class Pinyin1Convertor:
    """Initial/final/tone triple scheme (reference: src/utils.py:5-55)."""

    INITIALS = [
        "zh", "ch", "sh", "b", "p", "m", "f", "d", "t", "n", "l", "g", "k",
        "h", "j", "q", "x", "r", "z", "c", "s", "y", "w",
    ]
    FINALS = [
        "a", "ai", "an", "ang", "ao", "e", "ei", "en", "eng", "er", "i", "ia",
        "ian", "iang", "iao", "ie", "in", "ing", "iong", "iu", "o", "ong",
        "ou", "u", "ua", "uai", "uan", "uang", "ue", "ui", "un", "uo", "v",
        "ve",
    ]

    def __init__(self):
        self.vocab_list: List[str] = ["[PAD]", "[NULL]", "[UNK]"]
        self.vocab_list += self.INITIALS + self.FINALS
        self.vocab_list += ["1", "2", "3", "4", "5"]
        self.vocab = {p: i for i, p in enumerate(self.vocab_list)}

    def get_pho_size(self) -> int:
        return len(self.vocab_list)

    def get_pinyin(self, char: str) -> Tuple[str, str, str]:
        if char in _PINYIN1_SPECIAL:
            return _PINYIN1_SPECIAL[char]
        s = tone3(char)
        if s == "U":
            return "[UNK]", "[UNK]", "[UNK]"
        initial = next((c for c in self.INITIALS if s.startswith(c)), "[NULL]")
        body = s[:-1] if initial == "[NULL]" else s[len(initial):-1]
        return initial, body, s[-1]

    def convert(self, tokens: Sequence[str]) -> List[Tuple[int, int, int]]:
        """tokens → one (initial, final, tone) id triple each ('[UNK]' for a
        part outside the vocabulary)."""
        unk = self.vocab["[UNK]"]
        return [tuple(self.vocab.get(part, unk) for part in self.get_pinyin(tok))
                for tok in tokens]


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


# The reference's module-level converter (src/utils.py:55).
pho1_convertor = Pinyin1Convertor()
