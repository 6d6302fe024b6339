"""The vocabulary and the pinyin ids, worked out from the raw pinyin table.

The vocabulary is the structure of the real 21128-token BERT-Chinese
vocabulary: specials, ASCII, punctuation, the first ``cjk_chars`` chars of
the pinyin table in code-point order, ``##`` pieces, a few word pieces, then
unused slots (the configuration's ``assumed``: the real vocab.txt is not in
the repository). The benchmark writes it to a ``vocab.txt`` that the program
reads, so both sides see the same ids.

The pinyin ids are the reference's Pinyin2 scheme (src/utils.py:58-99):
tone-first strings ("hao3" -> "3hao") over 'P' (pad), '1'-'5', 'a'-'z',
'U' (unknown), padded to ``max_len``; a token that is not one char, or a
char the table lacks, is "U".
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

SPECIAL_TOKENS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
PUNCTUATION = ["，", "。", "！", "？", "、", "；", "：", "'", "'", "（", "）",
               "《", "》"]
PHO2_ALPHABET = (["P"] + [str(d) for d in range(1, 6)]
                 + [chr(c) for c in range(ord("a"), ord("z") + 1)] + ["U"])


def pinyin_table_path(root: str) -> str:
    """The raw char -> TONE3 pinyin table shipped with the port's package."""
    return os.path.join(root, "realise_tpu_torch", "text", "assets",
                        "pinyin_table.tsv")


def read_pinyin_table(path: str) -> Dict[str, str]:
    table: Dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if line:
                ch, py = line.split("\t")[:2]
                table[ch] = py
    return table


def synthetic_vocab(table: Dict[str, str], size: int,
                    cjk_chars: int) -> List[str]:
    vocab = list(SPECIAL_TOKENS)
    vocab += [chr(c) for c in range(ord("a"), ord("z") + 1)]
    vocab += [chr(c) for c in range(ord("0"), ord("9") + 1)]
    vocab += PUNCTUATION
    vocab += sorted(table)[:cjk_chars]
    vocab += ["##" + chr(c) for c in range(ord("a"), ord("z") + 1)]
    vocab += ["hello", "world", "##ing", "##ed"]
    out = list(dict.fromkeys(vocab))
    if size < len(out):
        return out[:size]
    return out + [f"[unused{i}]" for i in range(size - len(out))]


def pho2_ids(vocab: List[str], table: Dict[str, str],
             max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """(V, max_len) pinyin symbol ids and (V,) lengths of every token."""
    index = {c: i for i, c in enumerate(PHO2_ALPHABET)}
    ids = np.zeros((len(vocab), max_len), np.int64)
    lens = np.zeros((len(vocab),), np.int64)
    for i, tok in enumerate(vocab):
        s = table.get(tok, "U") if len(tok) == 1 else "U"
        if s != "U":
            s = s[-1] + s[:-1]
        s = s[:max_len]
        lens[i] = len(s)
        ids[i, :len(s)] = [index.get(c, index["U"]) for c in s]
    return ids, lens


def cjk_ids(vocab: List[str], table: Dict[str, str]) -> np.ndarray:
    """Ids of the single-char tokens the pinyin table knows (the CJK chars),
    in vocabulary order."""
    return np.asarray([i for i, t in enumerate(vocab)
                       if len(t) == 1 and t in table and ord(t) > 0x2FFF],
                      np.int64)
