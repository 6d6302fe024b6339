"""Vocabulary helpers (the port's own copy of ``realise_tpu.text.vocab``).

The production vocabulary is the 21128-token BERT-Chinese ``vocab.txt``
(reference: hfl/chinese-roberta-wwm-ext; loaded at src/run.py:426-428 and for
glyphs at src/models.py:704-706). When that asset is not on disk we can build
a structurally equivalent synthetic vocabulary — specials first, then ASCII,
then the CJK chars the pinyin table knows — for tests and smoke runs.
"""

from __future__ import annotations

from typing import Dict, List, Optional

SPECIAL_TOKENS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]

# Single-CJK entries of the real 21128-token hfl/chinese-roberta-wwm-ext vocab.
REAL_VOCAB_CJK_CHARS = 7606


def build_synthetic_vocab(size: Optional[int] = None,
                          cjk_chars: Optional[int] = None) -> List[str]:
    """Deterministic BERT-style vocab: specials, unused slots, ASCII, CJK.

    Mirrors the real vocab's shape: [PAD]=0, [UNK]=100-ish region is not
    replicated — ids are compact instead — but the *kinds* of entries (and the
    properties the featurizers rely on: single CJK chars dominate, '##'
    continuations exist) are preserved.

    ``cjk_chars`` caps the number of single-CJK entries. Default (None) is
    every char of the built-in pinyin table (~20.9k — nearly the whole CJK
    unified block). The REAL hfl/chinese-roberta-wwm-ext vocab the
    reference trains on (reference: README.md:45-48) contains only ~7.6k
    single CJK chars among its 21128 entries (~36% renderable — the rest
    is unused slots, subwords, Latin, symbols), which is what makes
    install_glyphs' dedup table ~2.8× smaller than the vocab; pass
    ``cjk_chars=7606`` to reproduce that composition at full vocab size.
    """
    from realise_tpu_torch.text.pinyin import _builtin_table

    vocab: List[str] = list(SPECIAL_TOKENS)
    vocab += [chr(c) for c in range(ord("a"), ord("z") + 1)]
    vocab += [chr(c) for c in range(ord("0"), ord("9") + 1)]
    vocab += list("，。！？、；：""''（）《》")
    cjk = sorted(_builtin_table().keys())
    if cjk_chars is not None:
        cjk = cjk[:cjk_chars]
    vocab += cjk
    vocab += ["##" + chr(c) for c in range(ord("a"), ord("z") + 1)]
    # A handful of multi-char word pieces so tokens_size>1 paths get exercised.
    vocab += ["hello", "world", "##ing", "##ed"]
    # Deduplicate preserving order.
    seen = set()
    uniq = []
    for t in vocab:
        if t not in seen:
            seen.add(t)
            uniq.append(t)
    if size is not None:
        if size < len(uniq):
            uniq = uniq[:size]
        else:
            uniq += [f"[unused{i}]" for i in range(size - len(uniq))]
    return uniq


def vocab_to_dict(vocab: List[str]) -> Dict[str, int]:
    return {t: i for i, t in enumerate(vocab)}
