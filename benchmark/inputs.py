"""What the benchmark makes from ``--seed`` and hands to both the program and
the reference: the vocabulary file, the weights and glyphs, the sentences.

Sizes that shape the work (sentence lengths, request sizes, gaps between
arrivals, which chars are frequent, the order of the training batches) come
from the traffic file's ``shape_seed`` and are the same in every run;
``--seed`` draws the chars and shares the lengths out over the sentences.
So two seeds carry the same work.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference import text

NORMAL_STD = 0.02


def build_vocab(root: str, cfg: Dict, directory: str) -> Tuple[List[str], str, Dict]:
    """(vocab, path of the vocab.txt written into ``directory``, table)."""
    table = text.read_pinyin_table(text.pinyin_table_path(root))
    vocab = text.synthetic_vocab(table, cfg["vocab_size"],
                                 cfg["assumed"]["vocab_cjk_chars"])
    path = os.path.join(directory, "vocab.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    return vocab, path, table


def _leaf_scale(name: str, shape) -> Tuple[float, float]:
    """(mean, std) of a leaf's seeded values."""
    if name.endswith("running_var"):
        return 1.0, 0.1
    if name.endswith("running_mean"):
        return 0.0, 0.1
    if len(shape) == 4:  # convolution: He normal
        fan_in = shape[1] * shape[2] * shape[3]
        return 0.0, (2.0 / fan_in) ** 0.5
    if name.endswith(".weight") and len(shape) == 1:  # LayerNorm, BatchNorm
        return 1.0, NORMAL_STD
    return 0.0, NORMAL_STD


@torch.no_grad()
def make_weights(shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
                 cjk: np.ndarray, seed: int, device,
                 glyph_density: float) -> Dict[str, torch.Tensor]:
    """Every tensor of the model's state dict, made on ``device`` from the
    seed in two calls: one normal draw split over the float leaves (biases
    and statistics included, so no term is trivially zero), one uniform draw
    for the glyphs: each CJK token's (fonts, 32, 32) stack is random ink at
    ``glyph_density``, every other token the blank image (the real vocab's
    composition: the non-CJK rows share one glyph)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    floats = [(n, s) for n, (s, dt) in shapes.items()
              if dt.is_floating_point and n != "char_images_multifonts"]
    total = sum(int(np.prod(s)) for _, s in floats)
    flat = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for name, shape in floats:
        n = int(np.prod(shape))
        mean, std = _leaf_scale(name, shape)
        leaf = flat[offset:offset + n].view(shape).mul(std)
        if name.endswith("running_var"):
            leaf = leaf.abs_()
        out[name] = leaf.add_(mean)
        offset += n
    for name, (shape, dt) in shapes.items():
        if not dt.is_floating_point:
            out[name] = torch.zeros(shape, dtype=dt, device=device)
    if "char_images_multifonts" in shapes:
        shape = shapes["char_images_multifonts"][0]
        glyphs = torch.zeros(shape, device=device)
        ink = torch.rand((len(cjk),) + tuple(shape[1:]), generator=gen,
                         device=device)
        glyphs[torch.as_tensor(cjk, device=device)] = (
            ink < glyph_density).float()
        out["char_images_multifonts"] = glyphs
    return out


class Sentences:
    """Seeded Chinese sentences over the vocabulary's CJK chars: lengths from
    a log-normal (right-skewed) cut to [lo, hi], chars Zipf-distributed over
    the CJK tokens (their frequency order fixed by ``shape_seed``)."""

    def __init__(self, vocab: Sequence[str], cjk: np.ndarray, params: Dict):
        self.vocab = vocab
        self.params = params
        shape = np.random.default_rng(params["shape_seed"])
        self.ranked = cjk[shape.permutation(len(cjk))]
        weights = 1.0 / np.arange(1, len(cjk) + 1) ** params["zipf_exponent"]
        self.cdf = np.cumsum(weights / weights.sum())
        self.chars = np.asarray([vocab[i] for i in range(len(vocab))],
                                dtype=object)

    def lengths(self, n: int) -> np.ndarray:
        """n lengths drawn from ``shape_seed`` alone (the same in every run)."""
        p = self.params
        rng = np.random.default_rng([p["shape_seed"], 1, n])
        mu = np.log(p["length_mean"]) - p["length_sigma"] ** 2 / 2
        raw = rng.lognormal(mu, p["length_sigma"], n)
        return np.clip(np.rint(raw), p["length_min"], p["length_max"]).astype(
            np.int64)

    def draw_ids(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return self.ranked[np.searchsorted(self.cdf, rng.random(n))]


def training_pool(sent: Sentences, seed: int, size: int, error_rate: float,
                  cls_id: int, sep_id: int) -> List[Dict]:
    """``size`` examples in the reference pkl schema (process_data.py:33-45):
    targets from :class:`Sentences`, sources with ``error_rate`` of the
    positions replaced by another char."""
    rng = np.random.default_rng([seed, 2])
    lengths = rng.permutation(sent.lengths(size))
    tgt_all = sent.draw_ids(rng, int(lengths.sum()))
    wrong = rng.random(tgt_all.shape[0]) < error_rate
    src_all = np.where(wrong, sent.draw_ids(rng, tgt_all.shape[0]), tgt_all)
    pool, offset = [], 0
    for i, n in enumerate(lengths.tolist()):
        src = src_all[offset:offset + n].tolist()
        tgt = tgt_all[offset:offset + n].tolist()
        offset += n
        pool.append({"id": str(i), "src": "".join(sent.chars[src]),
                     "tgt": "".join(sent.chars[tgt]), "tokens_size": [1] * n,
                     "src_idx": [cls_id] + src + [sep_id],
                     "tgt_idx": [cls_id] + tgt + [sep_id], "lengths": n})
    return pool


def pad_rows(examples: Sequence[Dict], seq_len: int, rows: int,
             device) -> Dict[str, torch.Tensor]:
    """The reference's own (rows, seq_len) arrays of a batch: the examples,
    then copies of the last one with no loss positions."""
    src = torch.zeros((rows, seq_len), dtype=torch.long)
    tgt = torch.zeros((rows, seq_len), dtype=torch.long)
    masks = torch.zeros((rows, seq_len), dtype=torch.long)
    loss = torch.zeros((rows, seq_len), dtype=torch.long)
    for r in range(rows):
        ex = examples[min(r, len(examples) - 1)]
        n = len(ex["src_idx"])
        src[r, :n] = torch.as_tensor(ex["src_idx"])
        tgt[r, :n] = torch.as_tensor(ex["tgt_idx"])
        masks[r, :n] = 1
        if r < len(examples):
            loss[r, 1:1 + ex["lengths"]] = 1
    return {k: v.to(device) for k, v in (("src_idx", src), ("tgt_idx", tgt),
                                         ("masks", masks),
                                         ("loss_masks", loss))}
