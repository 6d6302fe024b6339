"""Shared CLI plumbing of the port: arguments, tokenizer, config, glyphs,
data (the port's own copy of the training half of ``realise_tpu.cli.common``).

Flag names and meanings follow the JAX package's CLIs (which follow the
reference's src/run.py:282-391). Flags of parts the port does not have yet
are still accepted, and exit with the ROADMAP item that will bring them
rather than being ignored.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from realise_tpu_torch.config import RealiseConfig, config_for
from realise_tpu_torch.data.dataset import synthetic_dataset
from realise_tpu_torch.text.tokenizer import WordPieceTokenizer
from realise_tpu_torch.text.vocab import (
    REAL_VOCAB_CJK_CHARS,
    build_synthetic_vocab,
    vocab_to_dict,
)

logger = logging.getLogger("realise_tpu_torch")

TINY_OVERRIDES = dict(hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=64,
                      pho_num_layers=1, out_num_layers=1,
                      max_position_embeddings=64)

# Flags of the JAX CLIs whose parts are not ported yet → (how the parser
# takes them, the ROADMAP queue A item that ports them).
UNPORTED: Dict[str, Tuple[dict, str]] = {
    "--do_eval": (dict(action="store_true"), "4 (eval and scoring)"),
    "--do_predict": (dict(action="store_true"), "4 (eval and scoring)"),
    "--resume": (dict(action="store_true"),
                 "2 (checkpoints with optimizer state)"),
    "--init_ckpt": ({}, "2 (checkpoints with optimizer state)"),
    "--pho_ckpt": ({}, "7 (presets and pretraining stages)"),
    "--res_ckpt": ({}, "7 (presets and pretraining stages)"),
    "--image_model_type": (dict(type=int), "7 (presets and pretraining stages)"),
    "--with_pho": ({}, "7 (presets and pretraining stages)"),
    "--with_res": ({}, "7 (presets and pretraining stages)"),
    "--fusion": ({}, "7 (presets and pretraining stages)"),
    "--mesh": ({}, "6 (multi-GPU data parallel)"),
    "--distributed": (dict(action="store_true"), "6 (multi-GPU data parallel)"),
    "--length_buckets": ({}, "9 (length buckets and step traces in training)"),
    "--trace_dir": ({}, "9 (length buckets and step traces in training)"),
}


def setup_logging(verbose: bool = True) -> None:
    logging.basicConfig(
        level=logging.INFO if verbose else logging.WARNING,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")


def add_common_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--model_type", default="bert-pho2-res-arch3")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--data_dir", default=None)
    p.add_argument("--vocab_path", default=None,
                   help="vocab.txt (defaults to data_dir/vocab.txt; a "
                        "synthetic 21128-token vocab with --synthetic)")
    p.add_argument("--font_paths", default=None,
                   help="comma-separated TTFs (simhei,xiaozhuan); procedural "
                        "glyphs when absent")
    p.add_argument("--max_seq_length", type=int, default=128)
    p.add_argument("--seed", type=int, default=17)
    p.add_argument("--resfonts", default="font3_fanti",
                   choices=["font1", "font2", "font2_fanti", "font3_fanti"])
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run on the CPU)")
    p.add_argument("--no_kernels", action="store_true",
                   help="plain PyTorch sub-blocks instead of the fused kernels")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic vocab + dataset (no corpus assets needed)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model dims for smoke tests")
    for flag, (kw, item) in UNPORTED.items():
        p.add_argument(flag, default=None, **kw,
                       help=f"not ported yet (ROADMAP queue A item {item})")
    return p


def reject_unported(args: argparse.Namespace) -> None:
    """Exit naming the ROADMAP item of every unported flag that was given."""
    given = [(flag, item) for flag, (_, item) in UNPORTED.items()
             if getattr(args, flag[2:]) not in (None, False)]
    if given:
        raise SystemExit("; ".join(
            f"{flag} is not ported to realise_tpu_torch yet (ROADMAP queue A "
            f"item {item})" for flag, item in given))


def resolve_resfonts(args) -> Tuple[int, bool]:
    """(num_fonts, use_traditional_font) of the --resfonts preset."""
    return {"font1": (1, False), "font2": (2, False),
            "font2_fanti": (2, True), "font3_fanti": (3, True)}[args.resfonts]


def build_config(args, vocab_size: int) -> RealiseConfig:
    num_fonts, use_trad = resolve_resfonts(args)
    overrides = dict(vocab_size=vocab_size,
                     max_seq_length=args.max_seq_length,
                     num_fonts=num_fonts, use_traditional_font=use_trad,
                     dtype=args.dtype)
    if args.tiny:
        overrides.update(TINY_OVERRIDES)
        overrides["max_seq_length"] = min(args.max_seq_length, 32)
    return config_for(args.model_type, **overrides)


def build_tokenizer(args) -> WordPieceTokenizer:
    """--vocab_path, else data_dir/vocab.txt, else (--synthetic) the
    synthetic vocab the Corrector builds for ``synthetic_vocab=True``."""
    path = args.vocab_path
    if path is None and args.data_dir:
        cand = os.path.join(args.data_dir, "vocab.txt")
        if os.path.exists(cand):
            path = cand
    if path:
        return WordPieceTokenizer.from_pretrained(path)
    if not args.synthetic:
        raise SystemExit("no vocab.txt found — pass --vocab_path/--data_dir, "
                         "or --synthetic for the built-in synthetic vocabulary")
    return WordPieceTokenizer(vocab_to_dict(build_synthetic_vocab(
        size=RealiseConfig().vocab_size, cjk_chars=REAL_VOCAB_CJK_CHARS)))


def build_glyphs(args, tokenizer, cfg: RealiseConfig) -> np.ndarray:
    from realise_tpu_torch.text.glyphs import build_glyph_table

    font_paths = args.font_paths.split(",") if args.font_paths else None
    vocab = tokenizer.convert_ids_to_tokens(range(len(tokenizer)))
    return build_glyph_table(vocab, num_fonts=cfg.num_fonts,
                             use_traditional_font=cfg.use_traditional_font,
                             font_paths=font_paths, font_size=cfg.glyph_size)


def load_pkl_dataset(path: str) -> List[Dict]:
    """The reference's flat pickle of example dicts, format checked."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    if not isinstance(data, list):
        raise ValueError(f"{path}: expected a list of example dicts")
    for ex in data:
        if not (len(ex["src_idx"]) == len(ex["tgt_idx"]) == ex["lengths"] + 2
                and ex["lengths"] == len(ex["tokens_size"])):
            raise ValueError(f"{path}: malformed example {ex.get('id')!r}")
    return data


def load_dataset(args, tokenizer, filename: Optional[str],
                 num_synthetic: int = 64, seed: int = 0) -> List[Dict]:
    if args.synthetic or not filename:
        return synthetic_dataset(tokenizer, num_examples=num_synthetic,
                                 seed=seed)
    path = filename
    if args.data_dir and not os.path.isabs(path):
        path = os.path.join(args.data_dir, path)
    return load_pkl_dataset(path)


def zero_padding_loss(feed: Dict, n_real: int) -> Dict:
    """Zero ``loss_masks`` on padded duplicate rows (rows ≥ ``n_real``):
    counting them would over-weight one example's gradient."""
    if n_real >= feed["loss_masks"].shape[0]:
        return feed
    feed = dict(feed)
    lm = np.array(feed["loss_masks"], copy=True)
    lm[n_real:] = 0
    feed["loss_masks"] = lm
    return feed
