"""Shared CLI plumbing of the port: arguments, tokenizer, config, glyphs,
data and evaluation (the port's own copy of ``realise_tpu.cli.common``
without its multi-host branches).

Flag names and meanings follow the JAX package's CLIs (which follow the
reference's src/run.py:282-391). Flags of parts the port does not have yet
are still accepted, and exit with the ROADMAP item that will bring them
rather than being ignored.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from realise_tpu_torch.config import RealiseConfig, config_for
from realise_tpu_torch.data.dataset import (
    batch_iterator,
    dataset_labels,
    pad_examples,
    synthetic_dataset,
)
from realise_tpu_torch.eval.metric import Metric
from realise_tpu_torch.eval.remove_de import remove_de
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
    "--remove_unused_ckpts": (dict(action="store_true"),
                              "2 (checkpoints with optimizer state)"),
    "--num_save_ckpts": (dict(type=int), "2 (checkpoints with optimizer state)"),
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


def evaluate_model(trainer, dataset: List[Dict], featurizer, tokenizer,
                   out_dir: str, prefix: str = "", batch_size: int = 32,
                   label_path: Optional[str] = None,
                   should_remove_de: bool = False,
                   use_fast_path: bool = True) -> Dict[str, float]:
    """Forward the dataset, decode the argmax predictions and score them
    with the SIGHAN metric (``evaluate_model`` of the JAX package, the
    evaluate() path of run.py:239-280). Writes ``preds.txt``,
    ``labels.txt`` and, without ``label_path``, ``gold.lbl.tsv`` from the
    dataset's src/tgt under ``out_dir/prefix``.

    ``should_remove_de`` (SIGHAN13) drops 地/得 edits from the predictions
    and from the gold labels alike, a provided label file through a
    filtered copy; the reference scores a provided file unfiltered
    (ADVICE.md:4), so how many edits the filter dropped from it is logged.
    ``use_fast_path`` builds the (V, H) stream tables of the trainer's
    current weights first (``Trainer.prepare_eval_tables``)."""
    work = os.path.join(out_dir, prefix)
    os.makedirs(work, exist_ok=True)
    provided = label_path is not None
    if not provided:
        label_path = os.path.join(work, "gold.lbl.tsv")
        with open(label_path, "w", encoding="utf-8") as f:
            f.write("\n".join(dataset_labels(dataset)))
    if should_remove_de:
        filtered = os.path.join(work, "gold.remove_de.lbl.tsv")
        removed = remove_de(input_path=label_path, output_path=filtered)
        if provided:
            logger.info("remove_de dropped %d 地/得 edits from the label file "
                        "%s (scored as %s)", removed, label_path, filtered)
        label_path = filtered
    if use_fast_path:
        trainer.prepare_eval_tables(featurizer)

    batches, losses, weights = [], [], []
    # Unpadded iteration, so each batch knows its real example count; the
    # device step takes the batch padded to batch_size and every field is
    # sliced back to the real examples.
    for examples in batch_iterator(dataset, batch_size, pad_final=False):
        n = len(examples)
        host = featurizer.featurize(pad_examples(examples, batch_size))
        out = trainer.eval_step(featurizer.device_batch(
            zero_padding_loss(host, n)))
        host["pred_idx"] = out["pred_idx"][:n]
        for k in ("src_idx", "masks", "loss_masks", "id", "src", "tgt",
                  "tokens_size", "lengths"):
            host[k] = host[k][:n]
        if "loss" in out:
            # The batch's mean over its real loss tokens, weighted by their
            # count for the dataset mean.
            losses.append(out["loss"])
            weights.append(int(np.asarray(host["loss_masks"]).sum()))
        batches.append(host)

    results = Metric(tokenizer).metric(
        batches, pred_txt_path=os.path.join(work, "preds.txt"),
        pred_lbl_path=os.path.join(work, "labels.txt"), label_path=label_path,
        should_remove_de=should_remove_de)
    if losses and sum(weights) > 0:
        results["avg_loss"] = float(np.average(losses, weights=weights))
    return results


def write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
