"""Shared CLI plumbing of the port: arguments, tokenizer, config, glyphs,
mesh, data and evaluation (the port's own copy of ``realise_tpu.cli.common``).

Flag names and meanings follow the JAX package's CLIs (which follow the
reference's src/run.py:282-391). ``--mesh`` takes the JAX syntax
(``data=D,model=M``); where the JAX package spreads a mesh over the devices
of one process, the port runs one process per card under torchrun, so
``--mesh data=D,model=M`` needs a process group of D·M ranks
(:func:`build_mesh`).
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
    p.add_argument("--image_model_type", type=int, default=0,
                   help="1: the CharResNet1 glyph encoder (res_encoder "
                        "resnet1)")
    # The ablation switches (src/models_abla.py via run.py:374-376).
    p.add_argument("--with_pho", default="yes", choices=["yes", "no"])
    p.add_argument("--with_res", default="yes", choices=["yes", "no"])
    p.add_argument("--fusion", default=None, choices=[None, "gate", "sum"])
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
    add_mesh_arg(p)
    return p


def add_mesh_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--mesh", default=None,
                   help="e.g. 'data=4': data parallelism over 4 ranks, one "
                        "card each (launch with torchrun --nproc_per_node "
                        "4); 'data=2,model=2': each replica split over 2 "
                        "ranks by tensor parallelism, 4 ranks; default one "
                        "process")


def build_mesh(args, cfg: Optional[RealiseConfig] = None):
    """The run's mesh, or None without ``--mesh`` and ``--distributed``.

    ``--mesh`` is parsed as the JAX package parses it
    (``realise_tpu/cli/common.py:200-214``) and checked: a mesh the
    process group cannot hold (another world size than torchrun's
    ``WORLD_SIZE``, 1 without it), or whose ``model`` axis does not divide
    ``cfg``'s heads and intermediate size, exits with the reason. Then,
    under torchrun's environment or with ``--distributed``, the process
    group forms (NCCL, gloo with ``--device cpu``;
    ``parallel.distributed.initialize``), before anything touches the
    card. ``--distributed`` without ``--mesh`` means
    ``data=WORLD_SIZE``."""
    from realise_tpu_torch.parallel.distributed import (
        initialize,
        launched_by_torchrun,
    )
    from realise_tpu_torch.parallel.mesh import make_mesh

    distributed = getattr(args, "distributed", False)
    if not args.mesh and not distributed:
        return None
    axes = {}
    for part in args.mesh.split(",") if args.mesh else ():
        name, eq, n = part.partition("=")
        name = name.strip()
        if not eq or not name or not n.strip().isdigit():
            raise SystemExit(
                f"--mesh: bad axis {part!r}: expected name=count pairs like "
                f"'data=8' or 'data=4,model=1'")
        axes[name] = int(n)
    group = distributed or launched_by_torchrun()
    world = int(os.environ.get("WORLD_SIZE", "1")) if group else 1
    try:
        mesh = make_mesh(axes or None, world_size=world, cfg=cfg)
    except ValueError as e:
        raise SystemExit(f"--mesh: {e}")
    if group:
        initialize(device=args.device)
    logger.info("mesh %s", mesh)
    return mesh


def resolve_resfonts(args) -> Tuple[int, bool]:
    """(num_fonts, use_traditional_font) of the --resfonts preset."""
    return {"font1": (1, False), "font2": (2, False),
            "font2_fanti": (2, True), "font3_fanti": (3, True)}[args.resfonts]


def build_config(args, vocab_size: int) -> RealiseConfig:
    """The preset of ``--model_type`` with the flags' overrides, as the JAX
    package's ``build_config`` sets them (cli/common.py:123-145): the
    ``--resfonts`` fonts (over a merged preset's one font too),
    ``--image_model_type 1`` → resnet1, ``--with_pho no`` / ``--with_res no``
    → no such stream, ``--fusion``."""
    num_fonts, use_trad = resolve_resfonts(args)
    overrides = dict(vocab_size=vocab_size,
                     max_seq_length=args.max_seq_length,
                     num_fonts=num_fonts, use_traditional_font=use_trad,
                     dtype=args.dtype)
    if args.image_model_type == 1:
        overrides["res_encoder"] = "resnet1"
    if args.with_pho == "no":
        overrides["pho_encoder"] = "none"
    if args.with_res == "no":
        overrides["res_encoder"] = "none"
    if args.fusion:
        overrides["fusion"] = args.fusion
    if args.tiny:
        overrides.update(TINY_OVERRIDES)
        overrides["max_seq_length"] = min(args.max_seq_length, 32)
    return config_for(args.model_type, **overrides)


def resolve_vocab_path(vocab_path: Optional[str],
                       data_dir: Optional[str]) -> Optional[str]:
    """--vocab_path, else data_dir/vocab.txt when it exists (the tokenizer
    builder's and cli/correct's rule, as in the JAX package)."""
    if vocab_path is None and data_dir:
        cand = os.path.join(data_dir, "vocab.txt")
        if os.path.exists(cand):
            return cand
    return vocab_path


def build_tokenizer(args) -> WordPieceTokenizer:
    """--vocab_path, else data_dir/vocab.txt, else (--synthetic) the
    synthetic vocab the Corrector builds for ``synthetic_vocab=True``."""
    path = resolve_vocab_path(args.vocab_path, args.data_dir)
    if path:
        return WordPieceTokenizer.from_pretrained(path)
    if not args.synthetic:
        raise SystemExit("no vocab.txt found — pass --vocab_path/--data_dir, "
                         "or --synthetic for the built-in synthetic vocabulary")
    return WordPieceTokenizer(vocab_to_dict(build_synthetic_vocab(
        size=RealiseConfig().vocab_size, cjk_chars=REAL_VOCAB_CJK_CHARS)))


def build_glyphs(args, tokenizer, cfg: RealiseConfig) -> Optional[np.ndarray]:
    """The glyph table of the config's fonts; None without a glyph stream."""
    if not cfg.with_res:
        return None
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


def save_pkl_dataset(data: List[Dict], path: str) -> None:
    """Write examples in the format :func:`load_pkl_dataset` reads."""
    with open(path, "wb") as f:
        pickle.dump(data, f)


def load_dataset(args, tokenizer, filename: Optional[str],
                 num_synthetic: int = 64, seed: int = 0) -> List[Dict]:
    if args.synthetic or not filename:
        return synthetic_dataset(tokenizer, num_examples=num_synthetic,
                                 seed=seed)
    path = filename
    if args.data_dir and not os.path.isabs(path):
        path = os.path.join(args.data_dir, path)
    return load_pkl_dataset(path)


def zero_padding_loss(feed: Dict, n_real: int, row0: int = 0) -> Dict:
    """Zero ``loss_masks`` on padded duplicate rows (global rows ≥
    ``n_real``; ``row0`` is this rank's first global row): counting them
    would over-weight one example's gradient."""
    rows = feed["loss_masks"].shape[0]
    if n_real >= row0 + rows:
        return feed
    feed = dict(feed)
    lm = np.array(feed["loss_masks"], copy=True)
    lm[max(0, min(n_real - row0, rows)):] = 0
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
    current weights first (``Trainer.prepare_eval_tables``).

    In a process group (the JAX function's multi-process branch,
    realise_tpu/cli/common.py:248-311) each rank featurizes its data
    index's ``local_slice`` of every batch for the device and the whole
    batch for the metric; ``Trainer.eval_step`` gathers every data rank's
    predictions, so every rank computes the same metrics. Rank ``p`` > 0
    writes its files with a ``.p{p}`` suffix, so no two ranks write one
    file."""
    from realise_tpu_torch.parallel.distributed import (
        is_main_process,
        local_slice,
        process_index,
    )

    suffix = "" if is_main_process() else f".p{process_index()}"
    work = os.path.join(out_dir, prefix)
    os.makedirs(work, exist_ok=True)
    provided = label_path is not None
    if not provided:
        label_path = os.path.join(work, f"gold.lbl.tsv{suffix}")
        with open(label_path, "w", encoding="utf-8") as f:
            f.write("\n".join(dataset_labels(dataset)))
    if should_remove_de:
        filtered = os.path.join(work, f"gold.remove_de.lbl.tsv{suffix}")
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
        padded = pad_examples(examples, batch_size)
        host = featurizer.featurize(padded)
        feed, row0 = host, 0
        if trainer.data_size > 1:
            feed = featurizer.featurize(local_slice(
                padded, trainer.data_index, trainer.data_size))
            row0 = trainer.data_index * feed["loss_masks"].shape[0]
        out = trainer.eval_step(featurizer.device_batch(
            zero_padding_loss(feed, n, row0)))
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
        batches, pred_txt_path=os.path.join(work, f"preds.txt{suffix}"),
        pred_lbl_path=os.path.join(work, f"labels.txt{suffix}"),
        label_path=label_path,
        should_remove_de=should_remove_de)
    if losses and sum(weights) > 0:
        results["avg_loss"] = float(np.average(losses, weights=weights))
    return results


def write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
