"""Offline data preparation CLI — the data_process/ equivalent (the port's
own copy of ``realise_tpu.cli.prepare_data``, the same flags; host code
only).

Converts raw SIGHAN/Wang271K corpus files into cleaned TSVs, gold label
files, and the runtime pkl datasets the runners consume (reference:
data_process/trainset.py __main__ :736-761, testset.py :237-254,
dataset.py + process_data.py).

Examples:
    # SIGHAN15 training SGML → TSV + pkl
    python -m realise_tpu_torch.cli.prepare_data --format sighan-train --year 15 \
        --input SIGHAN15_CSC_A2_Training.sgml --vocab_path vocab.txt \
        --output_tsv train.sighan15-1.tsv --output_pkl train.sighan15-1.pkl

    # SIGHAN15 test input + truth → TSV + pkl + label file
    python -m realise_tpu_torch.cli.prepare_data --format sighan-test --year 15 \
        --input SIGHAN15_CSC_TestInput.txt --truth SIGHAN15_CSC_TestTruth.txt \
        --vocab_path vocab.txt --output_pkl test.sighan15.pkl \
        --output_lbl test.sighan15.lbl.tsv

    # merge several TSVs (×N oversampling) into one training pkl
    python -m realise_tpu_torch.cli.prepare_data --format tsv \
        --input a.tsv,b.tsv --repeat 2 --vocab_path vocab.txt \
        --output_pkl trainall.times2.pkl
"""

from __future__ import annotations

import argparse

from realise_tpu_torch.cli.common import logger, save_pkl_dataset, setup_logging
from realise_tpu_torch.data.corpus import (
    parse_sighan13_sample,
    parse_sighan_test,
    parse_sighan_training,
    parse_wang271k,
    read_tsv,
    records_to_examples,
    write_label_file,
    write_tsv,
)
from realise_tpu_torch.data.fixes import train_fixes_for
from realise_tpu_torch.text.tokenizer import WordPieceTokenizer


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--format", required=True,
                   choices=["sighan13-sample", "sighan-train", "sighan-test",
                            "wang271k", "tsv"])
    p.add_argument("--input", required=True,
                   help="input file (comma-separated for --format tsv)")
    p.add_argument("--truth", default=None, help="truth file (sighan-test)")
    p.add_argument("--year", type=int, default=15)
    p.add_argument("--vocab_path", default=None)
    p.add_argument("--max_len", type=int, default=None,
                   help="drop examples longer than this many wordpieces")
    p.add_argument("--repeat", type=int, default=1,
                   help="oversample factor (trainall.timesN, train.sh:11)")
    p.add_argument("--output_tsv", default=None)
    p.add_argument("--output_pkl", default=None)
    p.add_argument("--output_lbl", default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup_logging()

    if args.format == "tsv":
        records = []
        for path in args.input.split(","):
            records.extend(read_tsv(path))
    else:
        with open(args.input, "rb") as f:
            text = f.read().decode(errors="replace")
        if args.format == "sighan13-sample":
            records = parse_sighan13_sample(
                text, text_fixes=train_fixes_for(args.input, 13))
        elif args.format == "sighan-train":
            records = parse_sighan_training(
                text, year=args.year,
                text_fixes=train_fixes_for(args.input, args.year))
        elif args.format == "wang271k":
            records = parse_wang271k(text)
        else:  # sighan-test
            if not args.truth:
                raise SystemExit("--format sighan-test requires --truth")
            with open(args.truth, "rb") as f:
                truth = f.read().decode(errors="replace")
            records = parse_sighan_test(text, truth, year=args.year)

    n_err = sum(1 for r in records if r["errors"])
    logger.info("%d records (%d with errors, %.1f avg len)", len(records),
                n_err, sum(len(r["src"]) for r in records) / max(len(records), 1))

    if args.output_tsv:
        write_tsv(records, args.output_tsv)
        logger.info("wrote %s", args.output_tsv)
    if args.output_lbl:
        write_label_file(records, args.output_lbl)
        logger.info("wrote %s", args.output_lbl)
    if args.output_pkl:
        if not args.vocab_path:
            raise SystemExit("--output_pkl requires --vocab_path")
        tokenizer = WordPieceTokenizer.from_pretrained(args.vocab_path)
        # Tokenize once, then repeat: `records * N` would re-run the full
        # WordPiece pass N times over identical text (the trainall.timesN
        # flow doubles ~271k Wang271K records). Downstream reads examples
        # immutably, so aliased repeats are fine.
        examples = records_to_examples(records, tokenizer,
                                       max_len=args.max_len) * args.repeat
        save_pkl_dataset(examples, args.output_pkl)
        logger.info("wrote %d examples to %s", len(examples), args.output_pkl)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
