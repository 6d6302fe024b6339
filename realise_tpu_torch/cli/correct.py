"""Batch / interactive spelling-correction CLI over the port.

Reads Chinese sentences (stdin or --input, one per line), runs the model
with the precomputed-table fast path, prints corrected sentences. Runs on
CUDA with the fused block kernels unless told otherwise.

Example:
    echo "我爱北经。" | python -m realise_tpu_torch.cli.correct --ckpt_dir ckpts
    python -m realise_tpu_torch.cli.correct --ckpt_dir /tmp/out --synthetic \
        --input sents.txt --show_edits
    python -m realise_tpu_torch.cli.correct --ckpt_dir /tmp/out --synthetic \
        --device cpu
"""

from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt_dir", required=True)
    p.add_argument("--vocab_path", default=None)
    p.add_argument("--input", default=None, help="file of sentences (default stdin)")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--show_edits", action="store_true",
                   help="append detected (pos, wrong→correct) edits")
    p.add_argument("--no_fast_path", action="store_true",
                   help="skip the table precompute (per-token GRU and conv)")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic vocab of the checkpoint's size")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run on the CPU)")
    p.add_argument("--no_kernels", action="store_true",
                   help="plain PyTorch sub-blocks instead of the fused kernels")
    return p


def _line(r) -> str:
    edits = [f"{e['pos']}:{e['wrong']}→{e['correct']}" for e in r["edits"]]
    return f"{r['corrected']}\t{' '.join(edits) if edits else '-'}"


def main(argv=None):
    args = build_parser().parse_args(argv)
    from realise_tpu_torch.serving import Corrector

    corrector = Corrector(
        args.ckpt_dir, vocab_path=args.vocab_path, batch_size=args.batch_size,
        use_kernels=False if args.no_kernels else None,
        fast_path=not args.no_fast_path, synthetic_vocab=args.synthetic,
        device=args.device)

    if args.input is None and sys.stdin.isatty():
        # Interactive: correct per line as typed.
        corrector.warmup()
        print("enter sentences (Ctrl-D to finish):", file=sys.stderr)
        for ln in sys.stdin:
            s = ln.strip()
            if not s:
                continue
            if args.show_edits:
                print(_line(corrector.correct_with_edits([s])[0]),
                      flush=True)
            else:
                print(corrector.correct([s])[0], flush=True)
        return 0

    if args.input:
        with open(args.input, encoding="utf-8") as f:
            sentences = [ln.strip() for ln in f if ln.strip()]
    else:
        sentences = [ln.strip() for ln in sys.stdin if ln.strip()]
    if args.show_edits:
        for r in corrector.correct_with_edits(sentences):
            print(_line(r))
    else:
        for corrected in corrector.correct(sentences):
            print(corrected)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
