"""Evaluation CLI of the port — the test.sh / src/test.py equivalent
(``realise_tpu.cli.test`` over the port's checkpoints).

Loads a port checkpoint (``saved_ckpt-{step}/`` with ``config.json`` and
``model.pt``; the glyphs come from it), installs the pinyin tables of the
featurizer, forwards the test set with the (V, H) stream tables and the
fused block kernels, and scores it with the SIGHAN metric (remove_de for
year 13, src/test.py:152-159). Runs on CUDA unless told otherwise. A JAX
checkpoint is converted first (README, "PyTorch/CUDA port"). Under torchrun
``--mesh data=N`` scores data parallel over N ranks, one card each: every
rank forwards its slice of each batch and computes the same metrics from
the gathered predictions; rank 0 writes ``test_results.json``.
``--mesh data=D,model=M`` splits each replica's encoder layers over M ranks
(tensor parallelism, the plain sub-blocks), D·M ranks in all.

Example:
    python -m realise_tpu_torch.cli.test --ckpt_dir /tmp/out --synthetic \
        --device cpu
    python -m realise_tpu_torch.cli.test --ckpt_dir ckpts --data_dir data \
        --testset_year 13 --ckpt_num -1
    torchrun --nproc_per_node 2 -m realise_tpu_torch.cli.test \
        --ckpt_dir ckpts --data_dir data --mesh data=2
    torchrun --nproc_per_node 4 -m realise_tpu_torch.cli.test \
        --ckpt_dir ckpts --data_dir data --mesh data=2,model=2
"""

from __future__ import annotations

import argparse
import os

import torch

from realise_tpu_torch.cli.common import (
    add_mesh_arg,
    build_mesh,
    build_tokenizer,
    evaluate_model,
    load_dataset,
    logger,
    setup_logging,
    write_json,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt_dir", required=True)
    p.add_argument("--ckpt_num", type=int, default=-1,
                   help="checkpoint step to load; -1 = latest (src/test.py:85-90)")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--vocab_path", default=None)
    p.add_argument("--testset_year", type=int, default=15,
                   help="13/14/15: selects test.sighanNN.pkl and applies "
                        "remove_de for 13 (src/test.py:152-159)")
    p.add_argument("--test_file", default=None)
    p.add_argument("--label_file", default=None)
    p.add_argument("--eval_batch_size", type=int, default=32)
    p.add_argument("--output_dir", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic vocab of the checkpoint's size + dataset")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run on the CPU)")
    p.add_argument("--no_kernels", action="store_true",
                   help="plain PyTorch sub-blocks instead of the fused kernels")
    add_mesh_arg(p)
    return p


def select_checkpoint(ckpt_dir: str, ckpt_num: int):
    """(step, path): ``saved_ckpt-{ckpt_num}`` (the latest for -1) under
    ``ckpt_dir``, or ``ckpt_dir`` itself when it is a checkpoint."""
    from realise_tpu_torch.training.checkpoint import MODEL_FILE, list_checkpoints

    ckpts = list_checkpoints(ckpt_dir)
    if ckpts:
        if ckpt_num == -1:
            return ckpts[-1]
        matches = [c for c in ckpts if c[0] == ckpt_num]
        if not matches:
            raise SystemExit(f"no saved_ckpt-{ckpt_num} under {ckpt_dir}; "
                             f"available: {[s for s, _ in ckpts]}")
        return matches[0]
    if not os.path.exists(os.path.join(ckpt_dir, MODEL_FILE)):
        raise SystemExit(f"no checkpoints found under {ckpt_dir}")
    if ckpt_num != -1:
        raise SystemExit(f"--ckpt_num {ckpt_num} given, but {ckpt_dir} is "
                         f"itself a checkpoint (no saved_ckpt-* children)")
    return -1, ckpt_dir


def checkpoint_config(args):
    """The config of the checkpoint ``--ckpt_dir``/``--ckpt_num`` select,
    None when there is none yet (:func:`select_checkpoint` then says why)."""
    from realise_tpu_torch.training.checkpoint import load_config

    try:
        return load_config(select_checkpoint(args.ckpt_dir, args.ckpt_num)[1])
    except (SystemExit, OSError):
        return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging()
    # Forms the process group before the card.
    mesh = build_mesh(args, checkpoint_config(args))
    from realise_tpu_torch.data.features import Featurizer
    from realise_tpu_torch.device import resolve_device
    from realise_tpu_torch.models.realise import Realise
    from realise_tpu_torch.parallel.distributed import is_main_process
    from realise_tpu_torch.training.checkpoint import load_checkpoint, load_config
    from realise_tpu_torch.training.trainer import Trainer

    device = resolve_device(args.device)  # raises without CUDA by default
    step, ckpt_path = select_checkpoint(args.ckpt_dir, args.ckpt_num)
    cfg = load_config(ckpt_path)
    logger.info("loaded config: model_type=%s step=%s", cfg.model_type, step)
    tokenizer = build_tokenizer(args)
    if len(tokenizer) != cfg.vocab_size:
        raise SystemExit(f"tokenizer vocab ({len(tokenizer)}) != model vocab "
                         f"({cfg.vocab_size}): pass the matching --vocab_path")
    featurizer = Featurizer(tokenizer, cfg)
    with torch.device("meta"):
        model = Realise(cfg)
    model.load_state_dict(load_checkpoint(ckpt_path), assign=True)
    model.install_pho_vocab_tables(*featurizer.pho2_tables())
    trainer = Trainer(cfg, model, use_kernels=False if args.no_kernels else None,
                      device=device, mesh=mesh)

    test_file = args.test_file or f"test.sighan{args.testset_year}.pkl"
    label_file = args.label_file or f"test.sighan{args.testset_year}.lbl.tsv"
    data = load_dataset(args, tokenizer, test_file, num_synthetic=64, seed=99)
    label = (os.path.join(args.data_dir, label_file)
             if args.data_dir and not args.synthetic else None)
    if label and not os.path.exists(label):
        logger.warning("label file %s not found: deriving gold labels from "
                       "the dataset's src/tgt instead", label)
        label = None
    out_dir = args.output_dir or os.path.join(args.ckpt_dir, "test_output")
    res = evaluate_model(trainer, data, featurizer, tokenizer, out_dir,
                         prefix=f"sighan{args.testset_year}",
                         batch_size=args.eval_batch_size, label_path=label,
                         should_remove_de=(args.testset_year == 13))
    for k in sorted(res):
        print(f"{k}: {res[k]:.4f}")
    if is_main_process():
        write_json(os.path.join(out_dir, "test_results.json"), res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
