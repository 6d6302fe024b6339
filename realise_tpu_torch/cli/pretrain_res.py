"""Glyph-encoder pretraining CLI of the port: ``realise_tpu.cli.pretrain_res``
(the pretrain_res.sh equivalent) on one device.

Objective (reference: src/run_res_pretrain.py, pretrain_res.sh:3-13): the
dataset is every single-Chinese-char entry of the vocabulary
(run_res_pretrain.py:45-54), and the CharResNet classifies each char from
its glyph image stack (src/models.py:1473-1488). The flags and their
defaults are the JAX CLI's: batch 512 (at most the number of chars), lr
1e-3, no warmup, 8 epochs of ``chars // batch`` steps unless
``--max_steps``. The run saves a port checkpoint (every ``--save_steps`` if
set, and at the end) and writes the classification accuracy over every
char to ``dev_results.json``. Runs on CUDA unless told otherwise. Under
torchrun ``--mesh data=N`` trains data parallel over N ranks, one card
each: the batch scales by N, at most the number of chars and a multiple of
N (the JAX CLI's pretrain_res.py:66-79), and each rank takes its
contiguous slice of it; rank 0 writes the checkpoints and
``dev_results.json``. Nothing of the stage is split by tensor parallelism
(it has no encoder), so under ``--mesh data=D,model=M`` the M ranks of a
data index train copies and the run is the ``data=D`` one.

Example (smoke):
    python -m realise_tpu_torch.cli.pretrain_res --synthetic --tiny \
        --num_train_epochs 1 --device cpu --output_dir /tmp/res
    torchrun --nproc_per_node 2 -m realise_tpu_torch.cli.pretrain_res \
        --synthetic --mesh data=2 --output_dir /tmp/res
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from realise_tpu_torch.cli.common import (
    add_common_args,
    build_config,
    build_glyphs,
    build_mesh,
    build_tokenizer,
    logger,
    setup_logging,
    write_json,
)
from realise_tpu_torch.parallel.distributed import is_main_process, local_slice


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--per_device_train_batch_size", type=int, default=512)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--num_train_epochs", type=float, default=8)
    p.add_argument("--max_steps", type=int, default=-1)
    p.add_argument("--logging_steps", type=int, default=50)
    p.add_argument("--save_steps", type=int, default=0)
    return p


def char_accuracy(trainer, char_ids: np.ndarray, batch_size: int) -> float:
    """Classification accuracy over every char (run_res_pretrain.py:229-235):
    the last batch is padded to ``batch_size`` with its last char and only
    its real rows are scored (the JAX CLI's rule, pretrain_res.py:106-121).
    In a process group each rank forwards its slice of every batch and
    scores the gathered predictions."""
    correct = 0
    for i in range(0, len(char_ids), batch_size):
        chunk = char_ids[i:i + batch_size]
        n = len(chunk)
        if n < batch_size:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:],
                                                     batch_size - n)])
        preds = trainer.eval_step({"char_idx": np.asarray(local_slice(
            chunk, trainer.data_index, trainer.data_size))})["pred_idx"]
        correct += int((preds[:n] == chunk[:n]).sum())
    return correct / max(len(char_ids), 1)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.model_type = "res-pretrain"
    setup_logging()
    tokenizer = build_tokenizer(args)
    cfg = build_config(args, len(tokenizer))
    mesh = build_mesh(args, cfg)  # forms the process group before the card
    from realise_tpu_torch.data.features import Featurizer
    from realise_tpu_torch.device import resolve_device
    from realise_tpu_torch.models.realise import RealisePretrain
    from realise_tpu_torch.training.checkpoint import save_checkpoint
    from realise_tpu_torch.training.trainer import Trainer

    device = resolve_device(args.device)  # raises without CUDA by default
    featurizer = Featurizer(tokenizer, cfg)
    model = RealisePretrain(cfg,
                            generator=torch.Generator().manual_seed(args.seed))
    model.install_glyphs(build_glyphs(args, tokenizer, cfg))

    char_ids = np.nonzero(featurizer.cjk_token_mask())[0].astype(np.int64)
    logger.info("res-pretrain over %d chars", len(char_ids))
    batch_size = min(args.per_device_train_batch_size, len(char_ids))
    data = mesh.data if mesh else 1
    if data > 1:
        batch_size = min(batch_size * data, len(char_ids))
        batch_size -= batch_size % data
    if batch_size <= 0:
        raise SystemExit(f"res-pretrain needs at least one CJK vocab char "
                         f"per data rank (have {len(char_ids)} chars, data "
                         f"axis {data}); check the vocab file")
    steps_per_epoch = max(len(char_ids) // batch_size, 1)
    total = (args.max_steps if args.max_steps > 0
             else int(steps_per_epoch * args.num_train_epochs))
    trainer = Trainer(cfg, model, learning_rate=args.learning_rate,
                      warmup_steps=0, total_steps=max(total, 1),
                      use_kernels=False if args.no_kernels else None,
                      seed=args.seed, device=device, mesh=mesh)

    rng = np.random.default_rng(args.seed)

    def batches():
        while True:
            order = rng.permutation(len(char_ids))
            for i in range(0, len(order) - batch_size + 1, batch_size):
                yield {"char_idx": np.asarray(local_slice(
                    char_ids[order[i:i + batch_size]], trainer.data_index,
                    trainer.data_size))}

    training_args = dict(vars(args))

    def save_fn(step, tr):
        path = save_checkpoint(args.output_dir, step, tr.model_state_dict(),
                               cfg, trainer_state=tr.state_dict(),
                               training_args=training_args)
        if is_main_process():
            logger.info("saved checkpoint %s", path)

    summary = trainer.fit(batches(), max_steps=total,
                          logging_steps=args.logging_steps,
                          save_steps=args.save_steps,
                          save_fn=save_fn if args.save_steps else None)
    logger.info("train summary: %s", summary)
    save_fn(trainer.step, trainer)

    acc = char_accuracy(trainer, char_ids, batch_size)
    logger.info("res-pretrain accuracy: %.4f", acc)
    if is_main_process():
        write_json(os.path.join(args.output_dir, "dev_results.json"),
                   {"accuracy": acc})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
