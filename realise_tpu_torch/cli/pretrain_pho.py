"""Phonetic-encoder pretraining CLI of the port: ``realise_tpu.cli.pretrain_pho``
(the pretrain_pho.sh equivalent) on one device.

Objective (reference: src/run_pretrain.py, pretrain_pho.sh:3-16): recover
each character's identity from its pinyin alone. The inputs are the target
ids; the pho2 GRU and the 4-layer pho BERT encode their pinyin and an MLM
head predicts the char; the loss covers the Chinese-char positions
(``Featurizer.featurize_pho_pretrain``). The flags and their defaults are
the JAX CLI's: a loader batch of 64, 2 accumulation steps (an update takes
128 examples), lr 5e-5. The run saves a port checkpoint every
``--save_steps`` and at the end, then writes the dev set's token accuracy
to ``dev_results.json`` (run_pretrain.py:242-251). Runs on CUDA with the
fused kernels unless told otherwise. Under torchrun ``--mesh data=N``
trains data parallel over N ranks, one card each, as ``cli/train
--distributed`` does: the update batch scales by N (the JAX CLI's
pretrain_pho.py:97-103) and each rank takes its contiguous slice of it;
rank 0 writes the checkpoints and ``dev_results.json``. ``--mesh
data=D,model=M`` splits the pho BERT's layers over M ranks of each data
index (tensor parallelism; ``cli/train``'s rules).

Example (smoke, no corpus assets):
    python -m realise_tpu_torch.cli.pretrain_pho --synthetic --tiny \
        --max_steps 4 --device cpu --output_dir /tmp/pho
    torchrun --nproc_per_node 2 -m realise_tpu_torch.cli.pretrain_pho \
        --synthetic --mesh data=2 --max_steps 100 --output_dir /tmp/pho
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from realise_tpu_torch.cli.common import (
    add_common_args,
    build_config,
    build_mesh,
    build_tokenizer,
    load_dataset,
    logger,
    setup_logging,
    write_json,
    zero_padding_loss,
)
from realise_tpu_torch.data.dataset import batch_iterator, pad_examples
from realise_tpu_torch.parallel.distributed import is_main_process, local_slice


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--train_file", default="trainall.times2.pkl")
    p.add_argument("--dev_file", default="dev.pkl")
    p.add_argument("--per_device_train_batch_size", type=int, default=64)
    p.add_argument("--gradient_accumulation_steps", type=int, default=2)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--max_steps", type=int, default=30000)
    p.add_argument("--warmup_steps", type=int, default=5000)
    p.add_argument("--logging_steps", type=int, default=100)
    p.add_argument("--save_steps", type=int, default=1000)
    return p


def token_accuracy(trainer, data, featurizer, batch_size: int = 64):
    """Chinese-char token accuracy and the mean loss over the dev set
    (run_pretrain.py:242-251; ``token_accuracy`` of the JAX CLI). The last
    batch is padded to ``batch_size`` for the device and only its real rows
    are scored: padded duplicates count neither in the accuracy nor in the
    loss (their loss positions are zeroed). In a process group each rank
    forwards its slice of every batch and scores the gathered predictions,
    so every rank computes the same accuracy."""
    correct = total = 0
    losses, weights = [], []
    for examples in batch_iterator(data, batch_size, pad_final=False):
        n = len(examples)
        padded = pad_examples(examples, batch_size)
        host = featurizer.featurize_pho_pretrain(padded)
        rows = local_slice(padded, trainer.data_index, trainer.data_size)
        feed = (host if len(rows) == len(padded)
                else featurizer.featurize_pho_pretrain(rows))
        out = trainer.eval_step(featurizer.device_batch(
            zero_padding_loss(feed, n, trainer.data_index * len(rows))))
        mask = host["loss_masks"][:n].astype(bool)
        correct += int((out["pred_idx"][:n][mask]
                        == host["tgt_idx"][:n][mask]).sum())
        total += int(mask.sum())
        if "loss" in out:
            losses.append(out["loss"])
            weights.append(int(mask.sum()))
    return {"accuracy": correct / max(total, 1),
            "avg_loss": (float(np.average(losses, weights=weights))
                         if losses and sum(weights) else float("nan"))}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.model_type = "pho2-pretrain"
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
    model.install_pho_vocab_tables(*featurizer.pho2_tables())
    # The loader batch is the MICRO batch (pretrain_pho.sh: 64 × 2 → an
    # update of 128 examples), on each of the mesh's data ranks.
    batch_size = (args.per_device_train_batch_size
                  * (mesh.data if mesh else 1)
                  * args.gradient_accumulation_steps)
    trainer = Trainer(
        cfg, model, learning_rate=args.learning_rate,
        warmup_steps=args.warmup_steps, total_steps=max(args.max_steps, 1),
        grad_accum_steps=args.gradient_accumulation_steps,
        use_kernels=False if args.no_kernels else None, seed=args.seed,
        device=device, mesh=mesh)

    train_data = load_dataset(args, tokenizer, args.train_file,
                              num_synthetic=256, seed=args.seed)

    def batches():
        epoch = 0
        while True:
            for examples in batch_iterator(train_data, batch_size,
                                           shuffle=True,
                                           seed=args.seed + epoch,
                                           pad_final=False):
                rows = local_slice(pad_examples(examples, batch_size),
                                   trainer.data_index, trainer.data_size)
                feed = featurizer.featurize_pho_pretrain(rows)
                yield featurizer.device_batch(zero_padding_loss(
                    feed, len(examples), trainer.data_index * len(rows)))
            epoch += 1

    training_args = dict(vars(args))

    def save_fn(step, tr):
        path = save_checkpoint(args.output_dir, step, tr.model_state_dict(),
                               cfg, trainer_state=tr.state_dict(),
                               training_args=training_args)
        if is_main_process():
            logger.info("saved checkpoint %s", path)

    logger.info("pho-pretrain: %d examples, update batch %d, %d steps, %s, "
                "kernels %s", len(train_data), batch_size, args.max_steps,
                device, trainer.use_kernels)
    summary = trainer.fit(batches(), max_steps=args.max_steps,
                          logging_steps=args.logging_steps,
                          save_steps=args.save_steps, save_fn=save_fn)
    logger.info("train summary: %s", summary)
    save_fn(trainer.step, trainer)

    dev = load_dataset(args, tokenizer, args.dev_file, num_synthetic=64,
                       seed=args.seed + 1)
    res = token_accuracy(trainer, dev, featurizer)
    logger.info("pho-pretrain dev: %s", res)
    if is_main_process():
        write_json(os.path.join(args.output_dir, "dev_results.json"), res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
