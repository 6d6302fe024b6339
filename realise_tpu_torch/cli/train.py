"""Fine-tune CLI of the port: ``realise_tpu.cli.train`` (the train.sh /
src/run.py equivalent) on one device.

Builds the model with its glyph table and the featurizer's pinyin tables
(the factorized streams read both), trains with AdamW, warmup and the
global-norm clip, saves a port checkpoint every ``--save_steps`` and at the
end (``saved_ckpt-{step}/``, served by ``realise_tpu_torch.serving.Corrector``
and ``cli/correct``, scored by ``cli/test``). ``--do_eval`` scores every
saved checkpoint on the dev set (``dev_results.json``); ``--do_predict``
scores the test set with the best of them by ``--order_metric`` (without
``--do_eval``, the latest). Runs on CUDA with the fused kernels unless told
otherwise.

Example (smoke, no corpus assets):
    python -m realise_tpu_torch.cli.train --synthetic --tiny --max_steps 2 \
        --do_train --do_eval --do_predict --device cpu --output_dir /tmp/out
"""

from __future__ import annotations

import argparse
import os

import torch

from realise_tpu_torch.cli.common import (
    add_common_args,
    build_config,
    build_glyphs,
    build_tokenizer,
    evaluate_model,
    load_dataset,
    logger,
    reject_unported,
    setup_logging,
    write_json,
    zero_padding_loss,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--train_file", default="trainall.times2.pkl")
    p.add_argument("--dev_file", default="dev.pkl")
    p.add_argument("--dev_label_file", default=None)
    p.add_argument("--predict_file", default="test.sighan15.pkl")
    p.add_argument("--predict_label_file", default=None)
    p.add_argument("--do_train", action="store_true",
                   help="train (the default when no mode is given)")
    p.add_argument("--do_eval", action="store_true",
                   help="score every saved checkpoint on the dev set")
    p.add_argument("--do_predict", action="store_true",
                   help="score the test set with the best (or latest) "
                        "checkpoint")
    p.add_argument("--per_device_train_batch_size", type=int, default=16)
    p.add_argument("--eval_batch_size", type=int, default=32)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--num_train_epochs", type=float, default=10)
    p.add_argument("--max_steps", type=int, default=-1)
    p.add_argument("--warmup_steps", type=int, default=10000)
    p.add_argument("--logging_steps", type=int, default=100)
    p.add_argument("--save_steps", type=int, default=1000)
    p.add_argument("--order_metric", default="sent-detect-f1")
    # Higher is better by default (an F1); --no-metric_reverse for a loss.
    p.add_argument("--metric_reverse", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--no_prefetch", action="store_true",
                   help="featurize on the training thread")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    reject_unported(args)
    setup_logging()
    from realise_tpu_torch.data.dataset import (
        batch_iterator,
        pad_examples,
        threaded_prefetch,
    )
    from realise_tpu_torch.data.features import Featurizer
    from realise_tpu_torch.device import resolve_device
    from realise_tpu_torch.models.realise import Realise
    from realise_tpu_torch.training.checkpoint import (
        list_checkpoints,
        load_checkpoint,
        save_checkpoint,
    )
    from realise_tpu_torch.training.trainer import Trainer

    if not (args.do_train or args.do_eval or args.do_predict):
        args.do_train = True
    device = resolve_device(args.device)  # raises without CUDA by default
    tokenizer = build_tokenizer(args)
    cfg = build_config(args, len(tokenizer))
    featurizer = Featurizer(tokenizer, cfg)
    model = Realise(cfg, generator=torch.Generator().manual_seed(args.seed))
    model.install_glyphs(build_glyphs(args, tokenizer, cfg))
    model.install_pho_vocab_tables(*featurizer.pho2_tables())

    train_data = load_dataset(args, tokenizer, args.train_file,
                              num_synthetic=256, seed=args.seed)
    # The loader batch is the MICRO batch (run.py:193-207): an update takes
    # bs × accum examples.
    batch_size = (args.per_device_train_batch_size
                  * args.gradient_accumulation_steps)
    steps_per_epoch = max(-(-len(train_data) // batch_size), 1)
    total_steps = (args.max_steps if args.max_steps > 0
                   else int(steps_per_epoch * args.num_train_epochs))
    trainer = Trainer(
        cfg, model, learning_rate=args.learning_rate,
        warmup_steps=args.warmup_steps, total_steps=max(total_steps, 1),
        weight_decay=args.weight_decay, adam_epsilon=args.adam_epsilon,
        max_grad_norm=args.max_grad_norm,
        grad_accum_steps=args.gradient_accumulation_steps,
        use_kernels=False if args.no_kernels else None, seed=args.seed,
        device=device)

    def batches():
        epoch = 0
        while True:
            for examples in batch_iterator(train_data, batch_size, shuffle=True,
                                           seed=args.seed + epoch,
                                           pad_final=False):
                # Pad a short final batch here (fixed shapes) and zero the
                # padded rows' loss.
                feed = featurizer.featurize(pad_examples(examples, batch_size))
                feed = zero_padding_loss(feed, len(examples))
                yield featurizer.device_batch(feed)
            epoch += 1

    def save_fn(step, tr):
        path = save_checkpoint(args.output_dir, step, tr.model.state_dict(),
                               cfg)
        logger.info("saved checkpoint %s", path)

    if args.do_train:
        logger.info("training: %d examples, batch %d, %d total steps, %s, "
                    "kernels %s", len(train_data), batch_size, total_steps,
                    device, trainer.use_kernels)
        stream = batches() if args.no_prefetch else threaded_prefetch(batches())
        summary = trainer.fit(stream, max_steps=total_steps,
                              logging_steps=args.logging_steps,
                              save_steps=args.save_steps, save_fn=save_fn)
        logger.info("train summary: %s", summary)
        save_fn(trainer.step, trainer)

    def label_file(name):
        return (os.path.join(args.data_dir, name)
                if args.data_dir and name else None)

    pick = max if args.metric_reverse else min
    scored = []  # (checkpoint dir, dev score)
    if args.do_eval:
        dev_data = load_dataset(args, tokenizer, args.dev_file,
                                num_synthetic=64, seed=args.seed + 1)
        all_results = {}
        for step, ckpt_dir in list_checkpoints(args.output_dir):
            trainer.model.load_state_dict(load_checkpoint(ckpt_dir))
            res = evaluate_model(trainer, dev_data, featurizer, tokenizer,
                                 args.output_dir, prefix=f"eval-{step}",
                                 batch_size=args.eval_batch_size,
                                 label_path=label_file(args.dev_label_file))
            logger.info("checkpoint %d dev: %s", step, res)
            all_results[str(step)] = res
            scored.append((ckpt_dir, res[args.order_metric]))
        write_json(os.path.join(args.output_dir, "dev_results.json"),
                   all_results)
        if scored:
            best = pick(scored, key=lambda t: t[1])
            logger.info("best checkpoint: %s (%s=%.2f)", best[0],
                        args.order_metric, best[1])

    if args.do_predict:
        test_data = load_dataset(args, tokenizer, args.predict_file,
                                 num_synthetic=64, seed=args.seed + 2)
        # The best dev checkpoint when --do_eval ranked them, else the
        # latest saved one, else the live weights.
        ckpts = list_checkpoints(args.output_dir)
        predict_ckpt = (pick(scored, key=lambda t: t[1])[0] if scored
                        else ckpts[-1][1] if ckpts else None)
        if predict_ckpt is not None:
            trainer.model.load_state_dict(load_checkpoint(predict_ckpt))
            logger.info("predicting with %s", predict_ckpt)
        res = evaluate_model(trainer, test_data, featurizer, tokenizer,
                             args.output_dir, prefix="predict",
                             batch_size=args.eval_batch_size,
                             label_path=label_file(args.predict_label_file))
        logger.info("predict: %s", res)
        write_json(os.path.join(args.output_dir, "predict_results.json"), res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
