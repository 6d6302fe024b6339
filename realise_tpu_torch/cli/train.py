"""Fine-tune CLI of the port: ``realise_tpu.cli.train`` (the train.sh /
src/run.py equivalent) on one device.

Builds the model with its glyph table and the featurizer's pinyin tables
(the factorized streams read both), trains with AdamW, warmup and the
global-norm clip, saves a port checkpoint every ``--save_steps`` and at the
end (``saved_ckpt-{step}/``, served by ``realise_tpu_torch.serving.Corrector``
and ``cli/correct``, scored by ``cli/test``). ``--do_eval`` scores every
saved checkpoint on the dev set (``dev_results.json``); ``--do_predict``
scores the test set with the best of them by ``--order_metric`` (without
``--do_eval``, the latest); with ``--remove_unused_ckpts`` only the
``--num_save_ckpts`` best are kept. Each checkpoint also holds the
optimizer's state, the step and the dropout generator's state
(``trainer.pt``) and the run's arguments (``training_args.json``), so
``--resume`` continues the run from the newest checkpoint in
``--output_dir``: step k trains on batch k and draws step k's dropout masks,
as the uninterrupted run would. ``--length_buckets 32,64,128`` batches
the examples by length (``data/dataset.bucketed_batch_iterator``) and
featurizes each batch at its bucket's length instead of
``--max_seq_length``; an epoch is then the iterator's batches, each bucket
ending with a short one of its own. ``--trace_dir`` writes a
``torch.profiler`` trace of the first ``--trace_steps`` steps (the host
and, on CUDA, every kernel, with the step's spans as named ranges) and
logs each span's count, device ms and host ms a step
(``utils/profiler.SpanRecorder``) and the update kernels' launches,
tensors and elements (none on the CPU), then the same stream goes on
untraced, without spans.
``--init_ckpt`` starts from a checkpoint's
weights with a fresh optimizer at step 0 (a ``cli/merge`` checkpoint, the
reference's recipe); ``--pho_ckpt``/``--res_ckpt`` then overlay the
pretraining stages' encoders on the initial weights as ``cli/merge`` does
(``training/merge.merge_state_dicts``), the same bits in one step. Runs on
CUDA with the fused kernels unless told otherwise.

``--distributed`` (under torchrun, one process per card) trains data
parallel over ``--mesh data=N`` (default every rank): the global batch is
``per_device_train_batch_size × N × gradient_accumulation_steps``; every
rank iterates the same global batch order, featurizes its contiguous slice
and runs the whole model on it, and the Trainer all-reduces the step's sums
(the JAX CLI's ``--distributed``, realise_tpu/cli/train.py:182-296). Only
rank 0 writes checkpoints and result files; every rank scores, resumes and
fast-forwards alike. ``--mesh data=D,model=M`` (D·M ranks) adds tensor
parallelism: the ranks of one data index split each encoder layer
(``parallel/tensor.py``) and feed the same slice, the batch is
``per_device_train_batch_size × D × gradient_accumulation_steps``, and a
checkpoint holds the full weights, gathered before rank 0 writes them.

Example (smoke, no corpus assets):
    python -m realise_tpu_torch.cli.train --synthetic --tiny --max_steps 2 \
        --do_train --do_eval --do_predict --device cpu --output_dir /tmp/out
    torchrun --nproc_per_node 4 -m realise_tpu_torch.cli.train \
        --distributed --mesh data=4 --synthetic --max_steps 8 \
        --output_dir /tmp/dp
    torchrun --nproc_per_node 4 -m realise_tpu_torch.cli.train \
        --distributed --mesh data=2,model=2 --synthetic --max_steps 8 \
        --output_dir /tmp/tp
"""

from __future__ import annotations

import argparse
import os

import torch

from realise_tpu_torch.cli.common import (
    add_common_args,
    build_config,
    build_glyphs,
    build_mesh,
    build_tokenizer,
    evaluate_model,
    load_dataset,
    logger,
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
    p.add_argument("--init_ckpt", default=None,
                   help="checkpoint dir to initialize from (e.g. merged "
                        "pretrain, the merge.py equivalent)")
    p.add_argument("--pho_ckpt", default=None,
                   help="pho2-pretrain checkpoint dir to overlay at init")
    p.add_argument("--res_ckpt", default=None,
                   help="res-pretrain checkpoint dir to overlay at init")
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
    p.add_argument("--num_save_ckpts", type=int, default=5)
    p.add_argument("--remove_unused_ckpts", action="store_true")
    p.add_argument("--length_buckets", default=None,
                   help="comma-separated padded lengths (e.g. '32,64,128'): "
                        "length-bucketed batching, each batch featurized at "
                        "its bucket's length, instead of always padding to "
                        "max_seq_length")
    p.add_argument("--no_prefetch", action="store_true",
                   help="featurize on the training thread")
    p.add_argument("--trace_dir", default=None,
                   help="capture a torch.profiler trace of the first "
                        "--trace_steps training steps into this directory "
                        "(a Chrome trace that Perfetto and TensorBoard load)")
    p.add_argument("--trace_steps", type=int, default=5)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in output_dir, "
                        "restoring params, BN stats, Adam moments, the step "
                        "counter and the dropout generator (the reference "
                        "loses optimizer state on restart)")
    p.add_argument("--distributed", action="store_true",
                   help="data parallel under torchrun, one process per card: "
                        "form the process group from torchrun's environment "
                        "(NCCL; gloo with --device cpu) before the card is "
                        "touched; the mesh defaults to data=WORLD_SIZE and "
                        "each rank feeds its contiguous slice of every global "
                        "batch")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging()
    tokenizer = build_tokenizer(args)
    cfg = build_config(args, len(tokenizer))
    mesh = build_mesh(args, cfg)  # forms the process group before the card
    from realise_tpu_torch.data.dataset import (
        batch_iterator,
        bucketed_batch_iterator,
        pad_examples,
        threaded_prefetch,
    )
    from realise_tpu_torch.data.features import Featurizer
    from realise_tpu_torch.device import resolve_device
    from realise_tpu_torch.models.realise import Realise
    from realise_tpu_torch.parallel.distributed import (
        barrier,
        is_main_process,
        local_slice,
    )
    from realise_tpu_torch.training.merge import merge_state_dicts
    from realise_tpu_torch.training.checkpoint import (
        list_checkpoints,
        load_checkpoint,
        load_trainer_state,
        retain_top_k,
        save_checkpoint,
    )
    from realise_tpu_torch.training.trainer import Trainer

    if not (args.do_train or args.do_eval or args.do_predict):
        args.do_train = True
    device = resolve_device(args.device)  # raises without CUDA by default
    featurizer = Featurizer(tokenizer, cfg)
    model = Realise(cfg, generator=torch.Generator().manual_seed(args.seed))
    model.install_glyphs(build_glyphs(args, tokenizer, cfg))
    model.install_pho_vocab_tables(*featurizer.pho2_tables())
    if args.init_ckpt:
        # The checkpoint's weights, BN statistics and glyphs (the glyph dedup
        # tables are re-derived on load); the pinyin tables installed above
        # are the featurizer's and stay.
        model.load_state_dict(load_checkpoint(args.init_ckpt))
        logger.info("initialized from %s", args.init_ckpt)
    if args.pho_ckpt or args.res_ckpt:
        model.load_state_dict(merge_state_dicts(
            model.state_dict(),
            pho=load_checkpoint(args.pho_ckpt) if args.pho_ckpt else None,
            res=load_checkpoint(args.res_ckpt) if args.res_ckpt else None))
        logger.info("overlaid the pretrained encoders of %s",
                    [c for c in (args.pho_ckpt, args.res_ckpt) if c])

    train_data = load_dataset(args, tokenizer, args.train_file,
                              num_synthetic=256, seed=args.seed)
    # The loader batch is the MICRO batch (run.py:193-207): an update takes
    # bs × data × accum examples, each rank bs × accum of them.
    batch_size = (args.per_device_train_batch_size
                  * (mesh.data if mesh else 1)
                  * args.gradient_accumulation_steps)
    buckets = ([int(x) for x in args.length_buckets.split(",")]
               if args.length_buckets else None)

    def epoch_batches(epoch):
        """(bucket length or None, examples) of one epoch, unpadded."""
        if buckets:
            return bucketed_batch_iterator(
                train_data, batch_size, buckets=buckets, shuffle=True,
                seed=args.seed + epoch, pad_final=False)
        return ((None, examples) for examples in batch_iterator(
            train_data, batch_size, shuffle=True, seed=args.seed + epoch,
            pad_final=False))

    # The batches of an epoch: ceil(N / batch) without buckets; with them,
    # each bucket's own ceil(n_b / batch), summed, the same in every epoch.
    # (The JAX CLI counts ceil(N / batch) in both cases, so under buckets
    # its epochs and its --resume offsets run short: ROADMAP §C.)
    steps_per_epoch = max(sum(1 for _ in epoch_batches(0)), 1)
    total_steps = (args.max_steps if args.max_steps > 0
                   else int(steps_per_epoch * args.num_train_epochs))
    trainer = Trainer(
        cfg, model, learning_rate=args.learning_rate,
        warmup_steps=args.warmup_steps, total_steps=max(total_steps, 1),
        weight_decay=args.weight_decay, adam_epsilon=args.adam_epsilon,
        max_grad_norm=args.max_grad_norm,
        grad_accum_steps=args.gradient_accumulation_steps,
        use_kernels=False if args.no_kernels else None, seed=args.seed,
        device=device, mesh=mesh)

    if args.resume:
        ckpts = list_checkpoints(args.output_dir)
        if ckpts:
            ckpt_dir = ckpts[-1][1]
            state = load_trainer_state(ckpt_dir)  # raises without trainer.pt
            trainer.model.load_state_dict(load_checkpoint(ckpt_dir))
            trainer.load_state_dict(state)
            logger.info("resumed from %s at step %d", ckpt_dir, trainer.step)
        else:
            logger.info("--resume: no checkpoint in %s, starting at step 0",
                        args.output_dir)

    def batches():
        # The stream the uninterrupted run would see from the trainer's step
        # on: the same per-epoch shuffle seeds, the restored step's epoch,
        # and its offset skipped before featurizing (skipping is free).
        epoch, skip = divmod(trainer.step, steps_per_epoch)
        while True:
            for i, (seq_len, examples) in enumerate(epoch_batches(epoch)):
                if i < skip:
                    continue
                # Pad a short batch here (fixed shapes) and zero the padded
                # rows' loss; a bucket's batch takes the bucket's length.
                # Each rank featurizes its data index's contiguous slice.
                rows = local_slice(pad_examples(examples, batch_size),
                                   trainer.data_index, trainer.data_size)
                feed = featurizer.featurize(rows, seq_len=seq_len)
                feed = zero_padding_loss(feed, len(examples),
                                         trainer.data_index * len(rows))
                yield featurizer.device_batch(feed)
            skip = 0
            epoch += 1

    training_args = dict(vars(args))

    def save_fn(step, tr):
        path = save_checkpoint(args.output_dir, step, tr.model_state_dict(),
                               cfg, trainer_state=tr.state_dict(),
                               training_args=training_args)
        if is_main_process():
            logger.info("saved checkpoint %s", path)

    if args.do_train:
        logger.info("training: %d examples, batch %d, %d total steps, %s, "
                    "kernels %s, mesh %s", len(train_data), batch_size,
                    total_steps, device, trainer.use_kernels, mesh)
        stream = batches() if args.no_prefetch else threaded_prefetch(batches())
        fit_kw = dict(logging_steps=args.logging_steps,
                      save_steps=args.save_steps, save_fn=save_fn)
        try:
            if args.trace_dir:
                # The first steps under the profiler, then the same stream
                # untraced: fit holds no batch back, so step k still trains
                # on batch k. The kernels are built and loaded first, so
                # the trace holds steps and not the compiler.
                from realise_tpu_torch.ops.kernels import adamw
                from realise_tpu_torch.ops.kernels._build import load
                from realise_tpu_torch.utils.profiler import (SpanRecorder,
                                                              trace)

                if trainer.use_kernels:
                    load("bert_block_train")
                if trainer.optimizer.runs_kernels:
                    load("adamw")
                spans = SpanRecorder(device)
                plain, first = trainer.model.span, trainer.step
                updates = (adamw.global_norm_partials.launches
                           + adamw.adamw_update.launches)
                trainer.model.span = spans.span
                try:
                    with trace(args.trace_dir, device):
                        trainer.fit(stream, max_steps=min(
                            trainer.step + args.trace_steps, total_steps),
                            **fit_kw)
                finally:
                    trainer.model.span = plain
                logger.info("wrote the profiler trace to %s", args.trace_dir)
                steps = max(trainer.step - first, 1)
                logger.info("spans of %d traced steps (count, ms a step): %s",
                            steps, "; ".join(
                                f"{name} x{t['count']}"
                                + (f", device {t['device_ms'] / steps:.3f}"
                                   if "device_ms" in t else "")
                                + f", host {t['host_ms'] / steps:.3f}"
                                for name, t in spans.totals().items()))
                logger.info("update kernels of the traced steps: %d launches "
                            "(%d tensors, %d elements a step)",
                            adamw.global_norm_partials.launches
                            + adamw.adamw_update.launches - updates,
                            adamw.adamw_update.tensors,
                            adamw.adamw_update.elements)
            summary = trainer.fit(stream, max_steps=total_steps, **fit_kw)
        finally:
            stream.close()  # stops and joins the prefetch worker
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
        if scored and args.remove_unused_ckpts:
            # Every rank scored alike; rank 0 deletes, and the barrier keeps
            # the others from loading a checkpoint mid-deletion.
            kept = retain_top_k(scored, args.num_save_ckpts,
                                reverse=args.metric_reverse,
                                delete=is_main_process())
            barrier()
            logger.info("kept the %d best checkpoints: %s", len(kept), kept)
        if is_main_process():
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
        if is_main_process():
            write_json(os.path.join(args.output_dir, "predict_results.json"),
                       res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
