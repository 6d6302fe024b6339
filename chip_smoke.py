#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, each of which fails the run (non-zero exit) when it fails:

1. environment: torch/CUDA versions and the card's name and power limit;
2. build: the port's CUDA sources compiled with nvcc (build/realise_tpu_torch/);
3. kernels against their plain PyTorch versions on the card: the fused
   attention and FFN block kernels at H=768, 12 heads, I=3072, float32 and
   bfloat16, (B, S) = (8, 128) and (4, 37) with padded rows, plus the
   masked-garbage check (padded positions of x set to 99 leave valid rows
   unchanged);
4. times at the serving shapes (S=128, B=32 and 256, bf16): each kernel, its
   plain version, one library yardstick the port never calls, and the bound;
   the B=256 profile of each block must show its products on the Hopper GEMM
   with K-major weights and none on ``gemm_bf16_tc``, and the attention
   block its persistent tensor-core core;
5. serving at full width: the published arch3 preset with seeded random
   weights and glyphs, saved as a port checkpoint and served by
   ``realise_tpu_torch.serving.Corrector`` on the card for requests of 1, 8
   and 32 sentences (length buckets 32, 64, 128); every encoder layer must
   have gone through both kernels, and the kernel path's logits must agree
   with the plain path's;
5c. the daemon on that checkpoint: ``cli/serve.serve`` on 127.0.0.1:0 in a
   thread over a Corrector(batch_size=256) with the native featurizer, one
   daemon with the cross-request batcher and one without
   (``--no_cross_batching``), each bound before
   ``warmup(all_buckets=True)``; /healthz; four windows in turns (batcher,
   none, none, batcher) of 8 client threads each POSTing 60 requests of 32
   sentences, the length buckets mixed; every response equal to phase 5's
   serial Corrector's, fewer device steps than requests with the batcher,
   19 launches of each serving kernel per step; each window's sentences/s
   and p50/p99 request latency, and each side's spread;
5b. the native featurizer (built with g++ from the repo's source) against
   the Python one: equal host batches on phase 5's requests, and the
   featurize time of a 32-sentence request both ways;
5d. reference weights: the served model written as a reference
   ``pytorch_model.bin`` (``module.``-prefixed, ``char_resent.``, the tied
   classifier weight) and read back by ``models.torch_import``: the kernel
   path's logits are the served model's bits;
5e. batch invariance: a request of 8 or 32 rows alone and inside batches
   of 16 to 256 rows (48 placements over the three buckets): every stage's
   output for its rows (each encoder layer, the gate fusion's output, the
   logits, the argmax) the same bits;
6. the four train kernels (attention and FFN, forward and backward, with the
   dropout hash) against their plain versions on the card at H=768, 12
   heads, I=3072, float32 and bfloat16, (B, S) = (8, 128) and (4, 37) with
   padded rows, dropout rates 0 and 0.1: y, z, dx and every parameter
   gradient, plus the masked-garbage check (padded rows of x set to 99, dy
   zero there, leave the valid rows' y and dx unchanged);
7. train-kernel times at S=128, bf16, B=32 and 256, dropout 0.1, forward
   and backward apart: each kernel, its plain version, the autograd of a
   library forward the port never calls, and the bound (the backward's
   counting its recompute); at these shapes too every output of each kernel
   is held against its plain version with phase 6's bf16 limit, two calls of
   each backward must give the same bits, the B=256 profile of each
   backward must show its Hopper GEMM (``gemm_sm90``) products, the
   attention backward its tensor-core cores, and no ``gemm_bf16_tc``
   product, and each train forward's B=256 profile its products on the
   Hopper GEMM (the attention forward its persistent core too); the FFN
   forward's gelu(t1) and the backward's replay of it, and the attention
   forward's q/k/v, ctx and pre-LN z32 and the backward's replay of them,
   must be the same bits at B=32 and 256; then the Hopper GEMM alone at the
   B=256 training shapes (dWqkv, FFN dx, and the forward products q/k/v,
   the out-projection with dropout, W1 and W2): time, TFLOP/s and
   ``torch.matmul``'s time on the same inputs;
8. training at full width: the published arch3 preset in bfloat16 at its
   published dropout (0.1), seeded random weights, the procedural glyph
   table and the pinyin tables of the synthetic vocab, synthetic sentences
   featurized at bucket 128, ``realise_tpu_torch.training.Trainer`` on the
   card on the factorized streams for 1 + 5 steps at B=32 and 2 steps at
   B=256, then one more B=256 step under the profiler (device time by
   kernel name); every loss must be finite, every encoder layer must have
   gone through the four train kernels each step, every step through
   the two update kernels once each and the CharResNet's 15 BatchNorms
   through the BatchNorm kernels forward and backward; the device kernels
   of the non-vectorised ``elementwise_kernel<128, 2>`` in one B=256 step
   are attributed to the spans, autograd nodes and ops that launched them;
   then the split of a B=32
   and a B=256 step by stream (CUDA events around each part) on the
   factorized and on the per-token path, with kernel time, host clock and
   peak memory; then, in float32 at dropout 0 on one B=32 batch, the kernel
   path's loss and gradients must agree with the plain path's, and the
   factorized streams' loss, gradients and BatchNorm statistics with the
   per-token streams'; two bf16 backward calls must give the same bits for
   every gradient (the pinyin embeddings, the GRU and the CharResNet too);
8b. (run after phase 9) training at the bucket lengths: the four train
   kernels against their plain versions at B=256, S=32 and 64 (float32 and
   bfloat16, dropout 0 and 0.1, a quarter of the rows padded, with the
   masked-garbage check); ``cli/train --length_buckets 32,64,128
   --trace_dir --trace_steps 3 --do_eval`` at full width (arch3, bf16,
   dropout 0.1, B=256) for one epoch of 3072 sentences of 20-100 chars and
   a dev set of 256: every bucket reached in the epoch's order, 19 launches
   of each train kernel a step, the trace naming each train kernel's CUDA
   functions (``TRACE_NAMES``); then one step per bucket at B=256 and 32
   (host clock, CUDA events, profiled kernels, peak memory), two bf16
   backward calls at S=32 and 64 the same bits, ``fit``'s dispatch
   percentiles at B=256 (the CLI's) and at B=32 with the card's busy
   share, an epoch's sentences/s bucketed and padded to 128; then
   tests/test_convergence.py's recipe on the card through the kernels
   (held-out sent-correct-F1 and sent-detect-F1 above 50). The CLI run and
   the convergence run join the kernels' launch record;
8c. (run after phase 7) the update kernels (``csrc/adamw.cu``, the
   division, the global-norm clip and AdamW in two launches; they replace
   no ``pallas_call``) over arch3's and bert's full-width parameters: one
   clipped step at ``UPDATE_LR`` within ``UPDATE_REL`` of the plain path
   (which torch's AdamW without the decay must miss), two launches a
   step, and the time of both kernels, of the norm alone, of the plain path
   and of torch's fused AdamW (a yardstick) against 32 bytes an element;
8d. (run after 8c) the head's masked cross-entropy kernels
   (``csrc/masked_ce.cu``; they replace no ``pallas_call``) at B=256 and
   S=32, 64, 128 (8192, 16384, 32768 rows of V=21128 bf16 logits, a
   float32 bias, a quarter of the rows masked): the gold logits equal to
   the plain version's, logz within ``CE_LOGZ_TOL``, dlogits within one
   bf16 ulp of the plain backward's from the same logz, dbias the column
   sum of the kernel's own dlogits; two calls the same bits; the time of
   each kernel, of the plain version and of
   ``torch.nn.functional.cross_entropy`` forward and backward (a yardstick)
   against the bytes bound, and the peak memory of each; phase 8's steps
   call each kernel once;
8e. (run after 8d) the CharResNet's training BatchNorm kernels
   (``csrc/batch_norm.cu``; they replace no ``pallas_call``) over the 15
   BatchNorms of the full-width ``resnet`` (each block's first BatchNorm
   with its ReLU, its tail's two with the add and the ReLU), bf16, weighted
   rows (a twelfth of them 0), at 1920, 2816 and 4608 rows (the row
   buckets of the step's ~1,900, ~2,900 and ~4,100 distinct glyphs):
   outputs within one bf16 ulp of the plain chain's, dx within one ulp of
   its largest value, dweight and dbias within 1e-5, two calls the same
   bits; the kernels' device time forward and backward against the bytes
   bound, and the time of the forward, the backward, both through
   autograd, the plain chain and ``F.batch_norm`` (training, unweighted; a
   yardstick) with its ReLU and add, forward and backward;
9. eval and scoring: the trained model saved as a port checkpoint, loaded
   as ``cli/test`` loads it and scored by ``cli.common.evaluate_model`` on
   1024 synthetic sentences in batches of 32 with the serving kernels
   (19 launches of each per batch); metrics finite, files written, and the
   kernel path's argmax equal to the plain path's on >= 99% of the clearly
   decided tokens of one batch;
10. resume at full width (bf16, dropout 0.1, B=32, factorized streams,
   kernels on): 4 steps straight against 2, ``save_checkpoint`` with the
   trainer's state, a new Trainer loaded from it and 2 more: the loss trace
   and every model and optimizer tensor are the same bits; the checkpoint's
   size and its save and load times; then ``cli/train`` on the card, 2
   steps, then ``--resume`` to 4 with ``--do_eval --remove_unused_ckpts
   --num_save_ckpts 1``: both checkpoints scored, the best one kept;
11. the model zoo at full width (``PRESETS``): the fine-tuning presets bert,
   bert-pho1, bert-pho2, bert-pho1-res, bert-pho2-res, bert-pho2-res-arch2,
   bert-pho2-res-arch3-mlm and bert-pho2-res-arch4, and arch3 with each
   ablation switch (--with_pho no, --with_res no, --fusion sum,
   --image_model_type 1), in bf16 at the published dropout with seeded
   random weights and the procedural glyphs. Each config's encoder layers
   (semantic + pho + output block): bert 12 + 0 + 0; the four merged presets
   and arch2 12 + 4 + 2 = 18; arch3-mlm, arch4, --with_res no, --fusion sum
   and resnet1 19; --with_pho no 12 + 0 + 3 = 15. For each: the Trainer's 2
   steps at B=32 on the factorized streams (each layer through the four
   train kernels each step, finite losses), the split of a B=32 and a B=256
   step (host clock, CUDA events, profiled kernel time, peak memory); the
   weights saved, loaded by
   the Corrector and served in requests of 8 and 32 sentences (each layer
   through both serving kernels, the kernel path's argmax against the plain
   path's as in phase 5) and the sentences/s of 32-sentence requests. Phase
   5e's 48 placements on the bert-pho2-res, arch2 and arch3-mlm checkpoints
   (their integrate and MLM transform products are plain bf16 products);
   ``cli/show_gate`` on an arch3 and the --with_pho no checkpoint, its TSV
   on the kernel path against the plain path's within ``GATE_TOL``; then
   phase 8's float32 kernel-vs-plain training check (loss and every
   gradient) on bert-pho2-res and arch3-mlm. Each kernel's launches are
   counted from 0 on the phase's own path (the counted train steps and
   requests, not the checks), and each must be launched;
12. the pretraining stages and the merge at full width (bf16, V=21128,
   seeded random weights, the procedural glyphs, ``--synthetic`` data):
   ``cli/pretrain_pho`` for 4 updates at its published 64 x 2 (every loss
   finite, 4 x 2 launches of each train kernel an update, the dev token
   accuracy in ``dev_results.json`` with 4 launches of each serving kernel
   a batch); ``cli/pretrain_res`` for 4 steps at 512 and its accuracy over
   every CJK char of the vocab; ``pho2-res-pretrain`` through the Trainer, 2
   steps at 64 and one eval batch; phase 8's float32 kernel-vs-plain
   training check on pho2-pretrain and pho2-res-pretrain; ``cli/merge`` of
   the two stages onto a seeded arch3 checkpoint, then ``cli/train
   --max_steps 2 --do_eval`` from ``--init_ckpt`` the merged checkpoint and
   from ``--init_ckpt`` the base with ``--pho_ckpt --res_ckpt``: the same
   initial bits and loss traces, and ``cli/test`` on the merged run; then a
   step of each stage timed (host clock, CUDA events, profiled kernels,
   peak memory), the merge's seconds and the evals' sentences/s and
   chars/s. The kernels' launches on the phase's path join the record;
13. full width against the JAX package: the published arch3 on weights
   and pinyin tables made by ``models.convert.seeded_weights`` from the
   seed of ``tests/golden/port_fullwidth_arch3.npz`` (the JAX package's
   float32 outputs on them, written by tests/test_torch_fullwidth.py; read
   with numpy here), on the card. Fails when the weights' per-tensor
   float64 sums and sums of squares on the card differ from the file's
   (checked first, so a weight mismatch reads as such); when the kernel
   path in float32 (``Realise``, with and without the inference tables)
   puts a logit at the golden top-8 ids or 64 columns, or a gate, further
   than ``FULLWIDTH_F32_TOL`` from the file's; when the kernel path in
   bfloat16 (``Realise`` both ways, and the ``Corrector``'s tables path)
   changes the top-1 id at a position whose golden top-2 margin exceeds
   ``FULLWIDTH_BF16_TOL``, or puts a logit further than that from the
   file's; or when a forward does not launch each serving kernel once per
   encoder layer;
14. the recipe from raw corpus files: ``cli/prepare_data`` on a fabricated
   SIGHAN training SGML and a SIGHAN test input with its truth file (TSV,
   label files, pkl), ``cli/train --do_train --do_eval`` of the published
   arch3 (bf16) for 4 steps on that pkl, scored on the test pkl with the
   produced label file, then ``cli/test``. Fails on a non-zero exit, on
   files whose line or example counts differ from the corpus's, on a
   non-finite loss or score, or when a step does not launch each train
   kernel once per encoder layer or an eval batch each serving kernel; the
   seconds of each step are printed. Both phases' launches join the record;
15. data parallelism (``realise_tpu_torch/parallel/``): (a) ``cli/train
   --distributed --mesh data=1 --do_train --do_eval`` under torchrun's
   variables for a world of one on NCCL (arch3, bf16, the published
   dropout, 4 steps at B=64, checkpoints at steps 2 and 4) against the same
   run without a process group: every checkpoint file (config, weights,
   optimizer state, step, generator) the same bits, the same losses, 19
   launches of each train kernel a step; (b) two ranks on the one card (a
   gloo group through the library API: NCCL refuses two ranks on one
   card), float32 at dropout 0, 32 rows each at S=128, against one process
   on the 64 rows that runs each rank's half with its own BatchNorm batch
   statistics: the loss within 1e-5 relative, every gradient within 1.5e-3
   of its largest entry, the running statistics within 1e-5; (c) the same
   in bf16 at the published dropout, three steps: after every step both
   ranks' weights the same bits, the two ranks' masks different (each rank
   draws its own stream), a second call the same bits, and ``eval_step``'s
   gathered predictions equal to one process's on the 64 rows; (d) with two
   or more cards, ``torchrun --nproc_per_node N`` of ``cli/train
   --distributed --mesh data=N --length_buckets 32,64,128`` at 64 rows a
   card on NCCL for N = 1, 2 and 4 (up to the count): every rank's loss
   trace equal, rank 0 alone writing the checkpoint, the step time, the
   all-reduce's time and sentences/s; on one card (d) logs that it was
   skipped. The launches of (a)'s distributed run and of (c)'s steps and
   gathered eval on both ranks join the record;
16. tensor parallelism (``parallel/tensor.py``, the ``model`` axis) at the
   published arch3 width (12 + 4 + 3 layers, H=768, 12 heads, I=3072,
   V=21128), every rank a process of a gloo group on the one card: (a)
   ``data=1,model=2``, float32 at dropout 0, one step of 16 rows at S=128
   against one process on the plain path over the same rows: the loss and
   the clip's norm within 1e-5 relative, every gathered gradient within
   1e-4 of its tensor's largest entry (the glyph stream's within 1.5e-3),
   every updated weight within 1e-4 of its largest entry beyond Adam's 2
   lr (at most 0.1% of them using that slack), the BN running statistics
   within 1e-5; (d) the mesh's checkpoint (full tensors) loaded in one
   process and stepped: its next step within (a)'s limits of the mesh's;
   (b) bf16 at the published dropout, three steps, twice: after every step
   the replicated weights the same bits on both ranks, a second call the
   same bits, the first step's dropout keys and masks (kept count and
   index sum, the head-split blocks summed over the ranks) one process's
   with the same seed, the weights within 2^-6 of its, and the eval's
   argmax one process's on >= 99% of the clearly decided tokens; the step
   time and the model group's reduces (count, MiB, CUDA-event ms) beside
   one process's; (c) ``data=2,model=2`` on four ranks, 8 rows a data rank
   at S=64, float32, against one process on the 16 rows (BN statistics
   included), (a)'s limits; (e) with two or more cards, ``torchrun`` of
   ``cli/train --distributed --mesh data=1,model=2`` (and
   ``data=2,model=2`` at four) on NCCL, 4 steps at B=64 a data rank: every
   rank's loss trace equal, no kernel launched, the step time, the model
   group's reduces' CUDA-event ms and sentences/s beside 15d's; on one
   card (e) logs that it was skipped. No kernel runs on the phase's path
   (a model axis runs the plain sub-blocks): every launch counter must read
   0 after it.

The last three lines are the kernels' JSON record (all six kernels), the
card's name and power limit as nvidia-smi prints them, and the run's JSON
result.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import re
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 1234
H, HEADS, INTER = 768, 12, 3072
# Max |kernel - plain| allowed: float32 differs only in summation order;
# bfloat16 outputs (LayerNorm, |y| up to ~4) may differ by two ulps at 4.
TOL = {"float32": 1e-4, "bfloat16": 6.25e-2}
# Serving, kernel path vs plain path after 19 layers of differently rounded
# bf16 arithmetic (the Pallas and jnp numerics differ, see
# ops/kernels/bert_block.py): every logit within LOGIT_TOL (16 bf16 ulps at
# |logit| in [1, 2)), and the argmax kept on >= 99% of the valid tokens whose
# top-2 margin on the plain path exceeds LOGIT_TOL. Nearer ties may flip: at
# random init a few percent of the 21128-way argmaxes are that close.
LOGIT_TOL, ARGMAX_AGREE = 0.125, 0.99
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM data sheet, dense
# Train kernels against their plain versions: max |kernel - plain| relative
# to the largest |plain| of each tensor. float32 differs only in the order of
# sums; in bfloat16 a one-ulp flip of a rounded intermediate (a probability,
# a softmax gradient, a gelu) moves its consumers by about an ulp of the
# result, 2^-8 of its largest value; allow four.
TRAIN_REL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
# Training, kernel path vs plain path in float32 at dropout 0 (the two differ
# in float32 summation order and in the scale's multiply vs divide): the loss
# sum within 1e-5 relative, each gradient within 1.5e-3 of its largest
# |value|, that largest value floored at 1e-4 of the largest over all tensors
# (the key biases' gradient is zero in exact arithmetic, since the softmax
# ignores a per-row shift, so both paths hold only rounding noise there). The
# glyph convolutions are the loosest: their gradient passes the BatchNorm
# backward over 4096 images, whose mean subtractions cancel most of each sum
# (6.51e-4 to 6.57e-4 over six runs on an H100); float32 products at TF32
# precision would move it past the limit.
PATH_LOSS_REL, PATH_GRAD_REL = 1e-5, 1.5e-3
# The factorized streams against the per-token streams (same limits for the
# loss and the gradients, float32, dropout 0): the BatchNorm running
# statistics, whose weighted and per-token sums differ in order only.
FACTOR_BN_TOL = 1e-5
TRAIN_RATE = 0.1  # the published dropout of both sites
# The gemm_bf16_tc products a bf16 train backward still runs (by epilogue
# mode, bert_block_common.cuh): none. Every product takes gemm_sm90, the
# replays of the forward (the attention's q/k/v and out-projection, the
# FFN's t1) on the forward's own routes, so that the replayed values are the
# forward's bit for bit.
RECOMPUTE_EPI = {"attention_train_backward": set(), "ffn_train_backward": set()}
# The products (gemm_sm90<EPI, A MN-major, B K-major, ping-pong>) and cores
# each bf16 block kernel must run at B=256: the weight gradients
# (EPI_STORE_F32, A MN-major), dctx (EPI_ROUND), dt1 (EPI_GELU_GRAD) and dx
# (EPI_ADD_F32_ROUND) on the cooperative schedule; with K-major weights,
# the FFN's x.W1^T (EPI_BIAS_GELU, its replay EPI_BIAS_T1_GELU) on the
# ping-pong schedule, its inter.W2^T (EPI_RESID_F32, EPI_RESID_F32_DROP) on
# the cooperative one, the attention's x.Wqkv^T (EPI_BIAS) and ctx.Wo^T
# (EPI_RESID_ROUND, EPI_RESID_ROUND_DROP) on the schedules
# tools/gemm_sm90_probe.py measured fastest; the persistent attention core
# (forward and the backward's replay) and the attention backward core.
QKV = "gemm_sm90<0, false, true, "
CORE = "attention_fwd_core_tc<"
SM90_PRODUCTS = {
    "attention_block": (QKV, "gemm_sm90<2, false, true, ", CORE),
    "ffn_block": ("gemm_sm90<1, false, true, true>", "gemm_sm90<3, false, true, false>"),
    "attention_train_forward": (QKV, "gemm_sm90<4, false, true, ", CORE),
    "ffn_train_forward": ("gemm_sm90<1, false, true, true>",
                          "gemm_sm90<5, false, true, false>"),
    "attention_train_backward": (QKV, "gemm_sm90<4, false, true, ", CORE,
                                 "gemm_sm90<6, true, false, false>",
                                 "gemm_sm90<7, false, false, false>",
                                 "gemm_sm90<8, false, false, false>", "attention_bwd_core_tc<"),
    "ffn_train_backward": ("gemm_sm90<6, true, false, false>",
                           "gemm_sm90<9, false, true, true>",
                           "gemm_sm90<10, false, false, false>",
                           "gemm_sm90<8, false, false, false>")}
# The gemm_bf16_tc products each forward block kernel used to run, by mode.
FORWARD_STALE_EPI = {"attention_block": {0, 2}, "ffn_block": {1, 3},
                     "attention_train_forward": {0, 4}, "ffn_train_forward": {1, 5}}
# The backward GEMM alone against an f32 product of the same bf16 inputs,
# relative to the largest |value|: a float32 weight gradient differs in the
# order of its sums only; a bf16 data gradient by one rounding, 2^-8 of a
# value, allowed twice.
GEMM_REL = {True: 1e-4, False: 2.0 ** -7}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------------ inputs
def block_inputs(b, s, lengths, dtype, device, gen):
    """A full-width BertLayer with randomized biases and LayerNorm, its packed
    kernel parameters, x (B, S, H), a (B, S) mask and its additive bias."""
    import torch

    from realise_tpu_torch.config import config_for
    from realise_tpu_torch.ops.bert import BertLayer, attention_bias_from_mask

    cfg = config_for("bert-pho2-res-arch3", hidden_size=H,
                     num_attention_heads=HEADS, intermediate_size=INTER)
    layer = BertLayer(cfg)
    with torch.no_grad():
        for name, prm in layer.named_parameters():
            if name.endswith("weight") and prm.dim() == 2:
                prm.normal_(0.0, 0.02, generator=gen)
            elif "LayerNorm.weight" in name:
                prm.normal_(1.0, 0.1, generator=gen)
            else:
                prm.normal_(0.0, 0.1, generator=gen)
    layer = layer.to(device)
    p_att, p_ffn = layer.kernel_params(dtype)
    x = torch.randn((b, s, H), generator=gen).to(device=device, dtype=dtype)
    mask = torch.zeros((b, s), dtype=torch.long)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1
    mask = mask.to(device)
    return p_att, p_ffn, x, mask, attention_bias_from_mask(mask, dtype)


def check_kernels(device, gen):
    """Phase 3: every kernel against its plain version; returns the worst
    error per (kernel, dtype)."""
    import torch

    from realise_tpu_torch.ops.kernels import bert_block as bb

    worst = {}
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for b, s, lengths in ((8, 128, (128, 100, 128, 64, 128, 7, 128, 128)),
                              (4, 37, (37, 20, 37, 5))):
            p_att, p_ffn, x, mask, bias = block_inputs(b, s, lengths, dtype,
                                                       device, gen)
            garbage = x.clone()
            garbage[mask == 0] = 99.0
            valid = mask.bool()
            for name, kern, plain in (
                    ("attention_block",
                     lambda t: bb.attention_block(t, p_att, bias, HEADS),
                     lambda t: bb.attention_block_plain(t, p_att, bias, HEADS)),
                    ("ffn_block",
                     lambda t: bb.ffn_block(t, p_ffn),
                     lambda t: bb.ffn_block_plain(t, p_ffn))):
                got = kern(x)
                sync(device)
                err = (got.float() - plain(x).float()).abs().max().item()
                err_g = (kern(garbage)[valid].float()
                         - got[valid].float()).abs().max().item()
                sync(device)
                ok = err <= TOL[dname] and err_g <= TOL[dname]
                log(f"check {name} {dname} B={b} S={s}: max|kernel-plain|="
                    f"{err:.3e} masked-garbage max diff={err_g:.3e} "
                    f"(tol {TOL[dname]:.3e}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"{name} {dname} B={b} S={s} disagrees with its plain "
                         f"version")
                worst[(name, dname)] = max(worst.get((name, dname), 0.0),
                                           err, err_g)
    return worst


# ------------------------------------------------------------------- times
def time_ms(fn, flush, iters=20, warmup=3):
    """Median device time of fn (CUDA events), the L2 flushed before each."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def attention_library(x, p, bias, eps=1e-12, rate=0.0):
    """One PyTorch route to the same function: matmul projections, SDPA,
    layer_norm (and dropout at ``rate`` on the probabilities and the
    output). Timed as a yardstick only."""
    import torch
    import torch.nn.functional as F

    b, s, h = x.shape
    qkv = torch.matmul(x, p["qkv_weight"].t()) + p["qkv_bias"].to(x.dtype)
    q, k, v = (t.view(b, s, HEADS, h // HEADS).transpose(1, 2)
               for t in qkv.split(h, dim=-1))
    ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                         dropout_p=rate)
    attn = torch.matmul(ctx.transpose(1, 2).reshape(b, s, h),
                        p["out_weight"].t()) + p["out_bias"].to(x.dtype)
    attn = F.dropout(attn, rate)
    return F.layer_norm(x + attn, (h,), p["ln_weight"].to(x.dtype),
                        p["ln_bias"].to(x.dtype), eps)


def ffn_library(x, p, eps=1e-12, rate=0.0):
    import torch.nn.functional as F

    t = F.gelu(F.linear(x, p["w1"], p["b1"].to(x.dtype)))
    out = F.dropout(F.linear(t, p["w2"], p["b2"].to(x.dtype)), rate)
    return F.layer_norm(x + out, (x.shape[-1],), p["ln_weight"].to(x.dtype),
                        p["ln_bias"].to(x.dtype), eps)


def kernel_breakdown(fn, label, iters=5, attempts=3):
    """[(ms per call, CUDA kernel name)] of fn from torch.profiler, largest
    first; empty if the profiler recorded no device time in ``attempts``
    traces. One more call of fn goes first, in the schedule's warm-up step:
    a trace loses or clips kernels at its start (a B=256 backward profile
    once lacked the first product of all its calls, and 3-call profiles read
    the first call's first launch as nothing, PERF.md §6). The queue is
    drained before each trace starts and after every call, so the warm-up
    call's kernels end before the active steps begin (a train step that
    does not wait for the card left part of its warm-up step in the active
    one, and bert's profiled B=256 step read more kernel time than its
    CUDA events, PERF.md §5). A trace that holds no device time at
    all (one B=256 FFN train forward profile once, cause not known, PERF.md
    §7) is logged with ``label`` (phase and shape) and taken again; a trace
    that holds some is returned as it is."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=iters,
                                       repeat=1)) as prof:
            for _ in range(iters + 1):
                fn()
                torch.cuda.synchronize()
                prof.step()
        rows = []
        for evt in prof.key_averages():
            us = (getattr(evt, "device_time_total", 0)
                  or getattr(evt, "cuda_time_total", 0))
            if us > 0:
                rows.append((us / iters / 1e3, evt.key))
        if rows:
            return sorted(rows, reverse=True)
        log(f"kernel_breakdown: EMPTY TRACE of {label}, {iters} calls: no "
            f"device time (attempt {attempt} of {attempts}, "
            f"{len(prof.key_averages())} host events)")
    return []


# PyTorch's non-vectorised elementwise kernel (broadcasts, dtype casts).
ELEMENTWISE_BROADCAST = "elementwise_kernel<128, 2"


def kernel_owners(fn, pattern, iters=1):
    """[(ms per call, owner)] of the device kernels of fn whose name holds
    ``pattern``, largest first: owner = the innermost span or autograd node
    around the op that launched them, the outermost op under it, that op
    and its input shapes (torch.profiler with host and device activities;
    one warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True,
                 schedule=schedule(wait=0, warmup=1, active=iters,
                                   repeat=1)) as prof:
        for _ in range(iters + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    owners = {}
    for evt in prof.events():
        us = sum(k.duration for k in getattr(evt, "kernels", ())
                 if pattern in k.name)
        if not us:
            continue
        chain, e = [], evt
        while e is not None:
            chain.append(e.name)
            e = e.cpu_parent
        chain = [n for n in reversed(chain)
                 if not n.startswith("ProfilerStep")]
        outer = [i for i, n in enumerate(chain) if not n.startswith("aten::")]
        top = outer[-1] if outer else -1
        ops = chain[top + 1:] or [evt.name]
        owner = " | ".join([chain[top] if outer else "-", ops[0], evt.name,
                            str(evt.input_shapes)])
        owners[owner] = owners.get(owner, 0.0) + us / iters / 1e3
    return sorted(((ms, o) for o, ms in owners.items()), reverse=True)


def bound(name, b, s):
    """(ms, 'operations'|'bytes'): the least time of the bf16 work — each
    input read once and each output written once at 3.35 TB/s, the
    operations at the bf16 tensor-core peak; the larger of the two."""
    m, d = b * s, H // HEADS
    if name == "attention_block":
        flops = 2 * m * H * 3 * H + 2 * m * H * H + 4 * b * HEADS * s * s * d
        nbytes = 2 * (m * H + 4 * H * H + m * H) + 4 * (6 * H + b * s)
    else:
        flops = 4 * m * H * INTER
        nbytes = 2 * (m * H + 2 * H * INTER + m * H) + 4 * (INTER + 3 * H)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def time_kernels(device, gen, card):
    """Phase 4: {kernel: row at B=32} plus printed rows at B=32 and 256."""
    import torch

    from realise_tpu_torch.ops.kernels import bert_block as bb

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)
    rows = {}
    for b in (32, 256):
        p_att, p_ffn, x, mask, bias = block_inputs(
            b, 128, [128] * b, torch.bfloat16, device, gen)
        cases = {
            "attention_block": (
                lambda: bb.attention_block(x, p_att, bias, HEADS),
                lambda: bb.attention_block_plain(x, p_att, bias, HEADS),
                lambda: attention_library(x, p_att, bias)),
            "ffn_block": (
                lambda: bb.ffn_block(x, p_ffn),
                lambda: bb.ffn_block_plain(x, p_ffn),
                lambda: ffn_library(x, p_ffn)),
        }
        for name, (kern, plain, library) in cases.items():
            err = (kern().float() - plain().float()).abs().max().item()
            ms = time_ms(kern, flush)
            plain_ms = time_ms(plain, flush)
            library_ms = time_ms(library, flush)
            bound_ms, bound_by = bound(name, b, 128)
            log(f"time {name} bf16 B={b} S=128: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}; peaks {PEAK_BF16_FLOPS / 1e12:.0f} "
                f"TFLOP/s bf16, {PEAK_BYTES / 1e12:.2f} TB/s; kernel at "
                f"{bound_ms / ms:.1%} of it), "
                f"max|kernel-plain| {err:.3e} [{card}]")
            if b == 256:
                parts = kernel_breakdown(
                    kern, f"serving kernel {name} B={b} S=128")
                for part_ms, kname in parts[:6]:
                    log(f"  profile {name} B={b}: {part_ms:.4f} ms {kname[:90]}")
                if not parts:
                    log(f"  profile {name} B={b}: no device time recorded")
                if name in SM90_PRODUCTS:
                    check_profile(name, parts, FORWARD_STALE_EPI[name])
            if b == 32:
                rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by,
                                  library_ms=library_ms)
    return rows


# ----------------------------------------------------------------- serving
def sentences(vocab, rng, n, lo, hi):
    cjk = [t for t in vocab if len(t) == 1 and "一" <= t <= "鿿"]
    return ["".join(rng.choice(cjk, size=int(rng.integers(lo, hi + 1))))
            for _ in range(n)]


def serve(device, cfg, gen, ckpt_root, batch_size=32,
          requests=((1, 16, 28), (8, 40, 60), (32, 90, 120))):
    """Phase 5: save a seeded full-width checkpoint under ``ckpt_root``,
    serve requests through the Corrector, check launches and outputs.
    Returns the launch counts, the Corrector and the requests' sentences."""
    import numpy as np
    import torch

    from realise_tpu_torch.data.features import to_device
    from realise_tpu_torch.models.realise import Realise
    from realise_tpu_torch.ops.kernels import bert_block as bb
    from realise_tpu_torch.serving import Corrector
    from realise_tpu_torch.text.vocab import (REAL_VOCAB_CJK_CHARS,
                                              build_synthetic_vocab)
    from realise_tpu_torch.training.checkpoint import save_checkpoint

    vocab = build_synthetic_vocab(size=cfg.vocab_size,
                                  cjk_chars=REAL_VOCAB_CJK_CHARS)
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    model = Realise(cfg, generator=gen)
    model.install_glyphs((torch.rand(model.char_images_multifonts.shape,
                                     generator=gen) < 0.5).float())
    layers = encoder_layers(cfg)
    save_checkpoint(ckpt_root, 0, model.state_dict(), cfg)
    del model
    t1 = time.perf_counter()
    corrector = Corrector(ckpt_root, synthetic_vocab=True, batch_size=batch_size,
                          device=device)
    sync(device)
    t2 = time.perf_counter()
    log(f"serve: init+save {t1 - t0:.2f} s, Corrector load+tables "
        f"{t2 - t1:.2f} s, use_kernels={corrector.use_kernels}, "
        f"{layers} encoder layers per step")
    if not corrector.use_kernels:
        fail("the Corrector did not turn the kernels on for CUDA")
    batches = [sentences(vocab, rng, n, lo, hi) for n, lo, hi in requests]
    for sents in batches:  # warm: kernels loaded, allocator primed
        corrector.correct(sents)

    bb.attention_block.launches = 0
    bb.ffn_block.launches = 0
    steps0 = corrector.steps
    for sents in batches:
        t = time.perf_counter()
        out = corrector.correct(sents)
        dt = time.perf_counter() - t
        if [len(o) for o in out] != [len(s) for s in sents]:
            fail("corrected sentences changed length")
        log(f"serve: request of {len(sents)} sentences (bucket "
            f"{corrector._bucket_for(sents)}): {1e3 * dt:.3f} ms, "
            f"{len(sents) / dt:.1f} sentences/s")
    launches = {"attention_block": bb.attention_block.launches,
                "ffn_block": bb.ffn_block.launches}
    steps = corrector.steps - steps0
    log(f"serve: {steps} device steps, launches {launches}")
    for name, n in launches.items():
        if n != layers * steps:
            fail(f"{name} launched {n} times in {steps} steps, expected "
                 f"{layers} per step")

    # Where each request's time goes: host clock, each part ending
    # synchronised (the device step ends in a copy of the ids to the host),
    # and the device step's kernels by name (the largest request's listed).
    for sents in batches:
        bucket = corrector._bucket_for(sents)
        rows = corrector._batch_bucket_for(len(sents))
        padded = list(sents) + [sents[-1]] * (rows - len(sents))
        t0 = time.perf_counter()
        host = corrector.featurizer.featurize_raw(padded, seq_len=bucket)
        arrays = corrector.featurizer.device_batch(host)
        t1 = time.perf_counter()
        host["pred_idx"] = corrector._device_step(arrays)
        t2 = time.perf_counter()
        for i, src in enumerate(sents):
            corrector._reconstruct(src, host, i)
        t3 = time.perf_counter()
        parts = kernel_breakdown(lambda: corrector.logits(arrays).argmax(-1),
                                 f"serve step B={len(sents)} S={bucket}")
        busy = sum(ms for ms, _ in parts)
        log(f"serve: request of {len(sents)} sentences (bucket {bucket}) split: "
            f"featurize {1e3 * (t1 - t0):.3f} ms, device step "
            f"{1e3 * (t2 - t1):.3f} ms with {busy:.3f} ms of kernels "
            f"({busy / (1e3 * (t2 - t1)):.1%}), reconstruct "
            f"{1e3 * (t3 - t2):.3f} ms")
    for part_ms, kname in parts[:8]:
        log(f"  profile step: {part_ms:.4f} ms {kname[:90]}")

    with torch.inference_mode():
        batch = to_device(arrays, device)
        got = corrector.model(batch, tables=corrector.tables,
                              use_kernels=True)["logits"]
        want = corrector.model(batch, tables=corrector.tables,
                               use_kernels=False)["logits"]
    if tuple(got.shape) != (len(batches[-1]), 128, cfg.vocab_size):
        fail(f"logits shape {tuple(got.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail("non-finite logits")
    check_argmax("serve", got, want, batch["masks"].bool())
    return launches, corrector, batches


def check_argmax(phase, got, want, valid, logits_within=True):
    """The kernel path's logits ``got`` against the plain path's ``want``:
    every valid logit within LOGIT_TOL (unless ``logits_within`` is off),
    and the argmax kept on >= 99% of the valid tokens whose top-2 margin on
    the plain path exceeds it."""
    diff = (got.float() - want.float()).abs()[valid].max().item()
    same = got.argmax(-1) == want.argmax(-1)
    top2 = want.float().topk(2, dim=-1).values
    clear = valid & (top2[..., 0] - top2[..., 1] > LOGIT_TOL)
    agree = same[clear].float().mean().item()
    log(f"{phase}: kernel vs plain path logits max diff {diff:.4f} (tol "
        f"{LOGIT_TOL}); argmax agreement {agree:.4%} (need "
        f"{ARGMAX_AGREE:.0%}) over the {int(clear.sum())} of "
        f"{int(valid.sum())} valid tokens with a top-2 margin above "
        f"{LOGIT_TOL}, {same[valid].float().mean().item():.4%} over all")
    if ((logits_within and diff > LOGIT_TOL) or not clear.any()
            or agree < ARGMAX_AGREE):
        fail(f"{phase}: the kernel path disagrees with the plain path")


# ------------------------------------------------------------ train kernels
def train_outputs(tbt, x, dy, p_att, p_ffn, bias, seed, rate, kernel):
    """{output name: tensor} of the four train kernels (``kernel``) or their
    plain versions on the same inputs; the FFN backward reads the plain z."""
    suffix = "" if kernel else "_plain"
    fn = lambda name: getattr(tbt, name + suffix)
    out = {"attention_train_forward y": fn("attention_train_forward")(
        x, p_att, bias, seed, HEADS, 1e-12, rate, rate)}
    dx, g = fn("attention_train_backward")(x, dy, p_att, bias, seed, HEADS,
                                           1e-12, rate, rate)
    out["attention_train_backward dx"] = dx
    out.update({f"attention_train_backward d{k}": v for k, v in g.items()})
    y, z = fn("ffn_train_forward")(x, p_ffn, seed, 1e-12, rate)
    out["ffn_train_forward y"], out["ffn_train_forward z"] = y, z
    z0 = tbt.ffn_train_forward_plain(x, p_ffn, seed, 1e-12, rate)[1]
    dx, g = fn("ffn_train_backward")(x, z0, dy, p_ffn, seed, 1e-12, rate)
    out["ffn_train_backward dx"] = dx
    out.update({f"ffn_train_backward d{k}": v for k, v in g.items()})
    return out


TRAIN_CHECK_SHAPES = ((8, 128, (128, 100, 128, 64, 128, 7, 128, 128)),
                      (4, 37, (37, 20, 37, 5)))


def check_train_kernels(device, gen, shapes=TRAIN_CHECK_SHAPES):
    """Phase 6 (and 8b at its ``shapes``): the train kernels against their
    plain versions at each (B, S, valid lengths); returns the worst relative
    error per (kernel, dtype)."""
    import torch

    from realise_tpu_torch.ops.kernels import bert_block_train as tbt

    worst = {}
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for b, s, lengths in shapes:
            p_att, p_ffn, x, mask, bias4 = block_inputs(b, s, lengths, dtype,
                                                        device, gen)
            bias = bias4.reshape(b, s).float()
            dy = torch.randn((b, s, H), generator=gen).to(device=device,
                                                         dtype=dtype)
            for rate in (0.0, TRAIN_RATE):
                seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen))
                got = train_outputs(tbt, x, dy, p_att, p_ffn, bias, seed, rate,
                                    True)
                want = train_outputs(tbt, x, dy, p_att, p_ffn, bias, seed,
                                     rate, False)
                sync(device)
                for name, w in want.items():
                    g = got[name]
                    if g.shape != w.shape or g.dtype != w.dtype:
                        fail(f"{name}: {g.shape}/{g.dtype}, plain "
                             f"{w.shape}/{w.dtype}")
                    err = ((g.float() - w.float()).abs().max()
                           / w.float().abs().max().clamp_min(1e-30)).item()
                    kname = name.split()[0]
                    worst[(kname, dname)] = max(worst.get((kname, dname), 0.0),
                                                err)
                    if not err <= TRAIN_REL[dname]:
                        fail(f"{name} {dname} B={b} S={s} rate={rate}: "
                             f"relative error {err:.3e} > {TRAIN_REL[dname]}")
                # Masked garbage: padded rows of x at 99 and dy zero there
                # leave the valid rows' y and dx as they were.
                valid = mask.bool()
                dy0 = dy.masked_fill(~valid[..., None], 0.0)
                garbage = x.masked_fill(~valid[..., None], 99.0)
                errs = []
                for xx in (x, garbage):
                    y = tbt.attention_train_forward(xx, p_att, bias, seed, HEADS,
                                                    1e-12, rate, rate)
                    dx, _ = tbt.attention_train_backward(
                        xx, dy0, p_att, bias, seed, HEADS, 1e-12, rate, rate)
                    yf, z = tbt.ffn_train_forward(xx, p_ffn, seed, 1e-12, rate)
                    dxf, _ = tbt.ffn_train_backward(xx, z, dy0, p_ffn, seed,
                                                    1e-12, rate)
                    errs.append([t[valid].float() for t in (y, dx, yf, dxf)])
                sync(device)
                err_g = max((a - c).abs().max().item()
                            for a, c in zip(*errs))
                log(f"check train kernels {dname} B={b} S={s} rate={rate}: "
                    f"worst relative |kernel-plain| " + ", ".join(
                        f"{k} {v:.2e}" for (k, d), v in sorted(worst.items())
                        if d == dname)
                    + f"; masked-garbage max diff {err_g:.3e}")
                if err_g > 0.0:
                    fail(f"train kernels {dname} B={b} S={s}: padded-row "
                         f"garbage changed valid rows by {err_g}")
    return worst


def train_bound(name, b, s):
    """(ms, 'operations'|'bytes') of a train kernel at bf16: FLOPs at the
    tensor-core peak (the backward counts its recompute of the forward),
    bytes of each input read once and each output written once."""
    m, d = b * s, H // HEADS
    core = 4 * b * HEADS * s * s * d            # q.k^T and P.V
    att_fwd = 8 * m * H * H + core
    weights = 2 * 4 * H * H + 4 * 6 * H
    if name == "attention_train_forward":
        flops, nbytes = att_fwd, 2 * 2 * m * H + weights + 4 * b * s
    elif name == "attention_train_backward":
        # recompute + dctx (2mH^2) + dV, dP, dQ, dK (2 core) + dWqkv, dWo,
        # dx (6 + 2 + 6 mH^2)
        flops = att_fwd + 16 * m * H * H + 2 * core
        nbytes = 3 * 2 * m * H + weights + 4 * b * s + 4 * (4 * H * H + 6 * H)
    elif name == "ffn_train_forward":
        flops = 4 * m * H * INTER
        nbytes = 2 * m * H + 4 * H * INTER + 4 * (INTER + 3 * H) + 2 * 2 * m * H
    else:  # ffn_train_backward: t1, dW2, dinter, dW1, dx
        flops = 10 * m * H * INTER
        nbytes = (4 * 2 * m * H + 4 * H * INTER + 4 * (INTER + 2 * H)
                  + 4 * (2 * H * INTER + INTER + 3 * H))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def flat_outputs(out):
    """A train wrapper's output (y, (y, z) or (dx, {grads})) as a list."""
    import torch

    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out[1], dict):
        return [out[0], *out[1].values()]
    return list(out)


def check_deterministic(name, b, kern):
    """Two calls of a train backward give the same bits (no atomics; split-K
    partials summed in a fixed order)."""
    import torch

    first, second = flat_outputs(kern()), flat_outputs(kern())
    same = all(torch.equal(x, y) for x, y in zip(first, second))
    log(f"check {name} bf16 B={b}: two calls bitwise equal over "
        f"{len(first)} outputs: {same}")
    if not same:
        fail(f"{name} bf16 B={b}: two calls differ")


def check_profile(name, parts, stale_epi):
    """The B=256 profile of a bf16 block kernel shows each of its Hopper GEMM
    products and tensor-core attention cores, and no CUDA-core attention
    core, no earlier non-persistent ``attention_core_tc``, and no
    ``gemm_bf16_tc`` product of an epilogue mode in ``stale_epi``."""
    names = [k for _, k in parts]
    if not names:
        fail(f"{name}: the profiler recorded no device time")
    stale = [k for k in names
             if re.search(r"attention_(bwd_)?core<|attention_core_tc<", k)]
    for k in names:
        mode = re.search(r"gemm_bf16_tc<(\d+)", k)
        if mode and int(mode.group(1)) in stale_epi:
            stale.append(k)
    missing = [m for m in SM90_PRODUCTS[name] if not any(m in k for k in names)]
    log(f"check {name} B=256 profile: old routes {len(stale)}, missing "
        f"{missing or 'none'}")
    if stale or missing:
        fail(f"{name}: profile shows {stale} and lacks {missing}")


def check_replay_bits(b, p_ffn, x):
    """The FFN forward's gelu(t1) (its W1 product's epilogue) and the FFN
    backward's replay of it, on the route both take, are the same bits."""
    import torch

    from realise_tpu_torch.ops.kernels import bert_block_train as tbt

    xf = x.reshape(-1, H)
    inter = tbt.forward_gemm(xf, p_ffn["w1"], p_ffn["b1"], tbt.EPI_BIAS_GELU)
    replay = tbt.forward_gemm(xf, p_ffn["w1"], p_ffn["b1"], tbt.EPI_BIAS_T1_GELU)[1]
    same = torch.equal(inter, replay)
    log(f"check FFN t1 replay bf16 B={b}: gelu(t1) of the backward equals the "
        f"forward's bit for bit: {same}")
    if not same:
        fail(f"the FFN backward's replayed gelu(t1) differs from the forward's at B={b}")


def check_attention_replay_bits(b, p_att, x, dy, bias):
    """The attention train forward's q/k/v, ctx and pre-LN z32 and the
    backward's recompute of them (the same routes and core launcher) are the
    same bits, dropout 0.1 on both sites."""
    import torch

    from realise_tpu_torch.ops.kernels import bert_block_train as tbt

    fwd, bwd = {}, {}
    tbt.attention_train_forward(x, p_att, bias, 4321, HEADS, 1e-12, TRAIN_RATE,
                                TRAIN_RATE, scratch=fwd)
    tbt.attention_train_backward(x, dy, p_att, bias, 4321, HEADS, 1e-12,
                                 TRAIN_RATE, TRAIN_RATE, scratch=bwd)
    same = {k: torch.equal(fwd[k], bwd[k]) for k in ("qkv", "ctx", "z32")}
    log(f"check attention replay bf16 B={b}: q/k/v, ctx and z32 of the backward "
        f"equal the forward's bit for bit: {same}")
    if not all(same.values()):
        fail(f"the attention backward's replay differs from the forward's at B={b}")


def time_backward_gemm(device, gen, card):
    """The Hopper GEMM alone at six products of the B=256, S=128 training
    shapes: dWqkv = dqkvᵀ·x (both operands MN-major, float32 split-K
    partials), the FFN's dx = dt1·W1 (A K-major, bf16 out), and, with K-major
    weights on the blocks' route, the attention's x·Wqkvᵀ with its bias and
    ctx·Woᵀ into the float32 residual with dropout 0.1, the FFN's x·W1ᵀ with
    bias and gelu and inter·W2ᵀ into the float32 residual with dropout
    0.1."""
    import torch

    from realise_tpu_torch.ops.kernels import bert_block_train as tbt

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)
    m = 256 * 128
    for label, trans, shape_a, shape_b in (
            ("dWqkv = dqkv^T.x", True, (m, 3 * H), (m, H)),
            ("FFN dx = dt1.W1", False, (m, INTER), (INTER, H))):
        a = torch.randn(shape_a, generator=gen).to(device, torch.bfloat16)
        b = torch.randn(shape_b, generator=gen).to(device, torch.bfloat16)
        lhs = a.t() if trans else a
        rows, depth, cols = lhs.shape[0], lhs.shape[1], b.shape[1]
        got = tbt.backward_gemm(a, b, trans).float()
        want = lhs.float() @ b.float()
        err = ((got - want).abs().max() / want.abs().max()).item()
        del got, want
        ms = time_ms(lambda: tbt.backward_gemm(a, b, trans), flush)
        lib_ms = time_ms(lambda: torch.matmul(lhs, b), flush)
        tflops = 2 * rows * depth * cols / ms / 1e9
        log(f"gemm_sm90 {label} (M={rows}, N={cols}, K={depth}, A "
            f"{'MN' if trans else 'K'}-major, B MN-major): {ms:.4f} ms, "
            f"{tflops:.1f} TFLOP/s ({tflops / (PEAK_BF16_FLOPS / 1e12):.1%} of "
            f"the bf16 peak), torch.matmul {lib_ms:.4f} ms, relative "
            f"|gemm - f32 product| {err:.2e} (tol {GEMM_REL[trans]:.2e}) [{card}]")
        if not err <= GEMM_REL[trans]:
            fail(f"gemm_sm90 {label}: relative error {err:.3e}")
    x = torch.randn((m, H), generator=gen).to(device, torch.bfloat16)
    for label, mode, k, n in (
            ("attention q/k/v x.Wqkv^T + bqkv", tbt.EPI_BIAS, H, 3 * H),
            ("attention out x + drop(ctx.Wo^T + bo)", tbt.EPI_RESID_ROUND_DROP, H, H),
            ("FFN W1 gelu(x.W1^T + b1)", tbt.EPI_BIAS_GELU, H, INTER),
            ("FFN W2 x + drop(inter.W2^T + b2)", tbt.EPI_RESID_F32_DROP, INTER, H)):
        a = torch.randn((m, k), generator=gen).to(device, torch.bfloat16)
        w = (torch.randn((n, k), generator=gen) * k ** -0.5).to(device, torch.bfloat16)
        bias = (torch.randn((n,), generator=gen) * 0.1).to(device)
        args = (a, w, bias, mode, x if n == H else None, 4321, 128, TRAIN_RATE)
        got, want = tbt.forward_gemm(*args), tbt.forward_gemm_plain(*args)
        f32 = mode == tbt.EPI_RESID_F32_DROP  # no bf16 rounding on the way
        err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
        del got, want
        ms = time_ms(lambda: tbt.forward_gemm(*args), flush)
        lib_ms = time_ms(lambda: torch.matmul(a, w.t()), flush)
        tflops = 2 * m * k * n / ms / 1e9
        log(f"gemm_sm90 {label} (M={m}, N={n}, K={k}, A K-major, B K-major, "
            f"the blocks' route): {ms:.4f} ms, {tflops:.1f} TFLOP/s "
            f"({tflops / (PEAK_BF16_FLOPS / 1e12):.1%} of the bf16 peak), "
            f"torch.matmul {lib_ms:.4f} ms, relative |gemm - plain| {err:.2e} "
            f"(tol {GEMM_REL[f32]:.2e}) [{card}]")
        if not err <= GEMM_REL[f32]:
            fail(f"gemm_sm90 {label}: relative error {err:.3e}")


def time_train_kernels(device, gen, card):
    """Phase 7: {kernel: row at B=32}; rows at B=32 and 256 printed."""
    import torch

    from realise_tpu_torch.ops.kernels import bert_block_train as tbt

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)
    rows = {}
    r = TRAIN_RATE
    for b in (32, 256):
        p_att, p_ffn, x, _, bias4 = block_inputs(b, 128, [128] * b,
                                                 torch.bfloat16, device, gen)
        bias = bias4.reshape(b, 128).float()
        dy = torch.randn((b, 128, H), generator=gen).to(device=device,
                                                       dtype=torch.bfloat16)
        seed = 4321
        z = tbt.ffn_train_forward(x, p_ffn, seed, 1e-12, r)[1]
        # Library yardstick: autograd of the phase-4 library forwards with
        # dropout; the backward is timed alone on a retained graph.
        lib_x = x.detach().clone().requires_grad_()
        lib_att = {k: v.detach().clone().requires_grad_() for k, v in p_att.items()}
        lib_ffn = {k: v.detach().clone().requires_grad_() for k, v in p_ffn.items()}
        att_y = attention_library(lib_x, lib_att, bias4, rate=r)
        ffn_y = ffn_library(lib_x, lib_ffn, rate=r)
        att_in = [lib_x, *lib_att.values()]
        ffn_in = [lib_x, *lib_ffn.values()]
        cases = {
            "attention_train_forward": (
                lambda: tbt.attention_train_forward(x, p_att, bias, seed, HEADS,
                                                    1e-12, r, r),
                lambda: tbt.attention_train_forward_plain(x, p_att, bias, seed,
                                                          HEADS, 1e-12, r, r),
                lambda: attention_library(lib_x, lib_att, bias4, rate=r)),
            "attention_train_backward": (
                lambda: tbt.attention_train_backward(x, dy, p_att, bias, seed,
                                                     HEADS, 1e-12, r, r),
                lambda: tbt.attention_train_backward_plain(
                    x, dy, p_att, bias, seed, HEADS, 1e-12, r, r),
                lambda: torch.autograd.grad(att_y, att_in, dy,
                                            retain_graph=True)),
            "ffn_train_forward": (
                lambda: tbt.ffn_train_forward(x, p_ffn, seed, 1e-12, r),
                lambda: tbt.ffn_train_forward_plain(x, p_ffn, seed, 1e-12, r),
                lambda: ffn_library(lib_x, lib_ffn, rate=r)),
            "ffn_train_backward": (
                lambda: tbt.ffn_train_backward(x, z, dy, p_ffn, seed, 1e-12, r),
                lambda: tbt.ffn_train_backward_plain(x, z, dy, p_ffn, seed,
                                                     1e-12, r),
                lambda: torch.autograd.grad(ffn_y, ffn_in, dy,
                                            retain_graph=True)),
        }
        for name, (kern, plain, library) in cases.items():
            got, want = flat_outputs(kern()), flat_outputs(plain())
            diffs = [(k.float() - w.float()).abs().max().item()
                     for k, w in zip(got, want)]
            err = max(diffs)
            rel = max(d / max(w.float().abs().max().item(), 1e-30)
                      for d, w in zip(diffs, want))
            log(f"check {name} bf16 B={b} S=128 rate={r}: worst relative "
                f"|kernel-plain| over {len(want)} outputs {rel:.3e} (tol "
                f"{TRAIN_REL['bfloat16']:.3e})")
            if not rel <= TRAIN_REL["bfloat16"]:
                fail(f"{name} bf16 B={b} S=128 rate={r}: relative error "
                     f"{rel:.3e} > {TRAIN_REL['bfloat16']}")
            del got, want
            ms = time_ms(kern, flush)
            plain_ms = time_ms(plain, flush, iters=5, warmup=1)
            library_ms = time_ms(library, flush)
            bound_ms, bound_by = train_bound(name, b, 128)
            log(f"time {name} bf16 B={b} S=128 rate={r}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}; kernel at "
                f"{bound_ms / ms:.1%} of it), max|kernel-plain| {err:.3e} "
                f"[{card}]")
            if name in RECOMPUTE_EPI:
                check_deterministic(name, b, kern)
            if b == 256:
                parts = kernel_breakdown(kern, f"train kernel {name} B={b} S=128",
                                         iters=3)
                for part_ms, kname in parts[:8]:
                    log(f"  profile {name} B={b}: {part_ms:.4f} ms {kname[:90]}")
                if name in RECOMPUTE_EPI:
                    check_profile(name, parts, set(range(11))
                                  - RECOMPUTE_EPI[name])
                elif name in SM90_PRODUCTS:
                    check_profile(name, parts, FORWARD_STALE_EPI[name])
            if b == 32:
                rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by,
                                  library_ms=library_ms)
        del att_y, ffn_y
        check_replay_bits(b, p_ffn, x)
        check_attention_replay_bits(b, p_att, x, dy, bias)
    return rows


# ------------------------------------------------------- update kernels
# Phase 8c: the update kernels against the plain path after one clipped
# step, each parameter and moment within this much of its tensor's largest
# value (float32; the norm's sums are taken in another order and the
# kernel's arithmetic is FMA-contracted). The step's lr and decay: the
# decay moves a decayed parameter by lr * wd = 2e-5 of its value, 20 times
# the limit, so a kernel that left it out would fail.
UPDATE_REL = 1e-6
# The CE forward's logz against torch.logsumexp, relative to the largest
# |logz|: the kernel sums exps (__expf) in an order of its own.
CE_LOGZ_TOL = 2e-6
UPDATE_LR, UPDATE_WD = 2e-3, 0.01


def update_kernels(device, card):
    """Phase 8c: ``csrc/adamw.cu`` over arch3's and bert's full-width
    parameter sets, gradient sums over 6000 tokens, clipped at 1.0: one step
    against the plain path (the division, ``clip_by_global_norm``,
    ``torch.optim.AdamW``) from the same state, two launches a step, and
    the plain path without the decay as a control that the comparison must
    see as wrong; then
    the times (CUDA events, 20 calls, L2 flushed) of both kernels, of the
    norm kernel alone, of the plain path and of one library yardstick the
    port never calls (``torch.nn.utils.clip_grad_norm_`` and AdamW with
    ``fused=True``), against the bound of 32 bytes an element. Returns the
    arch3 row."""
    import copy

    import torch

    from realise_tpu_torch.config import config_for
    from realise_tpu_torch.models.realise import build_model
    from realise_tpu_torch.ops.kernels import adamw as kadamw
    from realise_tpu_torch.training.optim import (clip_by_global_norm,
                                                  make_optimizer)

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)
    count = torch.tensor(6000.0, device=device)
    row = {}
    for preset in (ARCH3, "bert"):
        model = build_model(config_for(preset, vocab_size=21128),
                            generator=torch.Generator().manual_seed(SEED + 40))
        model = model.to(device)
        models = {k: copy.deepcopy(model) for k in ("kernel", "plain",
                                                      "library", "no_decay")}
        del model
        opts = {k: make_optimizer(m, UPDATE_LR, UPDATE_WD)
                for k, m in models.items()}
        for k in ("plain", "library", "no_decay"):
            opts[k] = torch.optim.AdamW(
                [dict(g, params=list(g["params"]),
                      weight_decay=0.0 if k == "no_decay"
                      else g["weight_decay"])
                 for g in opts[k].param_groups], fused=k == "library")
        params = {k: [p for g in o.param_groups for p in g["params"]]
                  for k, o in opts.items()}
        gen = torch.Generator(device=device).manual_seed(SEED + 41)
        sums = [torch.randn(p.shape, generator=gen, device=device) * 40
                for p in params["kernel"]]
        # The plain path divides and clips its gradients in place: its own.
        grads = {k: [t.clone() for t in sums]
                 for k in ("plain", "library", "no_decay")}

        def kernel(clip_only=False):
            for p, s in zip(params["kernel"], sums):
                p.grad = s
            opts["kernel"].clip(count, 1.0)
            if not clip_only:
                opts["kernel"].step()

        def plain(key="plain"):
            for p, g in zip(params[key], grads[key]):
                p.grad = g
            if key != "library":
                denom = torch.clamp(count, min=1.0)
                for g in grads[key]:
                    g.div_(denom)
                clip_by_global_norm(grads[key], 1.0)
            else:
                torch._foreach_div_(grads[key], torch.clamp(count, min=1.0))
                torch.nn.utils.clip_grad_norm_(params[key], 1.0,
                                               foreach=True)
            opts[key].step()

        before = kadamw.global_norm_partials.launches + \
            kadamw.adamw_update.launches
        kernel()
        launches = (kadamw.global_norm_partials.launches
                    + kadamw.adamw_update.launches - before)
        plain()
        plain("no_decay")
        torch.cuda.synchronize()

        def worst_of(key):
            worst = 0.0
            for p, q in zip(params[key], params["plain"]):
                pairs = [(p, q)] + [(opts[key].state[p][k],
                                     opts["plain"].state[q][k])
                                    for k in ("exp_avg", "exp_avg_sq")]
                for a, b in pairs:
                    worst = max(worst, ((a - b).abs().max() / b.abs().max()
                                        .clamp_min(1e-30)).item())
            return worst

        worst, control = worst_of("kernel"), worst_of("no_decay")
        n = sum(p.numel() for p in params["kernel"])
        # The kernels alone, their tables and pointers made beforehand (the
        # optimizer's call adds its host work: the checks and pointers of
        # every gradient, which the card hides only behind queued work).
        state = opts["kernel"].state
        tables = kadamw.Tables(
            params["kernel"], [state[p]["exp_avg"] for p in params["kernel"]],
            [state[p]["exp_avg_sq"] for p in params["kernel"]],
            [gi for gi, g in enumerate(opts["kernel"].param_groups)
             for _ in g["params"]])
        ptrs = tables.gradient_pointers(sums)
        scalars = [kadamw.group_scalars(UPDATE_LR, (0.9, 0.999), 1e-8, g[
            "weight_decay"], 2) for g in opts["kernel"].param_groups]
        norm_out = torch.empty((), device=device)

        def kernels(norm_only=False):
            kadamw.global_norm_partials(tables, ptrs)
            if not norm_only:
                kadamw.adamw_update(tables, ptrs, count, 1.0, scalars,
                                    norm_out)

        ms = time_ms(kernels, flush)
        norm_ms = time_ms(lambda: kernels(norm_only=True), flush)
        call_ms = time_ms(kernel, flush)
        plain_ms = time_ms(plain, flush)
        library_ms = time_ms(lambda: plain("library"), flush)
        bound_ms = 1e3 * 32 * n / PEAK_BYTES
        log(f"update kernels {preset}: {len(params['kernel'])} tensors, "
            f"{n} elements, {launches} launches a step; both kernels "
            f"{ms:.4f} ms (norm {norm_ms:.4f} ms, its bound "
            f"{1e3 * 4 * n / PEAK_BYTES:.4f} ms), bound {bound_ms:.4f} ms "
            f"(bytes, 32 B an element at {PEAK_BYTES / 1e12:.2f} TB/s; "
            f"kernels at {bound_ms / ms:.1%} of it); the optimizer's "
            f"clip+step {call_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{library_ms:.4f} ms; worst relative |kernel-plain| "
            f"{worst:.2e} (tol {UPDATE_REL}; the plain path without the "
            f"decay {control:.2e}) [{card}]")
        if launches != 2 or worst > UPDATE_REL:
            fail(f"update kernels {preset}: {launches} launches, worst "
                 f"relative error {worst:.2e}")
        if control <= UPDATE_REL:
            fail(f"update kernels {preset}: the plain path without the decay "
                 f"reads {control:.2e}, within the limit {UPDATE_REL}")
        if preset == ARCH3:
            row = dict(max_rel_err=worst, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by="bytes",
                       library_ms=library_ms, call_ms=call_ms)
        del models, opts, params, sums, grads, tables, ptrs
        torch.cuda.empty_cache()
    return row


def ce_bytes(rows, v):
    """Bytes the CE forward and backward must move at (rows, v) bf16 logits
    with a float32 bias: the logits read once each, dlogits written once;
    labels, mask, logz, gold and the bias."""
    n = rows * v
    return (2 * n + rows * (8 + 4 + 4) + 4 * v,
            4 * n + rows * (8 + 4 + 4) + 4 * v + 4 * v)


def ce_kernels(device, card, v=21128, batch=256):
    """Phase 8d: ``csrc/masked_ce.cu`` at B=256 and S=32, 64, 128 against
    the plain version on the card, two calls the same bits, then the times
    (CUDA events, 20 calls, L2 flushed) of each kernel, both, the plain
    version and F.cross_entropy's forward and backward (a yardstick the
    port never calls) against the bytes bound, and the peak memory of a
    forward and backward on each path. Returns the S=64 row."""
    import torch
    import torch.nn.functional as F

    from realise_tpu_torch.ops.kernels import masked_ce as kce

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)
    row = {}
    gen = torch.Generator(device=device).manual_seed(SEED + 50)
    bias = torch.randn(v, generator=gen, device=device)
    dsum = torch.ones((), device=device)
    for s in (32, 64, 128):
        rows = batch * s
        logits = (torch.randn((rows, v), generator=gen, device=device)
                  * 3).to(torch.bfloat16)
        labels = torch.randint(0, v, (rows,), generator=gen, device=device)
        labels[:2], labels[2:4] = 0, v - 1
        m = (torch.rand(rows, generator=gen, device=device) > 0.25).float()
        logz, gold = kce.masked_ce_fwd(logits, bias, labels)
        want_logz, want_gold = kce.masked_ce_fwd_plain(logits, bias, labels)
        dl, db = kce.masked_ce_bwd(logits, bias, labels, m, logz, dsum)
        want_dl, _ = kce.masked_ce_bwd_plain(logits, bias, labels, m, logz,
                                             dsum)
        again = kce.masked_ce_fwd(logits, bias, labels)
        again += kce.masked_ce_bwd(logits, bias, labels, m, again[0], dsum)
        torch.cuda.synchronize()
        logz_err = ((logz - want_logz).abs().max()
                    / want_logz.abs().max()).item()
        diff = (dl.float() - want_dl.float()).abs()
        ulp = (torch.maximum(dl.float().abs(), want_dl.float().abs())
               * 2.0 ** -7).clamp_min(1e-38)
        ulps = (diff / ulp).masked_fill(diff == 0, 0).max().item()
        flips = int(torch.count_nonzero(diff))
        own = dl.float().sum(0)
        db_err = ((db - own).abs().max() / own.abs().max()).item()
        same = all(torch.equal(a, b) for a, b in zip((logz, gold, dl, db),
                                                      again))
        del again, want_dl, own
        log(f"CE kernels B={batch} S={s} ({rows} rows): gold "
            f"{'equal' if torch.equal(gold, want_gold) else 'DIFFERENT'}, "
            f"logz {logz_err:.2e} (tol {CE_LOGZ_TOL}), dlogits {flips} "
            f"elements differ, largest {ulps:.2f} bf16 ulp, dbias against "
            f"its dlogits' column sum {db_err:.2e}, two calls "
            f"{'the same bits' if same else 'DIFFERENT'}")
        if (not torch.equal(gold, want_gold) or logz_err > CE_LOGZ_TOL
                or ulps > 1.0 or db_err > 1e-5 or not same):
            fail(f"CE kernels at {rows} rows: gold, logz, dlogits or dbias "
                 f"off, or two calls differ")

        def fwd():
            kce.masked_ce_fwd(logits, bias, labels)

        def bwd():
            kce.masked_ce_bwd(logits, bias, labels, m, logz, dsum)

        def both():
            z, _ = kce.masked_ce_fwd(logits, bias, labels)
            kce.masked_ce_bwd(logits, bias, labels, m, z, dsum)

        def plain():
            z, _ = kce.masked_ce_fwd_plain(logits, bias, labels)
            kce.masked_ce_bwd_plain(logits, bias, labels, m, z, dsum)

        def library():
            x = logits.detach().requires_grad_(True)
            loss = F.cross_entropy(x + bias.to(x.dtype), labels,
                                   reduction="none")
            (loss.float() * m).sum().backward()

        peaks = {}
        for name, fn in (("kernels", both), ("plain", plain),
                         ("library", library)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            fn()
            torch.cuda.synchronize()
            peaks[name] = (torch.cuda.max_memory_allocated(device) - base) / 2 ** 30
        fwd_ms, bwd_ms, ms = (time_ms(fn, flush) for fn in (fwd, bwd, both))
        plain_ms = time_ms(plain, flush, iters=5)
        library_ms = time_ms(library, flush)
        fwd_b, bwd_b = ce_bytes(rows, v)
        fwd_bound, bwd_bound = (1e3 * b / PEAK_BYTES for b in (fwd_b, bwd_b))
        log(f"CE kernels B={batch} S={s}: forward {fwd_ms:.4f} ms (bound "
            f"{fwd_bound:.4f}, {fwd_bound / fwd_ms:.1%}), backward "
            f"{bwd_ms:.4f} ms (bound {bwd_bound:.4f}, "
            f"{bwd_bound / bwd_ms:.1%}), both {ms:.4f} ms (bound "
            f"{fwd_bound + bwd_bound:.4f}, bytes at "
            f"{PEAK_BYTES / 1e12:.2f} TB/s); plain {plain_ms:.4f} ms, "
            f"library (F.cross_entropy forward + backward) "
            f"{library_ms:.4f} ms; peak memory above the inputs: kernels "
            f"{peaks['kernels']:.3f} GiB, plain {peaks['plain']:.3f} GiB, "
            f"library {peaks['library']:.3f} GiB [{card}]")
        if s == 64:
            row = dict(max_rel_err=logz_err, ms=ms, fwd_ms=fwd_ms,
                       bwd_ms=bwd_ms, plain_ms=plain_ms,
                       bound_ms=fwd_bound + bwd_bound, bound_by="bytes",
                       library_ms=library_ms)
        del logits, labels, m, logz, gold, want_logz, want_gold, dl, db
        torch.cuda.empty_cache()
    return row


def bn_layers(hidden=H):
    """(C, H*W) of each block of the full-width ``resnet`` CharResNet: its
    first BatchNorm's input, and its tail's two (residual and shortcut)."""
    from realise_tpu_torch.ops.resnet import _channels

    return [(c, (16 >> i) ** 2) for i, c in enumerate(_channels("resnet",
                                                                hidden))]


def bn_bytes(rows, hidden=H):
    """Bytes the 15 BatchNorms of the CharResNet must move at ``rows`` bf16
    rows: forward, each input read once and each output written once (the
    first BatchNorm x and y, the tail x, x2 and y); backward, dy and the
    inputs read once (the ReLU's mask is a function of them) and dx
    written once."""
    fwd = bwd = 0
    for c, hw in bn_layers(hidden):
        n = rows * c * hw
        fwd += 2 * (2 * n) + 2 * (3 * n)
        bwd += 2 * (3 * n) + 2 * (5 * n)
    return fwd, bwd


def bn_kernels(device, card, row_counts=(1920, 2816, 4608)):
    """Phase 8e: ``csrc/batch_norm.cu`` over the 15 BatchNorms of the
    full-width CharResNet, bf16, weighted rows, against the plain chain on
    the card (outputs within one bf16 ulp, dx within one ulp of its
    largest value, dweight and dbias within 1e-5: the sums' orders differ),
    two calls the same bits, then the times (CUDA events, 20
    calls, L2 flushed) of the forward, the backward, both through autograd,
    the plain chain (5 calls) and F.batch_norm's (a yardstick the port
    never calls), and the kernels' device time (the profiler), against the
    bytes bound. Returns the 2816-row row."""
    import torch
    import torch.nn.functional as F

    from realise_tpu_torch.ops.kernels import batch_norm as kbn

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 60)
    row = {}
    for rows in row_counts:
        w = torch.randint(0, 6, (rows,), generator=gen, device=device).float()
        w[::12] = 0
        blocks = []
        for c, hw in bn_layers():
            side = int(hw ** 0.5)

            def rand(scale=1.0, shift=0.0):
                return (torch.randn((rows, c, side, side), generator=gen,
                                    device=device) * scale
                        + shift).to(torch.bfloat16)

            bns = [torch.nn.BatchNorm2d(c).to(device).train()
                   for _ in range(3)]
            blocks.append(dict(x=rand(2, 1), h=rand(), sc=rand(1.5, -0.5),
                               dy1=rand(), dy2=rand(), bns=bns))

        def fwd():
            out = []
            for b in blocks:
                out.append(kbn.bn_train_fwd((b["x"],), b["bns"][:1], w))
                out.append(kbn.bn_train_fwd((b["h"], b["sc"]), b["bns"][1:],
                                            w))
            return out

        fwd_out = fwd()

        def bwd():
            out = []
            for b, (one, two) in zip(blocks, zip(fwd_out[::2],
                                                 fwd_out[1::2])):
                bns = b["bns"]
                out.append(kbn.bn_train_bwd(b["dy1"], (b["x"],),
                                            (bns[0].weight,), one[1], w))
                out.append(kbn.bn_train_bwd(
                    b["dy2"], (b["h"], b["sc"]),
                    (bns[1].weight, bns[2].weight), two[1], w))
            return out

        def chain(kernel):
            """Every block's two calls forward and backward through autograd:
            the kernels' wrappers or the plain chain."""
            out = []
            for b in blocks:
                bns = b["bns"]
                xs = [b[k].detach().requires_grad_(True)
                      for k in ("x", "h", "sc")]
                for bn in bns:
                    bn.zero_grad(set_to_none=True)
                if kernel:
                    y1 = kbn.batch_norm_relu(bns[0], xs[0], w)
                    y2 = kbn.batch_norm_add_relu(bns[1], xs[1], bns[2],
                                                 xs[2], w)
                else:
                    y1 = kbn.batch_norm_relu_plain(bns[0], xs[0], w)
                    y2 = kbn.batch_norm_add_relu_plain(bns[1], xs[1], bns[2],
                                                       xs[2], w)
                torch.autograd.backward([y1, y2], [b["dy1"], b["dy2"]])
                out.append([y1, y2] + [x.grad for x in xs]
                           + [t for bn in bns for t in (bn.weight.grad,
                                                        bn.bias.grad)])
            return out

        got, want = chain(True), chain(False)
        again = chain(True)
        torch.cuda.synchronize()
        ulps, dx_rel, rel, same = 0.0, 0.0, 0.0, True
        for g_blk, w_blk, a_blk in zip(got, want, again):
            for i, (a, b) in enumerate(zip(g_blk, w_blk)):
                err = ((a.float() - b.float()).abs().max()
                       / b.float().abs().max().clamp_min(1e-30)).item()
                if i < 2:  # y1, y2: bf16, one ulp of each element
                    diff = (a.float() - b.float()).abs()
                    ulp = (torch.maximum(a.float().abs(), b.float().abs())
                           * 2.0 ** -7).clamp_min(1e-38)
                    ulps = max(ulps, (diff / ulp).masked_fill(diff == 0, 0)
                               .max().item())
                elif i < 5:  # dx, dh, dsc: bf16
                    dx_rel = max(dx_rel, err)
                else:
                    rel = max(rel, err)
            same = same and all(torch.equal(a, b)
                                for a, b in zip(g_blk, a_blk))
        del got, want, again
        log(f"BN kernels {rows} rows (15 BatchNorms, bf16, weighted): "
            f"outputs within {ulps:.2f} bf16 ulp of the plain chain's, dx "
            f"{dx_rel:.2e} of its largest value (tol 2^-7, one bf16 ulp), "
            f"dweight and dbias {rel:.2e} (tol 1e-5), two calls "
            f"{'the same bits' if same else 'DIFFERENT'}")
        if ulps > 1.0 or dx_rel > 2.0 ** -7 or rel > 1e-5 or not same:
            fail(f"BN kernels at {rows} rows: outputs, gradients or "
                 f"determinism off")

        def library():
            for b in blocks:
                bns = b["bns"]
                xs = [b[k].detach().requires_grad_(True)
                      for k in ("x", "h", "sc")]
                ys = [F.batch_norm(x, bn.running_mean, bn.running_var,
                                   bn.weight, bn.bias, training=True)
                      for x, bn in zip(xs, bns)]
                torch.autograd.backward(
                    [torch.relu(ys[0]), torch.relu(ys[1] + ys[2])],
                    [b["dy1"], b["dy2"]])

        fwd_ms = time_ms(fwd, flush)
        bwd_ms = time_ms(bwd, flush)
        # The kernels' own device time (the events above also hold the
        # card's waits for the host between the small late blocks' calls).
        parts = kernel_breakdown(lambda: (fwd(), bwd()),
                                 f"BN kernels {rows} rows", iters=3)
        device_ms = sum(ms for ms, _ in parts)
        ms = time_ms(lambda: chain(True), flush)
        plain_ms = time_ms(lambda: chain(False), flush, iters=5)
        library_ms = time_ms(library, flush)
        fwd_b, bwd_b = bn_bytes(rows)
        fwd_bound, bwd_bound = (1e3 * b / PEAK_BYTES for b in (fwd_b, bwd_b))
        bound_ms = fwd_bound + bwd_bound
        log(f"BN kernels {rows} rows: forward {fwd_ms:.4f} ms (bound "
            f"{fwd_bound:.4f}, {fwd_bound / fwd_ms:.1%}), backward "
            f"{bwd_ms:.4f} ms (bound {bwd_bound:.4f}, "
            f"{bwd_bound / bwd_ms:.1%}); the kernels' device time forward "
            f"+ backward {device_ms:.4f} ms ({device_ms / bound_ms:.2f}x "
            f"the bound); both through autograd {ms:.4f} ms "
            f"(bound {bound_ms:.4f}, {ms / bound_ms:.2f}x; bytes at "
            f"{PEAK_BYTES / 1e12:.2f} TB/s); plain chain {plain_ms:.4f} ms, "
            f"library (F.batch_norm, unweighted, + ReLU and add, forward + "
            f"backward) {library_ms:.4f} ms [{card}]")
        for part_ms, kname in parts[:12]:
            log(f"  BN kernels {rows} rows: {part_ms:.4f} ms {kname[:110]}")
        if rows == 2816:
            row = dict(max_rel_err=rel, ms=ms, fwd_ms=fwd_ms, bwd_ms=bwd_ms,
                       device_ms=device_ms,
                       plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by="bytes", library_ms=library_ms)
        del blocks, fwd_out
        torch.cuda.empty_cache()
    return row


# ------------------------------------------------------- featurizer, daemon
def check_featurizer(native_corrector, requests, card):
    """Phase 5b: the native and the Python ``featurize_raw`` give the same
    host batch for every request of phase 5; a 32-sentence request's
    featurize time both ways (median of 20)."""
    import numpy as np

    feat, native = native_corrector.featurizer, native_corrector.native
    for sents in requests:
        bucket = native_corrector._bucket_for(sents)
        a = feat.featurize_raw(sents, native=native, seq_len=bucket)
        b = feat.featurize_raw(sents, seq_len=bucket)
        if set(a) != set(b):
            fail(f"featurizer: keys {sorted(a)} != {sorted(b)}")
        for k in a:
            same = (np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray)
                    else a[k] == b[k])
            if not same:
                fail(f"featurizer: native and Python {k} differ for a request "
                     f"of {len(sents)} sentences")
    sents = requests[-1]
    bucket = native_corrector._bucket_for(sents)
    times = {}
    for label, nat in (("native", native), ("python", None)):
        runs = []
        for _ in range(20):
            t = time.perf_counter()
            feat.featurize_raw(sents, native=nat, seq_len=bucket)
            runs.append(1e3 * (time.perf_counter() - t))
        times[label] = statistics.median(runs)
    log(f"featurizer: native == Python on {len(requests)} requests; featurize "
        f"of a {len(sents)}-sentence request (bucket {bucket}): native "
        f"{times['native']:.3f} ms, Python {times['python']:.3f} ms, median "
        f"of 20 on the host [{card}]")
    return times


def load_daemon(server, requests, clients):
    """``clients`` threads, each POSTing its list of requests in turn to
    ``server``; returns ([(request, response)], latencies in ms, wall s)."""
    import http.client
    import threading

    port = server.server_address[1]
    out, lat, errors = [], [], []
    lock = threading.Lock()

    def client(mine):
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            for sents in mine:
                t = time.perf_counter()
                conn.request("POST", "/correct",
                             body=json.dumps({"sentences": sents}))
                resp = conn.getresponse()
                body = resp.read()
                dt = 1e3 * (time.perf_counter() - t)
                if resp.status != 200:
                    raise RuntimeError(f"HTTP {resp.status}: {body[:200]!r}")
                with lock:
                    out.append((sents, json.loads(body)))
                    lat.append(dt)
            conn.close()
        except Exception as e:  # reported by the caller
            with lock:
                errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(requests[c::clients],))
               for c in range(clients)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    wall = time.perf_counter() - t
    if errors or any(th.is_alive() for th in threads):
        fail(f"daemon: clients failed: {errors[:3]}")
    return out, lat, wall


def daemon(device, cfg, ckpt_root, serial, card, clients=8, distinct=96,
           rounds=60, batch_size=256):
    """Phase 5c: two daemons, ``cli/serve.serve`` on 127.0.0.1:0 each, over
    a Corrector with the native featurizer, one with the cross-request
    batcher and one without (``--no_cross_batching``), both warmed on every
    bucket; /healthz. Then four windows in turns, batcher, none, none,
    batcher: ``clients`` threads each POST ``rounds`` requests of 32
    sentences (``distinct`` requests cycled, the buckets mixed). Every
    response must equal the serial Corrector's output, the batcher must take
    fewer device steps than requests, and each serving kernel must launch 19
    times per step. Each window's sentences/s and p50/p99 request latency
    are logged, then each side's spread. Returns the batching Corrector (for
    phase 5b) and the windows' readings."""
    import http.client
    import threading

    import numpy as np

    from realise_tpu_torch.cli.serve import serve as make_server
    from realise_tpu_torch.ops.kernels import bert_block as bb
    from realise_tpu_torch.serving import Corrector
    from realise_tpu_torch.text.vocab import (REAL_VOCAB_CJK_CHARS,
                                              build_synthetic_vocab)

    layers = encoder_layers(cfg)
    vocab = build_synthetic_vocab(size=cfg.vocab_size,
                                  cjk_chars=REAL_VOCAB_CJK_CHARS)
    rng = np.random.default_rng(SEED + 3)
    spans = ((16, 28), (40, 60), (90, 120))  # buckets 32, 64, 128
    requests = [sentences(vocab, rng, 32,
                          *spans[(i % clients + i // clients) % 3])
                for i in range(distinct)]
    want = {tuple(sents): serial.correct(sents) for sents in requests}
    load = [requests[i % distinct] for i in range(clients * rounds)]
    n_sent = sum(len(r) for r in load)
    daemons, windows = {}, []
    try:
        for batching in (True, False):
            label = "cross-batching" if batching else "no_cross_batching"
            t0 = time.perf_counter()
            corrector = Corrector(ckpt_root, synthetic_vocab=True,
                                  batch_size=batch_size, device=device,
                                  native_featurizer=True,
                                  cross_request_batching=batching)
            server = make_server(corrector, "127.0.0.1", 0)  # before warmup
            thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
            thread.start()
            daemons[label] = (corrector, server, thread)
            t1 = time.perf_counter()
            corrector.warmup(all_buckets=True)
            sync(device)
            t2 = time.perf_counter()
            conn = http.client.HTTPConnection("127.0.0.1",
                                              server.server_address[1],
                                              timeout=60)
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            health = json.loads(resp.read())
            conn.close()
            if resp.status != 200 or health.get("status") != "ok":
                fail(f"daemon: /healthz answered {resp.status} {health}")
            log(f"daemon ({label}): Corrector load + tables {t1 - t0:.2f} s, "
                f"warmup of {len(corrector._buckets)} x "
                f"{len(corrector._batch_buckets)} buckets {t2 - t1:.2f} s; "
                f"/healthz {health}")
        for label in ("cross-batching", "no_cross_batching",
                      "no_cross_batching", "cross-batching"):
            corrector, server, _ = daemons[label]
            bb.attention_block.launches = bb.ffn_block.launches = 0
            steps0 = corrector.steps
            answered, lat, wall = load_daemon(server, load, clients)
            steps = corrector.steps - steps0
            launches = {"attention_block": bb.attention_block.launches,
                        "ffn_block": bb.ffn_block.launches}
            p50, p99 = np.percentile(lat, [50, 99])
            windows.append(dict(label=label, sent_s=n_sent / wall, p50=p50,
                                p99=p99, steps=steps, wall=wall))
            log(f"daemon ({label}) window {len(windows)}: {len(load)} "
                f"requests of 32 sentences from {clients} clients in "
                f"{wall:.3f} s: {n_sent / wall:.1f} sentences/s, request "
                f"latency p50 {p50:.3f} ms, p99 {p99:.3f} ms; {steps} device "
                f"steps, launches {launches} [{card}]")
            for name, n in launches.items():
                if n != layers * steps:
                    fail(f"daemon: {name} launched {n} times in {steps} "
                         f"steps, expected {layers} per step")
            if label == "cross-batching" and steps >= len(load):
                fail(f"daemon: {steps} device steps for {len(load)} "
                     f"requests: no request shared a step")
            wrong = 0
            for sents, resp in answered:
                got = [r["corrected"] for r in resp["results"]]
                ref = want[tuple(sents)]
                wrong += sum(a != b for a, b in zip(got, ref)) + abs(
                    len(got) - len(ref))
            if wrong:
                fail(f"daemon ({label}): {wrong} of {n_sent} sentences "
                     f"differ from the serial Corrector's")
    finally:
        for corrector, server, thread in daemons.values():
            server.shutdown()
            server.server_close()
            thread.join(60)
            corrector.close()
    for label in ("cross-batching", "no_cross_batching"):
        mine = [w for w in windows if w["label"] == label]
        log(f"daemon ({label}) over its {len(mine)} windows: sentences/s "
            + " / ".join(f"{w['sent_s']:.1f}" for w in mine) + ", p50 ms "
            + " / ".join(f"{w['p50']:.3f}" for w in mine) + ", p99 ms "
            + " / ".join(f"{w['p99']:.3f}" for w in mine) + ", steps "
            + " / ".join(str(w["steps"]) for w in mine) + "; all "
            f"{n_sent} responses of each window equal the serial "
            f"Corrector's [{card}]")
    ratios = [windows[0]["sent_s"] / windows[1]["sent_s"],
              windows[3]["sent_s"] / windows[2]["sent_s"]]
    log("daemon: sentences/s with the batcher over without, adjacent "
        "windows: " + " / ".join(f"{r:.3f}" for r in ratios))
    return daemons["cross-batching"][0], windows


def check_reference_weights(device, cfg, corrector, ckpt_root, requests):
    """Phase 5d: the served model's weights written as a reference
    ``pytorch_model.bin`` (``module.``-prefixed, ``resnet.`` renamed
    ``char_resent.``, the tied classifier weight beside them), read back by
    ``models.torch_import.import_checkpoint_dir``: the kernel path's logits
    are the served model's bits."""
    import torch

    from realise_tpu_torch.data.features import to_device
    from realise_tpu_torch.models.realise import (Realise,
                                                  precompute_inference_tables)
    from realise_tpu_torch.models.torch_import import import_checkpoint_dir

    sd = {}
    for k, v in corrector.model.state_dict().items():
        if k.startswith("resnet."):
            k = "char_resent." + k[len("resnet."):]
        sd["module." + k] = v.detach().cpu()
    sd["module.classifier.weight"] = sd["module.bert.embeddings.word_embeddings.weight"]
    bin_dir = os.path.join(ckpt_root, "reference")
    os.makedirs(bin_dir, exist_ok=True)
    t0 = time.perf_counter()
    torch.save(sd, os.path.join(bin_dir, "pytorch_model.bin"))
    t1 = time.perf_counter()
    with torch.device("meta"):
        model = Realise(cfg)
    model.load_state_dict(import_checkpoint_dir(bin_dir, cfg), assign=True)
    model = model.to(device).eval()
    tables = precompute_inference_tables(
        model, *corrector.featurizer.pho2_tables())
    sync(device)
    t2 = time.perf_counter()
    size = os.path.getsize(os.path.join(bin_dir, "pytorch_model.bin"))
    for sents in requests:
        host = corrector.featurizer.featurize_raw(
            sents, seq_len=corrector._bucket_for(sents))
        arrays = corrector.featurizer.device_batch(host)
        want = corrector.logits(arrays)
        with torch.inference_mode():
            got = model(to_device(arrays, device), tables=tables,
                        use_kernels=corrector.use_kernels)["logits"]
        if not torch.equal(got, want):
            fail(f"reference weights: logits differ from the served model's "
                 f"by up to {(got.float() - want.float()).abs().max():.3e}")
    log(f"reference weights: pytorch_model.bin of {size / 2 ** 20:.1f} MiB "
        f"written in {t1 - t0:.2f} s, imported + tables in {t2 - t1:.2f} s; "
        f"kernel-path logits equal to the served model's bits on "
        f"{len(requests)} requests")
    del model, tables


def check_batch_invariance(device, cfg, corrector, card):
    """Phase 5e: a served row's bits do not depend on the rows beside it,
    which the batcher's answers rest on. For each length bucket a request of
    8 or 32 rows runs alone and inside batches of 16 to 256 rows, at the
    batch's start and at its end (48 placements), and every stage's output
    for its rows (each encoder layer, the gate fusion, the output block,
    the logits, the argmax) must be the same bits."""
    import numpy as np
    import torch

    from realise_tpu_torch.data.features import to_device
    from realise_tpu_torch.text.vocab import (REAL_VOCAB_CJK_CHARS,
                                              build_synthetic_vocab)

    model = corrector.model
    vocab = build_synthetic_vocab(size=cfg.vocab_size,
                                  cjk_chars=REAL_VOCAB_CJK_CHARS)
    rng = np.random.default_rng(SEED + 5)
    batches = {}
    for (lo, hi), bucket in (((16, 28), 32), ((40, 60), 64), ((90, 120), 128)):
        host = corrector.featurizer.featurize_raw(
            sentences(vocab, rng, 256, lo, hi), seq_len=bucket)
        batches[bucket] = corrector.featurizer.device_batch(host)
    captured = []
    hooks = [layer.register_forward_hook(
        lambda mod, args, out, name=f"{stack}.{i}": captured.append((name, out)))
        for stack in ("bert", "pho_model", "output_block")
        if getattr(model, stack, None) is not None
        for i, layer in enumerate(getattr(model, stack).encoder.layer)]
    hooks.append(model.output_block.register_forward_pre_hook(
        lambda mod, args, kw: captured.append((f"{cfg.fusion} fusion",
                                                kw["inputs_embeds"])),
        with_kwargs=True))

    def run(arrays):
        captured.clear()
        with torch.inference_mode():
            logits = model(to_device(arrays, device), tables=corrector.tables,
                           use_kernels=True)["logits"]
        torch.cuda.synchronize()
        return captured[:] + [("logits", logits), ("argmax", logits.argmax(-1))]

    def placements():
        """(placements, the ones that differ, argmax tokens flipped)."""
        cases = differ = flips = 0
        for bucket, full in batches.items():
            for n in (8, 32):
                ref = run({k: v[:n] for k, v in full.items()})
                for rows in (16, 32, 64, 128, 256):
                    for at in sorted({0, rows - n}) if rows > n else ():
                        idx = np.r_[np.arange(n, n + at), np.arange(n),
                                    np.arange(n + at, rows)]
                        got = run({k: v[idx] for k, v in full.items()})
                        pos = torch.arange(at, at + n, device=device)
                        stages = []
                        for (name, a), (_, b) in zip(ref, got):
                            b = b[pos]
                            if torch.equal(a, b):
                                continue
                            if name == "argmax":
                                flips += int((a != b).sum())
                                stages.append(f"argmax {int((a != b).sum())} "
                                              f"tokens")
                            else:
                                stages.append(f"{name} "
                                              f"{float((a.float() - b.float()).abs().max()):.4g}")
                        cases += 1
                        differ += bool(stages)
                        if stages:
                            log(f"  bucket {bucket}, {n} rows in {rows} at row "
                                f"{at}: " + ", ".join(stages))
        return cases, differ, flips

    try:
        cases, differ, flips = placements()
    finally:
        for h in hooks:
            h.remove()
    log(f"batch invariance {cfg.model_type}: {differ} of {cases} placements "
        f"differ, {flips} argmax tokens flipped [{card}]")
    if differ:
        fail(f"batch invariance: {differ} of {cases} placements of a request "
             f"in a larger batch change its bits")


# ---------------------------------------------------------------- training
def train_batches(cfg, n, batch_size, seed, seq_len=128):
    """``n`` host batches of synthetic sentences (20-100 chars, the JAX
    package's bench data) featurized at ``seq_len`` (bucket 128) through the
    Featurizer (a pinyin pretraining config's: ``featurize_pho_pretrain``,
    at the config's length)."""
    from realise_tpu_torch.data.dataset import synthetic_dataset
    from realise_tpu_torch.data.features import Featurizer
    from realise_tpu_torch.text.tokenizer import WordPieceTokenizer
    from realise_tpu_torch.text.vocab import (REAL_VOCAB_CJK_CHARS,
                                              build_synthetic_vocab,
                                              vocab_to_dict)

    tok = WordPieceTokenizer(vocab_to_dict(build_synthetic_vocab(
        size=cfg.vocab_size, cjk_chars=REAL_VOCAB_CJK_CHARS)))
    feat = Featurizer(tok, cfg)
    data = synthetic_dataset(tok, num_examples=n * batch_size, min_len=20,
                             max_len=100, seed=seed)
    def featurize(examples):
        if cfg.fusion == "pretrain":
            return feat.featurize_pho_pretrain(examples)  # bucket 128: the config's
        return feat.featurize(examples, seq_len=seq_len)

    return [feat.device_batch(featurize(data[i * batch_size:(i + 1) * batch_size]))
            for i in range(n)]


_GLYPHS = {}


def seeded_model(cfg, seed):
    """Seeded weights (``build_model``: a pretraining stage too), the
    procedural glyph table of the synthetic vocab (non-CJK tokens share the
    zero image, as in the real vocab; built once per font set) and its
    pinyin tables: the tables the training CLI installs, as the preset has
    them."""
    import torch

    from realise_tpu_torch.data.features import Featurizer
    from realise_tpu_torch.models.realise import build_model
    from realise_tpu_torch.text.glyphs import build_glyph_table
    from realise_tpu_torch.text.tokenizer import WordPieceTokenizer
    from realise_tpu_torch.text.vocab import (REAL_VOCAB_CJK_CHARS,
                                              build_synthetic_vocab,
                                              vocab_to_dict)

    vocab = build_synthetic_vocab(size=cfg.vocab_size,
                                  cjk_chars=REAL_VOCAB_CJK_CHARS)
    model = build_model(cfg, generator=torch.Generator().manual_seed(seed))
    if cfg.with_res:
        fonts = (cfg.num_fonts, cfg.use_traditional_font)
        if fonts not in _GLYPHS:
            _GLYPHS[fonts] = build_glyph_table(
                vocab, num_fonts=cfg.num_fonts,
                use_traditional_font=cfg.use_traditional_font)
        model.install_glyphs(_GLYPHS[fonts])
    if cfg.pho_encoder == "pho2":
        feat = Featurizer(WordPieceTokenizer(vocab_to_dict(vocab)), cfg)
        model.install_pho_vocab_tables(*feat.pho2_tables())
    return model


def step_split(trainer, batch, label, card):
    """A warm-up step of ``trainer`` on ``batch`` (cuDNN plans its
    convolutions for new shapes on the host), one step with its parts timed,
    then one under the profiler; returns {'parts': {part: ms}, 'step_ms',
    'host_ms', 'kernel_ms', 'peak_gib', 'loss'} and logs them with the rows
    each stream ran (``utils/profiler.SpanRecorder`` over the model's and
    the Trainer's spans)."""
    import numpy as np
    import torch

    from realise_tpu_torch.utils.profiler import SpanRecorder

    model = trainer.model
    if "char_idx" in batch:  # res-pretrain: (N,) chars, convolved as they come
        b, s = len(batch["char_idx"]), 1
    else:
        b, s = np.asarray(batch["src_idx"]).shape
    conv_rows = gru_rows = "none"
    if trainer.per_token_streams or "char_idx" in batch:
        conv_rows = f"{b * s}" if model.cfg.with_res else "none"
        gru_rows = f"{b * s}" if model.cfg.with_pho else "none"
    else:
        if model.cfg.with_res:
            rows = model.conv_rows(batch["src_idx"])["res_rows"]
            conv_rows = f"{len(np.unique(rows))} (bucket {len(rows)})"
        if model.pho_uniq_idx is not None:
            gru_rows = f"{min(model.pho_uniq_idx.shape[0], b * s)}"
    device = next(model.parameters()).device
    trainer.train_step(batch)
    split, plain_span = SpanRecorder(device), model.span
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    model.span = split.span
    t = time.perf_counter()
    try:
        with split.span("step"):
            loss = float(trainer.train_step(batch))
    finally:
        model.span = plain_span
    host_ms = 1e3 * (time.perf_counter() - t)
    parts = {name: tot["device_ms"] for name, tot in split.totals().items()}
    step_ms = parts.pop("step")
    # The encoder's backward spans lie inside 'backward'.
    top_ms = sum(ms for name, ms in parts.items()
                 if not name.startswith("encoder."))
    kernel_ms = sum(ms for ms, _ in kernel_breakdown(
        lambda: trainer.train_step(batch), f"split {label} step B={b} S={s}",
        iters=1))
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    log(f"split {label} B={b}: conv rows {conv_rows}, GRU rows {gru_rows} "
        f"(of {b * s} token slots); step {step_ms:.3f} ms on the device "
        f"(events), {host_ms:.3f} ms on the host clock, {b / host_ms * 1e3:.1f} "
        f"sentences/s; profiled step {kernel_ms:.3f} ms of kernels; peak "
        f"memory {peak:.2f} GiB; loss {loss:.6f} [{card}]")
    log(f"  split {label} B={b}: " + ", ".join(
        f"{name} {ms:.3f}" for name, ms in parts.items())
        + f", rest {step_ms - top_ms:.3f} ms")
    return dict(parts=parts, step_ms=step_ms, host_ms=host_ms,
                kernel_ms=kernel_ms, peak_gib=peak, loss=loss,
                conv_rows=conv_rows, gru_rows=gru_rows)


def train(device, cfg, card):
    """Phase 8: the Trainer at full width in bf16 on the factorized streams;
    then the per-stream split of a B=32 and a B=256 step on the factorized
    and on the per-token path. Returns (the launches of the train kernels,
    of the update kernels (``clip_adamw``, the two together), of the CE
    kernels (``masked_ce``, forward and backward together) and of the
    BatchNorm kernels (``batch_norm``, the BatchNorms through the forward
    and through the backward) over the main run, the trainer)."""
    import math

    import torch

    from realise_tpu_torch.ops.kernels import adamw as kadamw
    from realise_tpu_torch.ops.kernels import batch_norm as kbn
    from realise_tpu_torch.ops.kernels import bert_block_train as tbt
    from realise_tpu_torch.ops.kernels import masked_ce as kce
    from realise_tpu_torch.training.trainer import Trainer
    from realise_tpu_torch.utils.profiler import SpanRecorder

    layers = encoder_layers(cfg)
    t0 = time.perf_counter()
    model = seeded_model(cfg, SEED)
    small = train_batches(cfg, 6, 32, SEED)
    large = train_batches(cfg, 2, 256, SEED + 1)
    trainer = Trainer(cfg, model, learning_rate=5e-5, warmup_steps=2,
                      total_steps=100, weight_decay=0.01, max_grad_norm=1.0,
                      device=device, seed=SEED)
    sync(device)
    log(f"train: model, glyphs and {6 * 32 + 2 * 256} sentences ready in "
        f"{time.perf_counter() - t0:.2f} s; {cfg.dtype}, dropout "
        f"{cfg.hidden_dropout_prob}/{cfg.attention_probs_dropout_prob}, "
        f"use_kernels={trainer.use_kernels}, {layers} encoder layers, "
        f"{sum(p.numel() for p in model.parameters())} parameters; "
        f"{model.res_conv_rows} distinct glyph rows and "
        f"{model.pho_uniq_idx.shape[0]} distinct pinyin rows of "
        f"{cfg.vocab_size} tokens")
    if not trainer.use_kernels:
        fail("the Trainer did not turn the kernels on for CUDA")
    # The update kernels, then the CE kernels: once each a step; then the
    # BatchNorm kernels: each BatchNorm of the CharResNet once a step.
    updates = (kadamw.global_norm_partials, kadamw.adamw_update,
               kce.masked_ce_fwd, kce.masked_ce_bwd, kbn.bn_train_fwd,
               kbn.bn_train_bwd)
    bns = sum(isinstance(m, torch.nn.BatchNorm2d)
              for m in model.resnet.modules())
    want_update = [1, 1, 1, 1, bns, bns]
    for fn in tuple(tbt.KERNEL_WRAPPERS) + updates:
        fn.launches = 0
    for b, batches in ((32, small), (256, large)):
        torch.cuda.reset_peak_memory_stats(device)
        times = []
        for i, batch in enumerate(batches):
            before = [fn.launches for fn in tbt.KERNEL_WRAPPERS]
            before_update = [fn.launches for fn in updates]
            sync(device)
            t = time.perf_counter()
            loss = float(trainer.train_step(batch))  # reads back: synchronised
            dt = time.perf_counter() - t
            per_step = [fn.launches - n for fn, n in zip(tbt.KERNEL_WRAPPERS,
                                                         before)]
            per_update = [fn.launches - n for fn, n in zip(updates,
                                                           before_update)]
            warm = b == 32 and i == 0
            log(f"train: B={b} step {trainer.step}{' (warm-up)' if warm else ''}"
                f": loss {loss:.6f}, {1e3 * dt:.3f} ms, {b / dt:.1f} sentences/s,"
                f" launches {per_step}, update and CE {per_update}")
            if not math.isfinite(loss):
                fail(f"non-finite loss at step {trainer.step}")
            if per_step != [layers] * 4:
                fail(f"train kernels launched {per_step} times in a step, "
                     f"expected {layers} each")
            if per_update != want_update:
                fail(f"update, CE and BatchNorm kernels launched "
                     f"{per_update} times in a step, expected {want_update}")
            if not warm:
                times.append(dt)
        peak = torch.cuda.max_memory_allocated(device)
        log(f"train: B={b} over {len(times)} timed steps: mean step "
            f"{1e3 * sum(times) / len(times):.3f} ms, "
            f"{b * len(times) / sum(times):.1f} sentences/s, peak memory "
            f"{peak / 2 ** 30:.2f} GiB [{card}]")
    # Where a B=256 step's time goes: device time by kernel name over one
    # profiled step (after the profiler's warm-up step; both are steps of
    # the run, checked like the others).
    before = [fn.launches for fn in tuple(tbt.KERNEL_WRAPPERS) + updates]
    t = time.perf_counter()
    parts = kernel_breakdown(lambda: trainer.train_step(large[-1]),
                             "train step B=256", iters=1)
    dt = (time.perf_counter() - t) / 2
    want = [2 * layers] * 4 + [2] * 4 + [2 * bns] * 2
    if [fn.launches - n for fn, n in zip(tuple(tbt.KERNEL_WRAPPERS) + updates,
                                         before)] != want:
        fail("the profiled steps missed a train, update, CE or BatchNorm "
             "kernel launch")
    busy = sum(ms for ms, _ in parts)
    log(f"train: profiled B=256 step: {busy:.3f} ms of kernels in "
        f"{1e3 * dt:.3f} ms on the host clock (profiler on), "
        f"{len(parts)} kernel names")
    for part_ms, kname in parts[:16]:
        log(f"  profile train step: {part_ms:.4f} ms {kname[:100]}")
    plain_span, model.span = model.span, SpanRecorder(device).span
    try:
        owners = kernel_owners(lambda: trainer.train_step(large[-1]),
                               ELEMENTWISE_BROADCAST)
    finally:
        model.span = plain_span
    log(f"train: the B=256 step's {ELEMENTWISE_BROADCAST}> kernels, "
        f"{sum(ms for ms, _ in owners):.3f} ms in {len(owners)} places; "
        f"by span or autograd node | op | launching op | its input shapes:")
    for part_ms, owner in owners[:12]:
        log(f"  {part_ms:.4f} ms {owner}")
    launches = {fn.__name__: fn.launches for fn in tbt.KERNEL_WRAPPERS}
    launches["clip_adamw"] = sum(fn.launches for fn in updates[:2])
    launches["masked_ce"] = sum(fn.launches for fn in updates[2:4])
    launches["batch_norm"] = sum(fn.launches for fn in updates[4:])

    # The split of a step by stream, CUDA events around each part, on the
    # factorized path and on the per-token one, same model and batches.
    splits = {}
    for path in ("factorized", "per_token"):
        trainer.per_token_streams = path == "per_token"
        for b, batch in ((32, small[-1]), (256, large[-1])):
            splits[path, b] = step_split(trainer, batch, path, card)
    trainer.per_token_streams = False
    for b in (32, 256):
        fac, tok = splits["factorized", b], splits["per_token", b]
        log(f"split B={b}, per-token → factorized: " + ", ".join(
            f"{name} {tok['parts'][name]:.3f} → {fac['parts'][name]:.3f}"
            for name in tok["parts"])
            + f"; step {tok['step_ms']:.3f} → {fac['step_ms']:.3f} ms, kernels "
            f"{tok['kernel_ms']:.3f} → {fac['kernel_ms']:.3f} ms, host "
            f"{tok['host_ms']:.3f} → {fac['host_ms']:.3f} ms, peak "
            f"{tok['peak_gib']:.2f} → {fac['peak_gib']:.2f} GiB [{card}]")
    return launches, trainer


def check_train_paths(device, cfg):
    """The kernel path against the plain path in float32 at dropout 0 on one
    B=32 batch: loss sum and every gradient."""
    import torch

    cfg = cfg.replace(dtype="float32", hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    model = seeded_model(cfg, SEED + 2).to(device).train()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    batch = {k: torch.as_tensor(v, dtype=torch.long, device=device)
             for k, v in train_batches(cfg, 1, 32, SEED + 3)[0].items()}
    results = []
    for use_kernels in (True, False):
        model.load_state_dict(state)
        model.zero_grad(set_to_none=True)
        out = model(batch, use_kernels=use_kernels,
                    generator=torch.Generator().manual_seed(0))
        out["loss_sum"].backward()
        results.append((out["loss_sum"].item(),
                        {n: p.grad.clone() for n, p in model.named_parameters()}))
    (loss_k, grads_k), (loss_p, grads_p) = results
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    floor = 1e-4 * max(g.abs().max().item() for g in grads_p.values())
    worst_name, worst = "", 0.0
    for n, g in grads_p.items():
        err = ((grads_k[n] - g).abs().max().item()
               / max(g.abs().max().item(), floor))
        if err > worst:
            worst_name, worst = n, err
    log(f"train paths {cfg.model_type} f32 dropout 0 B=32: loss_sum kernel "
        f"{loss_k:.6f} plain "
        f"{loss_p:.6f} (relative {loss_err:.2e}, tol {PATH_LOSS_REL}); worst "
        f"gradient {worst_name} relative {worst:.2e} (tol {PATH_GRAD_REL}) "
        f"over {len(grads_p)} tensors")
    if loss_err > PATH_LOSS_REL or worst > PATH_GRAD_REL:
        fail("the training kernel path disagrees with the plain path")


def bn_state(model):
    return {n: b.clone() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def check_factorized_paths(device, cfg):
    """The factorized streams (the Trainer's route: the conv over the
    batch's distinct glyph rows, the GRU over the distinct pinyin rows)
    against the per-token streams in float32 at dropout 0 on one B=32 batch,
    kernels on: the loss sum, every gradient and the BatchNorm running
    statistics after the step."""
    import numpy as np
    import torch

    from realise_tpu_torch.data.features import to_device

    cfg = cfg.replace(dtype="float32", hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    model = seeded_model(cfg, SEED + 4).to(device).train()
    start = bn_state(model)
    host = train_batches(cfg, 1, 32, SEED + 5)[0]
    results = []
    for per_token in (True, False):
        with torch.no_grad():
            for n, b in model.named_buffers():
                if n in start:
                    b.copy_(start[n])
        model.zero_grad(set_to_none=True)
        batch = dict(host)
        if not per_token:
            batch.update(model.conv_rows(batch["src_idx"]))
        out = model(to_device(batch, device), use_kernels=True,
                    generator=torch.Generator().manual_seed(0),
                    per_token=per_token)
        out["loss_sum"].backward()
        results.append((out["loss_sum"].item(),
                        {n: p.grad.clone() for n, p in model.named_parameters()},
                        bn_state(model)))
    (loss_t, grads_t, bn_t), (loss_f, grads_f, bn_f) = results
    loss_err = abs(loss_f - loss_t) / abs(loss_t)
    floor = 1e-4 * max(g.abs().max().item() for g in grads_t.values())
    worst_name, worst = "", 0.0
    for n, g in grads_t.items():
        err = ((grads_f[n] - g).abs().max().item()
               / max(g.abs().max().item(), floor))
        if err > worst:
            worst_name, worst = n, err
    bn_err = max((bn_f[n] - b).abs().max().item() for n, b in bn_t.items())
    log(f"factorized vs per-token f32 dropout 0 B=32 ({len(host['src_idx'].ravel())} "
        f"token slots, {len(np.unique(host['src_idx']))} distinct tokens, "
        f"{len(model.conv_rows(host['src_idx'])['res_rows'])} conv rows, {model.pho_uniq_idx.shape[0]} GRU rows): loss_sum "
        f"{loss_f:.6f} / {loss_t:.6f} (relative {loss_err:.2e}, tol "
        f"{PATH_LOSS_REL}); worst gradient {worst_name} relative {worst:.2e} "
        f"(tol {PATH_GRAD_REL}) over {len(grads_t)} tensors; BN running "
        f"statistics max diff {bn_err:.2e} (tol {FACTOR_BN_TOL})")
    if loss_err > PATH_LOSS_REL or worst > PATH_GRAD_REL or bn_err > FACTOR_BN_TOL:
        fail("the factorized streams disagree with the per-token streams")


def check_stream_determinism(trainer, batch, label="B=32"):
    """Two bf16 forward + backward calls of the trained model on one batch
    (B=32 in phase 8, ``label`` names its shape), the Trainer's route and
    one dropout seed: every gradient, those of the pinyin embeddings, the
    GRU and the CharResNet among them, must be the same bits."""
    import torch

    from realise_tpu_torch.data.features import to_device

    model = trainer.model.train()
    start = bn_state(model)
    batch = dict(batch)
    batch.update(model.conv_rows(batch["src_idx"]))
    batch = to_device(batch, next(model.parameters()).device)
    grads = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        out = model(batch, use_kernels=True,
                    generator=torch.Generator().manual_seed(7))
        out["loss_sum"].backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    with torch.no_grad():
        for n, b in model.named_buffers():
            if n in start:
                b.copy_(start[n])
    model.zero_grad(set_to_none=True)
    differ = [n for n in grads[0] if not torch.equal(grads[0][n], grads[1][n])]
    streams = [n for n in grads[0]
               if n.startswith(("pho_embeddings", "pho_gru.", "resnet."))]
    log(f"determinism bf16 {label}: two backward calls give the same gradient "
        f"bits for {len(grads[0]) - len(differ)} of {len(grads[0])} tensors, "
        f"{len([n for n in streams if n not in differ])} of the "
        f"{len(streams)} stream tensors (pho_embeddings, pho_gru.*, resnet.*)"
        f"{'; differ: ' + ', '.join(differ[:8]) if differ else ''}")
    if differ:
        fail(f"gradients differ between two calls: {differ[:8]}")


def evaluate(device, cfg, trainer, card):
    """Phase 9: eval and scoring. The trained model saved as a port
    checkpoint and loaded as cli/test loads it; 1024 synthetic dev sentences
    (20-100 chars) scored by ``cli.common.evaluate_model`` with batch 32 on
    the (V, H) stream tables and the serving kernels; every file written,
    every metric finite, 19 launches of each serving kernel per batch; on
    one batch the kernel path's argmax against the plain path's."""
    import math

    import torch

    from realise_tpu_torch.cli.common import evaluate_model
    from realise_tpu_torch.data.dataset import synthetic_dataset
    from realise_tpu_torch.data.features import Featurizer, to_device
    from realise_tpu_torch.models.realise import Realise
    from realise_tpu_torch.ops.kernels import bert_block as bb
    from realise_tpu_torch.text.tokenizer import WordPieceTokenizer
    from realise_tpu_torch.text.vocab import (REAL_VOCAB_CJK_CHARS,
                                              build_synthetic_vocab,
                                              vocab_to_dict)
    from realise_tpu_torch.training.checkpoint import (load_checkpoint,
                                                       save_checkpoint)
    from realise_tpu_torch.training.trainer import Trainer

    n_sent, batch_size = 1024, 32
    layers = encoder_layers(cfg)
    tok = WordPieceTokenizer(vocab_to_dict(build_synthetic_vocab(
        size=cfg.vocab_size, cjk_chars=REAL_VOCAB_CJK_CHARS)))
    feat = Featurizer(tok, cfg)
    data = synthetic_dataset(tok, num_examples=n_sent, min_len=20, max_len=100,
                             seed=SEED + 7)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ckpt = save_checkpoint(tmp, trainer.step, trainer.model.state_dict(), cfg)
        with torch.device("meta"):
            model = Realise(cfg)
        model.load_state_dict(load_checkpoint(ckpt), assign=True)
        model.install_pho_vocab_tables(*feat.pho2_tables())
        ev = Trainer(cfg, model, device=device)
        sync(device)
        t1 = time.perf_counter()
        build_s = []
        prepare = ev.prepare_eval_tables

        def timed_prepare(featurizer):
            sync(device)
            t = time.perf_counter()
            prepare(featurizer)
            sync(device)
            build_s.append(time.perf_counter() - t)

        ev.prepare_eval_tables = timed_prepare
        bb.attention_block.launches = bb.ffn_block.launches = 0
        t2 = time.perf_counter()
        res = evaluate_model(ev, data, feat, tok, tmp, prefix="dev",
                             batch_size=batch_size)
        dt = time.perf_counter() - t2
        launches = {"attention_block": bb.attention_block.launches,
                    "ffn_block": bb.ffn_block.launches}
        files = {name: os.path.getsize(os.path.join(tmp, "dev", name))
                 for name in os.listdir(os.path.join(tmp, "dev"))}
    steps = -(-n_sent // batch_size)
    log(f"eval: checkpoint save + load + tables of the featurizer "
        f"{t1 - t0:.2f} s; {n_sent} sentences in {dt:.3f} s "
        f"({n_sent / dt:.1f} sentences/s, the (V, H) table build "
        f"{build_s[0]:.3f} s of it; {n_sent / (dt - build_s[0]):.1f} "
        f"sentences/s without it), use_kernels={ev.use_kernels}, launches "
        f"{launches} in {steps} batches [{card}]")
    log("eval: " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(res.items()))
        + "; files " + ", ".join(f"{k} {v} B" for k, v in sorted(files.items())))
    if not ev.use_kernels:
        fail("the eval Trainer did not turn the kernels on for CUDA")
    missing = [f for f in ("preds.txt", "labels.txt", "gold.lbl.tsv")
               if not files.get(f)]
    if missing or not all(math.isfinite(v) for v in res.values()):
        fail(f"eval: files missing or empty {missing}, metrics {res}")
    for name, n in launches.items():
        if n != layers * steps:
            fail(f"eval: {name} launched {n} times in {steps} batches")
    host = feat.featurize(data[:batch_size])
    batch = to_device(feat.device_batch(host), device)
    with torch.inference_mode():
        got = ev.model(batch, tables=ev._eval_tables, use_kernels=True)["logits"]
        want = ev.model(batch, tables=ev._eval_tables, use_kernels=False)["logits"]
    check_argmax("eval", got, want, batch["masks"].bool(), logits_within=False)
    return launches


def resume(device, cfg, card, steps=4, batch_size=32):
    """Phase 10: resumed training at full width (bf16, dropout 0.1, B=32,
    factorized streams, kernels on). ``steps`` steps straight against half
    of them, ``save_checkpoint`` with the trainer's state, a new Trainer
    (other initial weights, other generator seed) loaded from it and the
    other half: the loss trace and every parameter, buffer and optimizer
    tensor are the same bits. Then ``cli/train`` on the card: 2 steps, then
    ``--resume`` to 4 with ``--do_eval --remove_unused_ckpts
    --num_save_ckpts 1``."""
    import copy

    import torch

    from realise_tpu_torch.cli import train as cli_train
    from realise_tpu_torch.training.checkpoint import (list_checkpoints,
                                                       load_checkpoint,
                                                       load_trainer_state,
                                                       save_checkpoint)
    from realise_tpu_torch.training.trainer import Trainer

    base = seeded_model(cfg, SEED + 20)
    batches = train_batches(cfg, steps, batch_size, SEED + 21)
    kw = dict(learning_rate=5e-5, warmup_steps=2, total_steps=100,
              weight_decay=0.01, max_grad_norm=1.0, device=device, seed=SEED)
    straight = Trainer(cfg, copy.deepcopy(base), **kw)
    want = [float(straight.train_step(b)) for b in batches]
    want_state = straight.model.state_dict()
    want_opt = straight.optimizer.state_dict()

    half = steps // 2
    first = Trainer(cfg, copy.deepcopy(base), **kw)
    got = [float(first.train_step(b)) for b in batches[:half]]
    with tempfile.TemporaryDirectory() as tmp:
        sync(device)
        t0 = time.perf_counter()
        path = save_checkpoint(tmp, first.step, first.model.state_dict(), cfg,
                               trainer_state=first.state_dict(),
                               training_args={"phase": "resume"})
        t1 = time.perf_counter()
        sizes = {f: os.path.getsize(os.path.join(path, f))
                 for f in sorted(os.listdir(path))}
        del first
        other = copy.deepcopy(base)
        with torch.no_grad():
            for p in other.parameters():
                p.add_(0.01)
        second = Trainer(cfg, other, **dict(kw, seed=SEED + 1))
        sync(device)
        t2 = time.perf_counter()
        state = load_trainer_state(path)
        second.model.load_state_dict(load_checkpoint(path))
        second.load_state_dict(state)
        sync(device)
        t3 = time.perf_counter()
    got += [float(second.train_step(b)) for b in batches[half:]]
    log(f"resume: checkpoint at step {half}: " + ", ".join(
        f"{f} {n / 2 ** 20:.1f} MiB" for f, n in sizes.items())
        + f"; save {t1 - t0:.3f} s, load into a new Trainer {t3 - t2:.3f} s "
        f"[{card}]")
    log(f"resume: losses straight {want}, resumed {got}")
    if got != want:
        fail("resume: the resumed loss trace differs from the straight run's")
    differ = [k for k, v in second.model.state_dict().items()
              if not torch.equal(v, want_state[k])]
    opt = second.optimizer.state_dict()
    differ += [f"optimizer {i}.{k}" for i, st in want_opt["state"].items()
               for k, v in st.items()
               if not torch.equal(opt["state"][i][k], v)]
    if differ or second.step != steps:
        fail(f"resume: step {second.step}; tensors differ from the straight "
             f"run's: {differ[:8]}")
    log(f"resume: {steps} steps, loss trace and all {len(want_state)} model "
        f"tensors and {sum(len(s) for s in want_opt['state'].values())} "
        f"optimizer tensors equal the straight run's bits")
    del straight, second, base

    # cli/train on the card, the published widths, a small batch.
    with tempfile.TemporaryDirectory() as out:
        argv = ["--synthetic", "--dtype", "bfloat16", "--output_dir", out,
                "--per_device_train_batch_size", "8", "--save_steps", "2",
                "--eval_batch_size", "32", "--seed", str(SEED)]
        t0 = time.perf_counter()
        if cli_train.main(argv + ["--max_steps", "2"]) != 0:
            fail("resume: cli/train --max_steps 2 failed")
        t1 = time.perf_counter()
        if cli_train.main(argv + ["--max_steps", "4", "--resume", "--do_train",
                                  "--do_eval", "--remove_unused_ckpts",
                                  "--num_save_ckpts", "1"]) != 0:
            fail("resume: cli/train --resume failed")
        t2 = time.perf_counter()
        with open(os.path.join(out, "dev_results.json")) as f:
            scores = json.load(f)
        kept = list_checkpoints(out)
        best = max(scores, key=lambda s: scores[s]["sent-detect-f1"])
        kept_step = (load_trainer_state(kept[0][1])["step"]
                     if len(kept) == 1 else None)
    log(f"resume: cli/train 2 steps {t1 - t0:.2f} s, --resume to 4 with "
        f"--do_eval --remove_unused_ckpts {t2 - t1:.2f} s; dev scores of "
        f"checkpoints {sorted(scores, key=int)}, kept {[s for s, _ in kept]}")
    if sorted(scores, key=int) != ["2", "4"]:
        fail(f"resume: dev scores of {sorted(scores)}, expected 2 and 4")
    if [str(s) for s, _ in kept] != [best] or kept_step != int(best):
        fail(f"resume: kept {kept}, expected only the best, {best}")


# ------------------------------------------------------------ the presets
ARCH3 = "bert-pho2-res-arch3"
# Phase 11's configs: (name, model_type, the overrides cli/common.build_config
# sets for the flags), every fine-tuning preset but arch3 (phases 5-10's)
# and the four ablation switches on arch3.
PRESETS = (
    ("bert", "bert", {}),
    ("bert-pho1", "bert-pho1", {}),
    ("bert-pho2", "bert-pho2", {}),
    ("bert-pho1-res", "bert-pho1-res", {}),
    ("bert-pho2-res", "bert-pho2-res", {}),
    ("bert-pho2-res-arch2", "bert-pho2-res-arch2", {}),
    ("bert-pho2-res-arch3-mlm", "bert-pho2-res-arch3-mlm", {}),
    ("bert-pho2-res-arch4", "bert-pho2-res-arch4", {}),
    ("arch3 --with_pho no", ARCH3, {"pho_encoder": "none"}),
    ("arch3 --with_res no", ARCH3, {"res_encoder": "none"}),
    ("arch3 --fusion sum", ARCH3, {"fusion": "sum"}),
    ("arch3 --image_model_type 1", ARCH3, {"res_encoder": "resnet1"}),
)
# The configs whose served rows phase 11 holds to phase 5e's batch
# invariance: the integrate products of merged and concat fusion and the
# MLM head's transform are plain bf16 products outside the kernels.
INVARIANCE = ("bert-pho2-res", "bert-pho2-res-arch2", "bert-pho2-res-arch3-mlm")
# The float32 kernel-vs-plain training check of phase 8, on these.
F32_PATHS = ("bert-pho2-res", "bert-pho2-res-arch3-mlm")
# show_gate's TSV, kernel path against plain path, bf16: each gate within
# 8 bf16 ulps at [0.5, 1) (the gate logits come through every encoder
# layer, rounded differently on the two paths, PERF.md §6).
GATE_TOL = 2.0 ** -5


def encoder_layers(cfg) -> int:
    """The encoder layers a step runs: semantic + pho + output block."""
    return (cfg.num_hidden_layers + (cfg.pho_num_layers if cfg.with_pho else 0)
            + cfg.out_num_layers)


def preset_config(model_type, overrides, **kw):
    from realise_tpu_torch.config import config_for

    return config_for(model_type, vocab_size=21128, dtype="bfloat16",
                      **dict(overrides, **kw))


def check_show_gate(device, ckpt_root, name, card):
    """cli/show_gate on the card on a checkpoint: the kernel path's TSV
    against --no_kernels's, the same rows and each gate within GATE_TOL."""
    import numpy as np

    from realise_tpu_torch.cli import show_gate

    tsv = {}
    for kernels in (True, False):
        out = os.path.join(ckpt_root, f"gate_{kernels}.tsv")
        t = time.perf_counter()
        if show_gate.main(["--ckpt_dir", ckpt_root, "--synthetic",
                           "--output", out]
                          + ([] if kernels else ["--no_kernels"])) != 0:
            fail(f"show_gate {name} failed")
        lines = open(out, encoding="utf-8").read().splitlines()
        tsv[kernels] = (lines[0], [ln.split("\t")[:3] for ln in lines[1:]],
                        np.asarray([[float(x) for x in ln.split("\t")[3:]]
                                    for ln in lines[1:]]),
                        time.perf_counter() - t)
    (head_k, rows_k, g_k, dt_k), (head_p, rows_p, g_p, dt_p) = tsv[True], tsv[False]
    diff = float(np.abs(g_k - g_p).max()) if g_k.size else float("nan")
    log(f"show_gate {name}: columns {head_k.split(chr(9))[3:]}, {len(rows_k)} "
        f"rows, kernel vs plain path gates max diff {diff:.4g} (tol "
        f"{GATE_TOL}); {dt_k:.2f} s with the kernels, {dt_p:.2f} s plain "
        f"[{card}]")
    if (head_k != head_p or rows_k != rows_p or not rows_k
            or not diff <= GATE_TOL):
        fail(f"show_gate {name}: the kernel path's TSV disagrees with the "
             f"plain path's")


def presets(device, card):
    """Phase 11: every config of PRESETS at full width in bf16 at its
    published dropout, seeded random weights, the procedural glyphs: the
    Trainer's 2 steps at B=32 on the factorized streams (each encoder layer
    through the four train kernels each step, finite losses), the split of
    a B=32 and a B=256 step (host clock, kernel time, peak memory); the
    weights saved as a port checkpoint, loaded by the Corrector and served
    in requests of 8 and 32 sentences (each layer through both serving
    kernels, the kernel path's argmax against the plain path's), the
    sentences/s of 32-sentence requests; phase 5e on INVARIANCE's configs,
    cli/show_gate on arch3's and the --with_pho no checkpoint. Then the
    float32 kernel-vs-plain training check on F32_PATHS. Returns the
    kernels' launches over the phase and the per-config rows."""
    import math

    import numpy as np
    import torch

    from realise_tpu_torch.data.features import to_device
    from realise_tpu_torch.ops.kernels import bert_block as bb
    from realise_tpu_torch.ops.kernels import bert_block_train as tbt
    from realise_tpu_torch.serving import Corrector
    from realise_tpu_torch.text.vocab import (REAL_VOCAB_CJK_CHARS,
                                              build_synthetic_vocab)
    from realise_tpu_torch.training.checkpoint import save_checkpoint
    from realise_tpu_torch.training.trainer import Trainer

    serve_requests, timed_requests = ((8, 40, 60), (32, 90, 120)), 8
    serving = (bb.attention_block, bb.ffn_block)
    wrappers = serving + tuple(tbt.KERNEL_WRAPPERS)
    for fn in wrappers:
        fn.launches = 0
    # The launches of the phase's own path (the counted train steps and
    # requests), without those of the checks and the timing runs.
    launches = dict.fromkeys((fn.__name__ for fn in wrappers), 0)
    vocab = build_synthetic_vocab(size=21128, cjk_chars=REAL_VOCAB_CJK_CHARS)
    rows = []
    configs = list(PRESETS) + [("arch3 (gates)", ARCH3, {})]
    for k, (name, model_type, overrides) in enumerate(configs):
        cfg = preset_config(model_type, overrides)
        layers = encoder_layers(cfg)
        gate_only = name == "arch3 (gates)"  # show_gate's arch3 checkpoint
        t0 = time.perf_counter()
        model = seeded_model(cfg, SEED + 100 + k)
        params = sum(p.numel() for p in model.parameters())
        row = dict(name=name, layers=layers, params=params)
        with tempfile.TemporaryDirectory() as ckpt_root:
            if not gate_only:
                small = train_batches(cfg, 2, 32, SEED + 200 + k)
                trainer = Trainer(cfg, model, learning_rate=5e-5,
                                  warmup_steps=2, total_steps=100,
                                  weight_decay=0.01, max_grad_norm=1.0,
                                  device=device, seed=SEED)
                if not trainer.use_kernels:
                    fail(f"presets {name}: the Trainer did not turn the "
                         f"kernels on")
                losses = []
                for batch in small:
                    before = [fn.launches for fn in tbt.KERNEL_WRAPPERS]
                    losses.append(float(trainer.train_step(batch)))
                    per_step = [fn.launches - n for fn, n in
                                zip(tbt.KERNEL_WRAPPERS, before)]
                    if per_step != [layers] * 4:
                        fail(f"presets {name}: train kernels launched "
                             f"{per_step} times in a step, expected {layers} "
                             f"each")
                    for fn, n in zip(tbt.KERNEL_WRAPPERS, per_step):
                        launches[fn.__name__] += n
                if not all(math.isfinite(x) for x in losses):
                    fail(f"presets {name}: non-finite losses {losses}")
                row["losses"] = losses
                row["b32"] = step_split(trainer, small[-1], name, card)
                row["b256"] = step_split(
                    trainer, train_batches(cfg, 1, 256, SEED + 300 + k)[0],
                    name, card)
                model = trainer.model
                del trainer
            save_checkpoint(ckpt_root, 0, model.state_dict(), cfg)
            del model
            torch.cuda.empty_cache()
            if cfg.fusion in ("gate", "softmax_gate") and (
                    gate_only or not cfg.with_pho):
                check_show_gate(device, ckpt_root, name, card)
            if gate_only:
                log(f"presets {name}: init+save "
                    f"{time.perf_counter() - t0:.2f} s")
                continue
            corrector = Corrector(ckpt_root, synthetic_vocab=True,
                                  batch_size=32, device=device)
            if not corrector.use_kernels:
                fail(f"presets {name}: the Corrector did not turn the "
                     f"kernels on")
            row["tables"] = sorted(corrector.tables)
            rng = np.random.default_rng(SEED + 400 + k)
            requests = [sentences(vocab, rng, n, lo, hi)
                        for n, lo, hi in serve_requests]
            for sents in requests:  # warm
                corrector.correct(sents)
            before = [fn.launches for fn in serving]
            steps0 = corrector.steps
            for sents in requests:
                out = corrector.correct(sents)
                if [len(o) for o in out] != [len(x) for x in sents]:
                    fail(f"presets {name}: corrected sentences changed length")
            steps = corrector.steps - steps0
            got = [fn.launches - n for fn, n in zip(serving, before)]
            if got != [layers * steps] * 2:
                fail(f"presets {name}: serving kernels launched {got} times "
                     f"in {steps} steps, expected {layers} per step")
            for fn, n in zip(serving, got):
                launches[fn.__name__] += n
            sync(device)
            t = time.perf_counter()
            for _ in range(timed_requests):
                corrector.correct(requests[-1])
            row["sent_s"] = (timed_requests * len(requests[-1])
                             / (time.perf_counter() - t))
            host = corrector.featurizer.featurize_raw(requests[-1])
            batch = to_device(corrector.featurizer.device_batch(host), device)
            with torch.inference_mode():
                logits_k = corrector.model(batch, tables=corrector.tables,
                                           use_kernels=True)["logits"]
                logits_p = corrector.model(batch, tables=corrector.tables,
                                           use_kernels=False)["logits"]
            if not bool(torch.isfinite(logits_k).all()):
                fail(f"presets {name}: non-finite logits")
            check_argmax(f"presets {name}", logits_k, logits_p,
                         batch["masks"].bool())
            del logits_k, logits_p
            if name in INVARIANCE:
                check_batch_invariance(device, cfg, corrector, card)
            del corrector
        torch.cuda.empty_cache()
        b32, b256 = row["b32"], row["b256"]
        log(f"presets {name}: {layers} encoder layers, {params} parameters, "
            f"serving tables {row['tables']}; "
            f"losses {row['losses']}; B=32 step {b32['host_ms']:.3f} ms host, "
            f"{b32['kernel_ms']:.3f} ms kernels, {b32['peak_gib']:.2f} GiB; "
            f"B=256 step {b256['host_ms']:.3f} ms host, "
            f"{b256['kernel_ms']:.3f} ms kernels, {b256['peak_gib']:.2f} GiB; "
            f"served {row['sent_s']:.1f} sentences/s in 32-sentence "
            f"requests; {time.perf_counter() - t0:.2f} s [{card}]")
        rows.append(row)
    for name in F32_PATHS:
        model_type, overrides = next((m, o) for n, m, o in PRESETS if n == name)
        check_train_paths(device, preset_config(model_type, overrides))
    log(f"presets: launches on the phase's path {launches} (with the checks "
        f"and timing runs {({fn.__name__: fn.launches for fn in wrappers})})")
    if not all(launches.values()):
        fail(f"presets: a kernel was never launched: {launches}")
    log("presets table: config | layers | parameters | B=32 host ms | B=32 "
        "event ms | B=32 kernel ms | B=32 peak GiB | B=256 host ms | B=256 "
        "event ms | B=256 kernel ms | B=256 peak GiB | served sentences/s")
    for r in rows:
        b32, b256 = r["b32"], r["b256"]
        log(f"  | {r['name']} | {r['layers']} | {r['params']} | "
            f"{b32['host_ms']:.3f} | {b32['step_ms']:.3f} | "
            f"{b32['kernel_ms']:.3f} | {b32['peak_gib']:.2f} | "
            f"{b256['host_ms']:.3f} | {b256['step_ms']:.3f} | "
            f"{b256['kernel_ms']:.3f} | {b256['peak_gib']:.2f} | "
            f"{r['sent_s']:.1f} |")
    return launches, rows


# ------------------------------------------------------------ length buckets
BUCKETS = (32, 64, 128)
# The CUDA functions each train kernel's bf16 steps must show in the
# cli/train trace: its products by epilogue mode (A layout, B layout; the
# schedule flag left out, since inter.W2^T takes ping-pong at M = B*S = 8192
# by its wave fill and the cooperative tile at 16384 and 32768) and the
# attention cores.
TRACE_NAMES = {
    "attention_train_forward": (QKV, "gemm_sm90<4, false, true, ", CORE),
    "attention_train_backward": ("gemm_sm90<7, false, false, ",
                                 "gemm_sm90<8, false, false, ",
                                 "attention_bwd_core_tc<"),
    "ffn_train_forward": ("gemm_sm90<1, false, true, ",
                          "gemm_sm90<5, false, true, "),
    "ffn_train_backward": ("gemm_sm90<9, false, true, ",
                           "gemm_sm90<10, false, false, ")}
# tests/test_convergence.py's tiny arch3, dropout 0, float32.
CONVERGENCE_CFG = dict(vocab_size=300, hidden_size=32, num_hidden_layers=2,
                       num_attention_heads=2, intermediate_size=64,
                       pho_num_layers=1, out_num_layers=1, max_seq_length=16,
                       max_position_embeddings=32, num_fonts=1,
                       hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)


def bucket_of(example):
    """The bucket ``bucketed_batch_iterator`` bins an example into."""
    n = len(example["src_idx"])
    return next((b for b in BUCKETS if n <= b), BUCKETS[-1])


@contextlib.contextmanager
def bucket_steps():
    """``Trainer.train_step`` and ``Trainer.fit`` recorded with no device
    sync (the loss is kept as a tensor, so ``fit``'s dispatch times are the
    CLI's): each step's bucket length, launches of the four train kernels
    and loss, and each ``fit``'s summary."""
    import numpy as np

    from realise_tpu_torch.ops.kernels import bert_block_train as tbt
    from realise_tpu_torch.training.trainer import Trainer

    rec = {"steps": [], "fits": []}
    step, fit = Trainer.train_step, Trainer.fit

    def train_step(self, batch):
        before = [fn.launches for fn in tbt.KERNEL_WRAPPERS]
        loss = step(self, batch)
        rec["steps"].append((np.shape(batch["src_idx"])[1],
                             [fn.launches - n for fn, n in
                              zip(tbt.KERNEL_WRAPPERS, before)],
                             loss.detach()))
        return loss

    def recording_fit(self, batches, **kw):
        out = fit(self, batches, **kw)
        rec["fits"].append(out)
        return out

    Trainer.train_step, Trainer.fit = train_step, recording_fit
    try:
        yield rec
    finally:
        Trainer.train_step, Trainer.fit = step, fit


def trace_kernel_names(trace_dir):
    """The CUDA kernel names of the one Chrome trace in ``trace_dir``."""
    import glob

    paths = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if len(paths) != 1:
        fail(f"buckets: {len(paths)} trace files in {trace_dir}, expected 1")
    with open(paths[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    log(f"buckets: trace {os.path.basename(paths[0])}: "
        f"{os.path.getsize(paths[0]) / 2 ** 20:.1f} MiB, {len(events)} events, "
        f"{len(names)} kernel names")
    return names


def convergence(device, card):
    """tests/test_convergence.py's recipe on the card through the kernels:
    a tiny float32 arch3, 150 steps at batch 64 on the learnable confusion
    data (lr 3e-3, warmup 20, clip 1.0), held-out F1 on 96 sentences.
    Returns the kernels' launches over the run and its eval."""
    import math

    import torch

    from realise_tpu_torch.cli.common import evaluate_model
    from realise_tpu_torch.config import config_for
    from realise_tpu_torch.data.dataset import (batch_iterator,
                                                synthetic_confusion_dataset)
    from realise_tpu_torch.data.features import Featurizer
    from realise_tpu_torch.models.realise import Realise
    from realise_tpu_torch.ops.kernels import bert_block as bb
    from realise_tpu_torch.ops.kernels import bert_block_train as tbt
    from realise_tpu_torch.text.glyphs import build_glyph_table
    from realise_tpu_torch.text.tokenizer import WordPieceTokenizer
    from realise_tpu_torch.text.vocab import build_synthetic_vocab, vocab_to_dict
    from realise_tpu_torch.training.trainer import Trainer

    cfg = config_for(ARCH3, **CONVERGENCE_CFG)
    vocab = build_synthetic_vocab(size=cfg.vocab_size)
    tok = WordPieceTokenizer(vocab_to_dict(vocab))
    feat = Featurizer(tok, cfg)
    train = synthetic_confusion_dataset(tok, num_examples=512, max_len=12, seed=1)
    heldout = synthetic_confusion_dataset(tok, num_examples=96, max_len=12,
                                          seed=2)
    model = Realise(cfg, generator=torch.Generator().manual_seed(0))
    model.install_glyphs(build_glyph_table(vocab, num_fonts=1,
                                           use_traditional_font=False))
    model.install_pho_vocab_tables(*feat.pho2_tables())
    trainer = Trainer(cfg, model, learning_rate=3e-3, warmup_steps=20,
                      total_steps=150, max_grad_norm=1.0, seed=11,
                      device=device)
    if not trainer.use_kernels:
        fail("convergence: the Trainer did not turn the kernels on")

    def batches():
        epoch = 0
        while True:
            for ex in batch_iterator(train, 64, shuffle=True, seed=epoch):
                yield feat.device_batch(feat.featurize(ex))
            epoch += 1

    wrappers = (bb.attention_block, bb.ffn_block) + tuple(tbt.KERNEL_WRAPPERS)
    for fn in wrappers:
        fn.launches = 0
    t = time.perf_counter()
    summary = trainer.fit(batches(), max_steps=150, logging_steps=0)
    train_s = time.perf_counter() - t
    with tempfile.TemporaryDirectory() as out:
        res = evaluate_model(trainer, heldout, feat, tok, out, batch_size=32)
    launches = {fn.__name__: fn.launches for fn in wrappers}
    layers = encoder_layers(cfg)
    log(f"convergence: 150 steps in {train_s:.2f} s, final loss "
        f"{summary['final_loss']:.4f}; held-out sent-correct-f1 "
        f"{res['sent-correct-f1']:.2f}, sent-detect-f1 "
        f"{res['sent-detect-f1']:.2f}; launches {launches} [{card}]")
    want = [150 * layers] * 4 + [layers * -(-len(heldout) // 32)] * 2
    if [launches[fn.__name__] for fn in tuple(tbt.KERNEL_WRAPPERS)
            + (bb.attention_block, bb.ffn_block)] != want:
        fail(f"convergence: launches {launches}, expected {want} (train x4, "
             f"serving x2)")
    if not (math.isfinite(summary["final_loss"])
            and res["sent-correct-f1"] > 50 and res["sent-detect-f1"] > 50):
        fail(f"convergence: final loss {summary['final_loss']}, held-out {res}")
    return launches


def buckets(device, card, gen):
    """Phase 8b: training at the bucket lengths. The four train kernels
    against their plain versions at B=256, S=32 and 64; ``cli/train
    --length_buckets 32,64,128 --trace_dir --trace_steps 3 --do_eval`` at
    full width (arch3, bf16, dropout 0.1, B=256) for an epoch of 3072
    sentences of 20-100 chars: every bucket reached, 19 launches of each
    train kernel a step, the trace naming each train kernel's CUDA
    functions; per bucket at B=256 and 32 a step's host clock, CUDA events,
    kernels and peak memory; two backward calls at S=32 and 64 the same
    bits; ``fit``'s dispatch percentiles at B=256 (the CLI) and 32; an
    epoch's sentences/s bucketed and padded to 128; then the convergence
    recipe on the card. Returns the kernels' launches on the phase's path
    (the CLI run and the convergence run) and the worst relative error of
    the kernel checks."""
    import math
    import pickle

    import numpy as np
    import torch

    from realise_tpu_torch.cli import train as cli_train
    from realise_tpu_torch.cli.common import zero_padding_loss
    from realise_tpu_torch.config import config_for
    from realise_tpu_torch.data.dataset import (batch_iterator,
                                                bucketed_batch_iterator,
                                                pad_examples,
                                                synthetic_dataset)
    from realise_tpu_torch.data.features import Featurizer
    from realise_tpu_torch.ops.kernels import bert_block as bb
    from realise_tpu_torch.ops.kernels import bert_block_train as tbt
    from realise_tpu_torch.text.tokenizer import WordPieceTokenizer
    from realise_tpu_torch.text.vocab import (REAL_VOCAB_CJK_CHARS,
                                              build_synthetic_vocab,
                                              vocab_to_dict)
    from realise_tpu_torch.training.trainer import Trainer

    started = time.perf_counter()
    # 1. The train kernels at B=256 and the two short buckets, a quarter of
    # the rows padded (1 to 7 eighths of S valid).
    shapes = [(256, s, [s if i % 4 else s * (1 + i % 7) // 8 for i in range(256)])
              for s in (32, 64)]
    worst = check_train_kernels(device, gen, shapes)

    # 2. cli/train over the bucketed epoch, traced, then scored.
    cfg = config_for(ARCH3, vocab_size=21128, dtype="bfloat16")
    layers = encoder_layers(cfg)
    vocab = build_synthetic_vocab(size=cfg.vocab_size,
                                  cjk_chars=REAL_VOCAB_CJK_CHARS)
    tok = WordPieceTokenizer(vocab_to_dict(vocab))
    data = synthetic_dataset(tok, num_examples=3072, min_len=20, max_len=100,
                             seed=SEED + 900)
    dev = synthetic_dataset(tok, num_examples=256, min_len=20, max_len=100,
                            seed=SEED + 901)
    epoch = list(bucketed_batch_iterator(data, 256, buckets=BUCKETS,
                                         shuffle=True, seed=SEED,
                                         pad_final=False))
    counts = {b: sum(bucket_of(ex) == b for ex in data) for b in BUCKETS}
    wrappers = (bb.attention_block, bb.ffn_block) + tuple(tbt.KERNEL_WRAPPERS)
    with tempfile.TemporaryDirectory() as root:
        with open(os.path.join(root, "vocab.txt"), "w", encoding="utf-8") as f:
            f.write("\n".join(vocab) + "\n")
        for name, examples in (("train.pkl", data), ("dev.pkl", dev)):
            with open(os.path.join(root, name), "wb") as f:
                pickle.dump(examples, f)
        trace_dir = os.path.join(root, "trace")
        argv = ["--data_dir", root, "--train_file", "train.pkl", "--dev_file",
                "dev.pkl", "--dtype", "bfloat16", "--seed", str(SEED),
                "--length_buckets", ",".join(map(str, BUCKETS)),
                "--trace_dir", trace_dir, "--trace_steps", "3",
                "--per_device_train_batch_size", "256",
                "--num_train_epochs", "1", "--logging_steps", "0",
                "--save_steps", "100000", "--do_train", "--do_eval",
                "--eval_batch_size", "32", "--output_dir",
                os.path.join(root, "out")]
        for fn in wrappers:
            fn.launches = 0
        t = time.perf_counter()
        with bucket_steps() as rec:
            rc = cli_train.main(argv)
        cli_s = time.perf_counter() - t
        launches = {fn.__name__: fn.launches for fn in wrappers}
        if rc != 0:
            fail(f"buckets: cli/train exited {rc}")
        names = trace_kernel_names(trace_dir)
        with open(os.path.join(root, "out", "dev_results.json")) as f:
            dev_res = json.load(f)
    torch.cuda.empty_cache()
    steps = [(s, n, float(loss)) for s, n, loss in rec["steps"]]
    log(f"buckets: cli/train {cli_s:.2f} s, {len(data)} sentences by bucket "
        f"{counts}, {len(steps)} steps at lengths {[s for s, _, _ in steps]}, "
        f"launches {launches}; dev {dev_res}")
    if [s for s, _, _ in steps] != [b for b, _ in epoch]:
        fail(f"buckets: the CLI's step lengths {[s for s, _, _ in steps]} are "
             f"not the epoch's buckets {[b for b, _ in epoch]}")
    if set(s for s, _, _ in steps) != set(BUCKETS):
        fail("buckets: the epoch did not reach every bucket")
    bad = [(s, n) for s, n, _ in steps if n != [layers] * 4]
    if bad:
        fail(f"buckets: train kernels launched {bad[:4]} times in a step, "
             f"expected {layers} each at every bucket")
    if not all(math.isfinite(loss) for _, _, loss in steps):
        fail(f"buckets: losses {[loss for _, _, loss in steps]}")
    serving_want = layers * -(-len(dev) // 32)
    if [launches[fn.__name__] for fn in (bb.attention_block, bb.ffn_block)] \
            != [serving_want] * 2:
        fail(f"buckets: serving kernels {launches}, expected {serving_want}")
    missing = {k: [m for m in want if not any(m in n for n in names)]
               for k, want in TRACE_NAMES.items()}
    log(f"buckets: the trace's train kernel functions missing: {missing}")
    if any(missing.values()):
        fail(f"buckets: the trace lacks train kernel functions {missing}")
    traced, rest = rec["fits"]
    if traced["steps"] != 3:
        fail(f"buckets: the traced fit ended at step {traced['steps']}")
    cli_dispatch = rest["dispatch"]

    # 3. Per bucket at B=256 and 32: a step's host clock, events, kernels,
    # peak memory; the equal-bits check at S=32 and 64.
    feat = Featurizer(tok, cfg)
    model = seeded_model(cfg, SEED + 902)
    trainer = Trainer(cfg, model, learning_rate=5e-5, warmup_steps=2,
                      total_steps=1000, weight_decay=0.01, max_grad_norm=1.0,
                      device=device, seed=SEED)
    binned = {b: [ex for ex in data if bucket_of(ex) == b] for b in BUCKETS}
    rows = {}
    for b in (256, 32):
        for s in BUCKETS:
            batch = feat.device_batch(feat.featurize(
                pad_examples(binned[s][:b], b), seq_len=s))
            rows[b, s] = step_split(trainer, batch, f"bucket {s}", card)
            if b == 256 and s < 128:
                check_stream_determinism(trainer, batch, f"B=256 S={s}")

    def featurized(batches):
        """(length, examples, batch size) → host batches, each padded to
        its size with the padded rows' loss zeroed, as cli/train does."""
        return [feat.device_batch(zero_padding_loss(feat.featurize(
            pad_examples(ex, size), seq_len=s), len(ex)))
            for s, ex, size in batches]

    # 4. fit's dispatch at B=32 over 30 bucketed batches, and the share of
    # its wall clock the card spends in kernels (each batch counted at its
    # bucket's profiled kernel time above).
    small = [(s, ex, 32) for s, ex in bucketed_batch_iterator(
        data, 32, buckets=BUCKETS, shuffle=True, seed=SEED + 1,
        pad_final=False)][:30]
    sync(device)
    small_fit = trainer.fit(featurized(small), logging_steps=0)
    busy32 = sum(rows[32, s]["kernel_ms"] for s, _, _ in small)
    # 5. The epoch bucketed, and padded to 128 (the same sentences, in
    # batch_iterator's order for the epoch's seed), through fit.
    rates = {}
    for name, batches in (
            ("bucketed", [(s, ex, 256) for s, ex in epoch]),
            ("padded to 128", [(128, ex, 256) for ex in batch_iterator(
                data, 256, shuffle=True, seed=SEED, pad_final=False)])):
        host = featurized(batches)
        sync(device)
        out = trainer.fit(host, logging_steps=0)
        rates[name] = (len(data) / out["wall_time_s"], len(host), out)
    busy256 = sum(rows[256, s]["kernel_ms"] for s, _ in epoch)
    del trainer, model
    torch.cuda.empty_cache()

    # 6. The convergence recipe on the card.
    for name, n in convergence(device, card).items():
        launches[name] += n

    log("buckets table: B | S | step ms, host | step ms, events | kernels ms "
        f"| peak GiB | sentences/s (host) [{card}]")
    for (b, s), r in rows.items():
        log(f"  | {b} | {s} | {r['host_ms']:.3f} | {r['step_ms']:.3f} | "
            f"{r['kernel_ms']:.3f} | {r['peak_gib']:.2f} | "
            f"{b / r['host_ms'] * 1e3:.1f} |")
    log(f"buckets: cli/train fit dispatch at B=256 after its 3 traced steps: "
        f"{cli_dispatch['steps']} steps, p50 {1e3 * cli_dispatch['p50_s']:.3f} "
        f"ms, p95 {1e3 * cli_dispatch['p95_s']:.3f} ms, mean "
        f"{1e3 * cli_dispatch['mean_s']:.3f} ms; {rest['steps_per_sec']:.2f} "
        f"steps/s [{card}]")
    d = small_fit["dispatch"]
    log(f"buckets: fit at B=32 over {len(small)} bucketed batches: dispatch "
        f"p50 {1e3 * d['p50_s']:.3f} ms, p95 {1e3 * d['p95_s']:.3f} ms; wall "
        f"{1e3 * small_fit['wall_time_s']:.3f} ms against {busy32:.3f} ms of "
        f"kernels ({busy32 / 1e3 / small_fit['wall_time_s']:.1%} busy) "
        f"[{card}]")
    for name, (rate, n, out) in rates.items():
        d = out["dispatch"]
        log(f"buckets: epoch {name}: {len(data)} sentences in {n} steps, "
            f"{out['wall_time_s']:.3f} s, {rate:.1f} sentences/s; dispatch "
            f"p50 {1e3 * d['p50_s']:.3f} ms, p95 {1e3 * d['p95_s']:.3f} ms "
            f"[{card}]")
    wall = rates["bucketed"][2]["wall_time_s"]
    log(f"buckets: bucketed epoch {busy256:.3f} ms of kernels in "
        f"{1e3 * wall:.3f} ms of wall clock ({busy256 / 1e3 / wall:.1%} "
        f"busy); bucketed / padded sentences/s "
        f"{rates['bucketed'][0] / rates['padded to 128'][0]:.3f}; phase "
        f"{time.perf_counter() - started:.1f} s [{card}]")
    return launches, worst


# ------------------------------------------------------ the pretraining stages
def pretrain_config(model_type):
    from realise_tpu_torch.config import config_for

    return config_for(model_type, vocab_size=21128, dtype="bfloat16")


@contextlib.contextmanager
def recorded_steps():
    """``Trainer.train_step`` and ``Trainer.fit`` of the CLIs the phase
    drives, recorded: each step's loss (read back) and the launches of the
    four train kernels in it, and the model's state dict as ``fit`` starts."""
    from realise_tpu_torch.ops.kernels import bert_block_train as tbt
    from realise_tpu_torch.training.trainer import Trainer

    rec = {"steps": [], "starts": []}
    step, fit = Trainer.train_step, Trainer.fit

    def train_step(self, batch):
        before = [fn.launches for fn in tbt.KERNEL_WRAPPERS]
        loss = step(self, batch)
        rec["steps"].append((float(loss), [fn.launches - n for fn, n in
                                           zip(tbt.KERNEL_WRAPPERS, before)]))
        return loss

    def recording_fit(self, batches, **kw):
        rec["starts"].append({k: v.clone()
                              for k, v in self.model.state_dict().items()})
        return fit(self, batches, **kw)

    Trainer.train_step, Trainer.fit = train_step, recording_fit
    try:
        yield rec
    finally:
        Trainer.train_step, Trainer.fit = step, fit


def check_steps(label, rec, steps, per_step):
    """``steps`` recorded steps, each loss finite, each step ``per_step``
    launches of every train kernel."""
    import math

    losses = [loss for loss, _ in rec["steps"]]
    log(f"{label}: losses {losses}, train kernel launches per step "
        f"{[n for _, n in rec['steps']]}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"{label}: {len(losses)} steps (expected {steps}), losses {losses}")
    if any(n != [per_step] * 4 for _, n in rec["steps"]):
        fail(f"{label}: train kernels launched {[n for _, n in rec['steps']]} "
             f"times, expected {per_step} each per step")
    return losses


def pretraining(device, card):
    """Phase 12: the pretraining stages and the merge at full width (bf16,
    V=21128, the published dropout, seeded random weights, procedural
    glyphs, --synthetic data). ``cli/pretrain_pho`` for 4 updates at its
    published 64 x 2 (4 x 2 launches of each train kernel an update, the
    dev token accuracy with 4 serving launches a batch); ``cli/pretrain_res``
    for 4 steps at 512 and its accuracy over every CJK char of the vocab;
    ``pho2-res-pretrain`` through the Trainer, 2 steps at 64, and one eval
    batch; the float32 kernel-vs-plain training check of phase 8 on
    pho2-pretrain and pho2-res-pretrain; ``cli/merge`` of the two stages
    onto a seeded arch3 checkpoint, then ``cli/train --max_steps 2
    --do_eval`` from ``--init_ckpt merged`` and from ``--init_ckpt base
    --pho_ckpt --res_ckpt`` (the same initial bits and loss traces) and
    ``cli/test`` on the merged run; then a timed step of each stage (host
    clock, CUDA events, profiled kernels, peak memory), the merge's seconds
    and the two evals' rates. Returns the kernels' launches on the phase's
    path (the CLIs and the counted Trainer steps, not the checks and
    timings)."""
    import math

    import numpy as np
    import torch

    from realise_tpu_torch.cli import merge as cli_merge
    from realise_tpu_torch.cli import pretrain_pho, pretrain_res
    from realise_tpu_torch.cli import test as cli_test
    from realise_tpu_torch.cli import train as cli_train
    from realise_tpu_torch.data.dataset import synthetic_dataset
    from realise_tpu_torch.data.features import Featurizer
    from realise_tpu_torch.ops.kernels import bert_block as bb
    from realise_tpu_torch.ops.kernels import bert_block_train as tbt
    from realise_tpu_torch.text.tokenizer import WordPieceTokenizer
    from realise_tpu_torch.text.vocab import (REAL_VOCAB_CJK_CHARS,
                                              build_synthetic_vocab,
                                              vocab_to_dict)
    from realise_tpu_torch.training.checkpoint import (list_checkpoints,
                                                       load_checkpoint,
                                                       save_checkpoint)
    from realise_tpu_torch.training.trainer import Trainer

    started = time.perf_counter()
    serving = (bb.attention_block, bb.ffn_block)
    wrappers = serving + tuple(tbt.KERNEL_WRAPPERS)
    for fn in wrappers:
        fn.launches = 0
    launches = dict.fromkeys((fn.__name__ for fn in wrappers), 0)

    def counted(label, fn, serving_want):
        """Run fn; add its launches to the phase's path and check the
        serving kernels' count."""
        before = {f.__name__: f.launches for f in wrappers}
        t = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t
        got = {f.__name__: f.launches - before[f.__name__] for f in wrappers}
        for name, n in got.items():
            launches[name] += n
        if [got[f.__name__] for f in serving] != [serving_want] * 2:
            fail(f"{label}: serving kernels launched "
                 f"{[got[f.__name__] for f in serving]} times, expected "
                 f"{serving_want} each")
        log(f"{label}: {dt:.2f} s, launches {got}")
        return out

    pho_cfg, res_cfg = pretrain_config("pho2-pretrain"), pretrain_config("res-pretrain")
    layers = pho_cfg.pho_num_layers
    tok = WordPieceTokenizer(vocab_to_dict(build_synthetic_vocab(
        size=21128, cjk_chars=REAL_VOCAB_CJK_CHARS)))
    feat = Featurizer(tok, pho_cfg)
    char_ids = np.nonzero(feat.cjk_token_mask())[0]
    dev = synthetic_dataset(tok, num_examples=1024, min_len=20, max_len=100,
                            seed=SEED + 702)  # the timed evals' sentences

    def timed_token_accuracy(label, trainer):
        sync(device)
        t = time.perf_counter()
        acc = pretrain_pho.token_accuracy(trainer, dev, feat)
        dt = time.perf_counter() - t
        log(f"pretrain: {label} token accuracy of {len(dev)} sentences at "
            f"batch 64 {acc}: {dt:.3f} s, {len(dev) / dt:.1f} sentences/s "
            f"[{card}]")
        return f"{len(dev) / dt:.1f} sentences/s"

    common = ["--synthetic", "--dtype", "bfloat16", "--seed", str(SEED)]
    rows = {}
    with tempfile.TemporaryDirectory() as root:
        d = {n: os.path.join(root, n) for n in ("pho", "res", "base", "merged",
                                                "ft_merged", "ft_overlay")}
        # 1. pretrain_pho.sh: 4 updates of 64 x 2 (its published flags), the
        # dev set's 64 sentences in one eval batch of 64.
        with recorded_steps() as rec:
            if counted("pretrain: cli/pretrain_pho 4 updates of 64 x 2",
                       lambda: pretrain_pho.main(common + [
                           "--output_dir", d["pho"], "--max_steps", "4",
                           "--logging_steps", "1"]), layers) != 0:
                fail("pretrain: cli/pretrain_pho failed")
        pho_losses = check_steps("pretrain: pho2-pretrain", rec, 4, 2 * layers)
        with open(os.path.join(d["pho"], "dev_results.json")) as f:
            pho_dev = json.load(f)
        log(f"pretrain: pho2-pretrain dev {pho_dev}")
        if not all(math.isfinite(v) for v in pho_dev.values()):
            fail(f"pretrain: pho2-pretrain dev results {pho_dev}")

        # 2. pretrain_res.sh: 4 steps of 512, the accuracy over every char.
        with recorded_steps() as rec:
            if counted("pretrain: cli/pretrain_res 4 steps of 512",
                       lambda: pretrain_res.main(common + [
                           "--output_dir", d["res"], "--max_steps", "4",
                           "--logging_steps", "1"]), 0) != 0:
                fail("pretrain: cli/pretrain_res failed")
        res_losses = check_steps("pretrain: res-pretrain", rec, 4, 0)
        with open(os.path.join(d["res"], "dev_results.json")) as f:
            res_dev = json.load(f)
        log(f"pretrain: res-pretrain accuracy over {len(char_ids)} chars "
            f"{res_dev}")
        if not 0.0 <= res_dev["accuracy"] <= 1.0:
            fail(f"pretrain: res-pretrain dev results {res_dev}")

        # 3. pho2-res-pretrain through the Trainer: 2 steps at 64, one eval.
        cfg = pretrain_config("pho2-res-pretrain")
        model = seeded_model(cfg, SEED + 500)
        batches = train_batches(cfg, 3, 64, SEED + 501)
        trainer = Trainer(cfg, model, learning_rate=5e-5, warmup_steps=2,
                          total_steps=100, max_grad_norm=1.0, device=device,
                          seed=SEED)
        with recorded_steps() as rec:
            counted("pretrain: pho2-res-pretrain 2 Trainer steps at 64",
                    lambda: [trainer.train_step(b) for b in batches[:2]], 0)
        check_steps("pretrain: pho2-res-pretrain", rec, 2, layers)
        out = counted("pretrain: pho2-res-pretrain eval batch of 64",
                      lambda: trainer.eval_step(batches[2]), layers)
        if not math.isfinite(out["loss"]):
            fail(f"pretrain: pho2-res-pretrain eval loss {out['loss']}")
        rows["pho2-res-pretrain"] = dict(
            step_split(trainer, batches[2], "pho2-res-pretrain", card),
            params=sum(p.numel() for p in trainer.model.parameters()),
            batch="64", layers=layers,
            eval=timed_token_accuracy("pho2-res-pretrain", trainer))
        del trainer, model
        torch.cuda.empty_cache()

        # 4. The float32 kernel-vs-plain training check of phase 8.
        for name in ("pho2-pretrain", "pho2-res-pretrain"):
            check_train_paths(device, pretrain_config(name))
        torch.cuda.empty_cache()

        # 5. merge.py onto a seeded arch3 checkpoint, then fine-tuning from
        # the merged checkpoint and from the overlay flags.
        base_cfg = preset_config(ARCH3, {})
        base_ckpt = save_checkpoint(d["base"], 0, seeded_model(
            base_cfg, SEED + 600).state_dict(), base_cfg)
        pho_ckpt, res_ckpt = (list_checkpoints(d[n])[-1][1] for n in ("pho", "res"))
        sync(device)
        t = time.perf_counter()
        if cli_merge.main(["--base_ckpt", d["base"], "--pho_ckpt", d["pho"],
                           "--res_ckpt", d["res"], "--output_dir",
                           d["merged"]]) != 0:
            fail("pretrain: cli/merge failed")
        merge_s = time.perf_counter() - t
        merged_ckpt = list_checkpoints(d["merged"])[-1][1]
        ft = common + ["--max_steps", "2", "--do_train", "--do_eval",
                       "--per_device_train_batch_size", "8",
                       "--eval_batch_size", "32", "--logging_steps", "1"]
        eval_batches = -(-64 // 32)  # the dev set's 64 sentences
        arch3_layers = encoder_layers(base_cfg)
        with recorded_steps() as rec:
            for name, extra in (
                    ("ft_merged", ["--init_ckpt", merged_ckpt]),
                    ("ft_overlay", ["--init_ckpt", base_ckpt, "--pho_ckpt",
                                    pho_ckpt, "--res_ckpt", res_ckpt])):
                if counted(f"pretrain: cli/train {' '.join(extra[::2])}",
                           lambda: cli_train.main(ft + ["--output_dir", d[name]]
                                                  + extra),
                           arch3_layers * eval_batches) != 0:
                    fail(f"pretrain: cli/train {extra} failed")
        starts, steps = rec["starts"], rec["steps"]
        merged = load_checkpoint(merged_ckpt, map_location=device)
        differ = [k for k, v in merged.items()
                  if not (torch.equal(starts[0][k], v)
                          and torch.equal(starts[1][k], v))]
        trace = [loss for loss, _ in steps]
        log(f"pretrain: merged checkpoint {merge_s:.3f} s; fine-tuning from it "
            f"and from the overlay flags: {len(merged) - len(differ)} of "
            f"{len(merged)} initial tensors equal bits; loss traces "
            f"{trace[:2]} / {trace[2:]}")
        check_steps("pretrain: fine-tuning runs", rec, 4, arch3_layers)
        if differ or set(starts[0]) != set(merged) or trace[:2] != trace[2:]:
            fail(f"pretrain: the merged and the overlay runs differ: "
                 f"{differ[:8]}, traces {trace}")
        del starts, merged, rec
        if counted("pretrain: cli/test on the merged run",
                   lambda: cli_test.main(["--ckpt_dir", d["ft_merged"],
                                          "--synthetic"]),
                   arch3_layers * eval_batches) != 0:
            fail("pretrain: cli/test failed")
        with open(os.path.join(d["ft_merged"], "test_output",
                               "test_results.json")) as f:
            scores = json.load(f)
        if not all(math.isfinite(v) for v in scores.values()):
            fail(f"pretrain: cli/test scores {scores}")
        log("pretrain: cli/test " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(scores.items())))
    torch.cuda.empty_cache()

    # 6. A timed step of each stage and the evals' rates.
    model = seeded_model(pho_cfg, SEED + 700)
    trainer = Trainer(pho_cfg, model, learning_rate=5e-5, warmup_steps=2,
                      total_steps=100, max_grad_norm=1.0, grad_accum_steps=2,
                      device=device, seed=SEED)
    rows["pho2-pretrain"] = dict(
        step_split(trainer, train_batches(pho_cfg, 1, 128, SEED + 701)[0],
                   "pho2-pretrain", card),
        params=sum(p.numel() for p in model.parameters()), batch="64 x 2",
        layers=layers)
    rows["pho2-pretrain"]["eval"] = timed_token_accuracy("pho2-pretrain",
                                                         trainer)
    del trainer, model
    model = seeded_model(res_cfg, SEED + 800)
    trainer = Trainer(res_cfg, model, learning_rate=1e-3, warmup_steps=0,
                      total_steps=100, max_grad_norm=1.0, device=device,
                      seed=SEED)
    rng = np.random.default_rng(SEED + 801)
    rows["res-pretrain"] = dict(
        step_split(trainer, {"char_idx": char_ids[rng.permutation(
            len(char_ids))[:512]]}, "res-pretrain", card),
        params=sum(p.numel() for p in model.parameters()), batch="512",
        layers=0)
    sync(device)
    t = time.perf_counter()
    acc = pretrain_res.char_accuracy(trainer, char_ids, 512)
    dt = time.perf_counter() - t
    rows["res-pretrain"]["eval"] = f"{len(char_ids) / dt:.1f} chars/s"
    log(f"pretrain: res-pretrain accuracy over {len(char_ids)} chars at batch "
        f"512 {acc:.4f}: {dt:.3f} s, {len(char_ids) / dt:.1f} chars/s [{card}]")
    del trainer, model
    torch.cuda.empty_cache()

    log(f"pretrain: launches on the phase's path {launches} (with the checks "
        f"and timing runs {({fn.__name__: fn.launches for fn in wrappers})})")
    if not all(launches.values()):
        fail(f"pretrain: a kernel was never launched: {launches}")
    log("pretraining table: stage | encoder layers | parameters | batch | "
        "step ms, host | step ms, events | kernels ms | peak GiB | eval")
    for name in ("pho2-pretrain", "res-pretrain", "pho2-res-pretrain"):
        r = rows[name]
        log(f"  | {name} | {r['layers']} | {r['params']} | {r['batch']} | "
            f"{r['host_ms']:.3f} | {r['step_ms']:.3f} | {r['kernel_ms']:.3f} | "
            f"{r['peak_gib']:.2f} | {r['eval']} |")
    log(f"pretrain: merge {merge_s:.3f} s; losses pho2-pretrain {pho_losses}, "
        f"res-pretrain {res_losses}; phase {time.perf_counter() - started:.1f} s "
        f"[{card}]")
    return launches


# ------------------------------------------- full width against the JAX package
GOLDEN = os.path.join("tests", "golden", "port_fullwidth_arch3.npz")
# Phase 13's limits against the JAX package's float32 outputs (the golden
# file). float32 kernel path: every logit at the golden top-8 ids and its 64
# columns and every gate within FULLWIDTH_F32_TOL, phase 3's float32
# kernel-vs-plain limit (an H100 read 1.6e-5 to 1.8e-5). bfloat16: the top-1
# id equal to the golden one at every valid position whose golden top-2
# margin exceeds FULLWIDTH_BF16_TOL, and no logit further than that from the
# golden value (an H100 read 8.4e-2 to 9.4e-2 after 19 bf16 layers; 8 bf16
# ulps at |logit| in [4, 8)).
FULLWIDTH_F32_TOL = 1e-4
FULLWIDTH_BF16_TOL = 0.25
DIGEST_RTOL, DIGEST_ATOL = 1e-9, 1e-6


def golden_gaps(label, logits, gates, golden, prefix, masks):
    """Largest |logit - golden| over the golden top-8 ids and columns, the
    largest gate gap (None without gates), and the positions whose top-1
    differs from the golden top-1 among those whose golden margin exceeds
    FULLWIDTH_BF16_TOL; logged."""
    import numpy as np
    import torch

    pos = torch.as_tensor(np.stack(np.nonzero(masks)), device=logits.device)
    lg = logits.float()[pos[0], pos[1]]
    top = torch.as_tensor(golden[f"{prefix}_top_ids"], dtype=torch.long,
                          device=lg.device)
    cols = torch.as_tensor(golden["cols"], dtype=torch.long, device=lg.device)
    got = torch.cat([lg.gather(1, top), lg[:, cols]], 1).cpu().numpy()
    want = np.concatenate([golden[f"{prefix}_top_logits"],
                           golden[f"{prefix}_col_logits"]], 1)
    logit_gap = float(np.abs(got - want).max())
    gate_gap = None
    if gates is not None:
        gate_gap = float(np.abs(gates.float()[pos[0], pos[1]].cpu().numpy()
                                - golden[f"{prefix}_gates"]).max())
    margin = golden[f"{prefix}_top_logits"][:, 0] - golden[f"{prefix}_top_logits"][:, 1]
    clear = margin > FULLWIDTH_BF16_TOL
    flipped = int((lg.argmax(1).cpu().numpy() != golden[f"{prefix}_top_ids"][:, 0])[clear].sum())
    log(f"fullwidth: {label}: largest logit gap to the JAX package "
        f"{logit_gap:.3e} over {got.size} logits at {lg.shape[0]} positions"
        + (f", gates {gate_gap:.3e}" if gate_gap is not None else "")
        + f"; top-1 differs at {flipped} of the {int(clear.sum())} positions "
        f"with a golden margin above {FULLWIDTH_BF16_TOL}")
    return logit_gap, gate_gap, flipped


def fullwidth(device, card, ckpt_root):
    """Phase 13: the published arch3 on numpy-seeded weights against the JAX
    package's float32 outputs in ``tests/golden/port_fullwidth_arch3.npz``
    (written by tests/test_torch_fullwidth.py): the weights' digest, then
    the kernel path in float32 and bfloat16 (``Realise``, with and without
    the inference tables) and the Corrector's tables path in bfloat16.
    Returns the serving kernels' launches."""
    import numpy as np
    import torch

    from realise_tpu_torch.config import config_for
    from realise_tpu_torch.data.features import to_device
    from realise_tpu_torch.models.convert import seeded_weights
    from realise_tpu_torch.models.realise import (Realise,
                                                  precompute_inference_tables)
    from realise_tpu_torch.ops.kernels import bert_block as bb
    from realise_tpu_torch.serving import Corrector
    from realise_tpu_torch.training.checkpoint import save_checkpoint

    started = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    with np.load(os.path.join(root, GOLDEN), allow_pickle=False) as f:
        golden = dict(f)
    cfg = config_for(str(golden["model_type"]))
    layers = encoder_layers(cfg)
    sd, (pho_idx, pho_lens) = seeded_weights(cfg, int(golden["seed"]))
    t_weights = time.perf_counter() - started
    on_card = {k: v.to(device) for k, v in sd.items()}
    tensors = dict(on_card,
                   vocab_pho_idx=torch.as_tensor(pho_idx, device=device),
                   vocab_pho_lens=torch.as_tensor(pho_lens, device=device))
    names = sorted(tensors)
    if names != list(golden["digest_names"]):
        fail(f"fullwidth: the seeded tensors' names differ from the golden "
             f"file's: {sorted(set(names) ^ set(golden['digest_names']))[:8]}")
    sums = np.asarray([float(tensors[k].double().sum()) for k in names])
    sumsq = np.asarray([float(tensors[k].double().square().sum()) for k in names])
    bad = [k for k, a, b, c, d in zip(names, sums, golden["digest_sum"], sumsq,
                                      golden["digest_sumsq"])
           if not (np.isclose(a, b, rtol=DIGEST_RTOL, atol=DIGEST_ATOL)
                   and np.isclose(c, d, rtol=DIGEST_RTOL, atol=DIGEST_ATOL))]
    log(f"fullwidth: seeded weights (seed {int(golden['seed'])}) {t_weights:.2f} s; "
        f"digest of {len(names)} tensors on the card against the golden "
        f"file's: {len(names) - len(bad)} equal (rtol {DIGEST_RTOL})")
    if bad:
        fail(f"fullwidth: the weights on the card are not the golden file's: "
             f"{bad[:8]}")

    keys = ("src_idx", "masks", "pho_idx", "pho_lens")
    arrays = {k: golden[k] for k in keys}
    tables_arrays = dict(arrays, src_idx=golden["tables_src_idx"])
    masks = golden["masks"]
    serving = (bb.attention_block, bb.ffn_block)
    launches = dict.fromkeys((fn.__name__ for fn in serving), 0)
    worst = {}

    def run(label, forward):
        """forward() once, its serving launches counted: one of each kernel
        per encoder layer."""
        before = [fn.launches for fn in serving]
        t = time.perf_counter()
        with torch.inference_mode():
            out = forward()
        sync(device)
        dt = time.perf_counter() - t
        got = [fn.launches - n for fn, n in zip(serving, before)]
        for fn, n in zip(serving, got):
            launches[fn.__name__] += n
        if got != [layers] * 2:
            fail(f"fullwidth: {label}: serving kernels launched {got} times, "
                 f"expected {layers} each")
        log(f"fullwidth: {label}: {1e3 * dt:.3f} ms")
        return out

    for dtype in ("float32", "bfloat16"):
        with torch.device("meta"):
            model = Realise(cfg.replace(dtype=dtype))
        model.load_state_dict(on_card, assign=True)
        model.eval()
        tables = precompute_inference_tables(model, pho_idx, pho_lens)
        for prefix, batch_arrays, kw in (
                ("plain", arrays, {}), ("tables", tables_arrays,
                                        {"tables": tables})):
            label = f"Realise {dtype}" + (", tables" if kw else "")
            batch = to_device(batch_arrays, device)
            out = run(label, lambda: model(batch, use_kernels=True,
                                           return_gates=True, **kw))
            worst[label] = golden_gaps(label, out["logits"], out["gates"],
                                       golden, prefix, masks)
        del model, tables

    save_checkpoint(ckpt_root, 0, sd, cfg.replace(dtype="bfloat16"))
    corrector = Corrector(ckpt_root, synthetic_vocab=True, device=device,
                          fast_path=False)
    # The Corrector's tables path over the golden file's pinyin tables (its
    # featurizer's would be the synthetic vocab's).
    corrector.tables = precompute_inference_tables(corrector.model, pho_idx,
                                                   pho_lens)
    logits = run("Corrector bfloat16, tables",
                 lambda: corrector.logits(tables_arrays))
    worst["Corrector bfloat16, tables"] = golden_gaps(
        "Corrector bfloat16, tables", logits, None, golden, "tables", masks)
    del corrector

    for label, (logit_gap, gate_gap, flipped) in worst.items():
        if "float32" in label:
            if max(logit_gap, gate_gap) > FULLWIDTH_F32_TOL:
                fail(f"fullwidth: {label}: {logit_gap:.3e} / {gate_gap:.3e} "
                     f"past {FULLWIDTH_F32_TOL}")
        elif flipped or logit_gap > FULLWIDTH_BF16_TOL:
            fail(f"fullwidth: {label}: top-1 flipped at {flipped} clear "
                 f"positions, largest logit gap {logit_gap:.3e} (limit "
                 f"{FULLWIDTH_BF16_TOL})")
    log(f"fullwidth: launches {launches}; phase "
        f"{time.perf_counter() - started:.1f} s [{card}]")
    return launches


# ------------------------------------------------ the recipe from raw files
def raw_corpus(tok, rng, n_train, n_test):
    """A fabricated SIGHAN training SGML (tests/test_prepare_data.py's
    shape: essays of passages, MISTAKE location/WRONG/CORRECTION) and a
    SIGHAN test input with its truth file (tests/test_corpus.py's), over the
    vocab's single CJK chars that the t2s fallback leaves as they are."""
    from realise_tpu_torch.data.corpus import make_t2s
    from realise_tpu_torch.text.tokenizer import is_chinese_char

    t2s = make_t2s()
    chars = [t for t in tok.vocab if len(t) == 1 and is_chinese_char(ord(t))
             and t2s(t) == t]

    def sentence():
        return "".join(rng.choice(chars, rng.integers(20, 60))) + "。"

    def misspell(s):
        pos = int(rng.integers(0, len(s) - 1))
        wrong = rng.choice([c for c in chars[:200] if c != s[pos]])
        return s[:pos] + wrong + s[pos + 1:], pos + 1, wrong, s[pos]

    essays = []
    for e in range(0, n_train, 2):
        passages, mistakes = [], []
        for j in (1, 2):
            pid = f"B1-{e:04d}-{j}"
            s = sentence()
            if j == 1:
                s, loc, wrong, right = misspell(s)
                mistakes.append(f'<MISTAKE id="{pid}" location="{loc}">\n'
                                f"<WRONG>{wrong}</WRONG>\n"
                                f"<CORRECTION>{right}</CORRECTION>\n</MISTAKE>")
            passages.append(f'<PASSAGE id="{pid}">{s}</PASSAGE>')
        essays.append('<ESSAY title="t">\n<TEXT>\n' + "\n".join(passages)
                      + "\n</TEXT>\n" + "\n".join(mistakes) + "\n</ESSAY>")
    inputs, truth = [], []
    for i in range(n_test):
        pid = f"A2-{i:04d}-1"
        s = sentence()
        if i % 2 == 0:
            s, loc, _, right = misspell(s)
            truth.append(f"{pid}, {loc}, {right}")
        else:
            truth.append(f"{pid}, 0")
        inputs.append(f"(pid={pid})\t{s}")
    return ("\n".join(essays) + "\n", "\n".join(inputs) + "\n",
            "\n".join(truth) + "\n")


def raw_recipe(device, card):
    """Phase 14: the reference's recipe from raw corpus files on the card.
    ``cli/prepare_data`` turns a fabricated SIGHAN training SGML (64
    passages) into TSV, label file and pkl (``--repeat 2``), and a SIGHAN
    test input with its truth file (64 sentences) into pkl and label file;
    ``cli/train --do_train --do_eval`` trains the published arch3 (bf16,
    the published dropout) 4 steps at batch 16 on that pkl and scores its
    checkpoint on the test pkl with the produced label file; ``cli/test``
    scores it again. Returns every kernel's launches on the path."""
    import math

    import numpy as np

    from realise_tpu_torch.cli import prepare_data
    from realise_tpu_torch.cli import test as cli_test
    from realise_tpu_torch.cli import train as cli_train
    from realise_tpu_torch.ops.kernels import bert_block as bb
    from realise_tpu_torch.ops.kernels import bert_block_train as tbt
    from realise_tpu_torch.text.tokenizer import WordPieceTokenizer
    from realise_tpu_torch.text.vocab import (REAL_VOCAB_CJK_CHARS,
                                              build_synthetic_vocab,
                                              vocab_to_dict)
    from realise_tpu_torch.training.checkpoint import list_checkpoints

    started = time.perf_counter()
    wrappers = (bb.attention_block, bb.ffn_block) + tuple(tbt.KERNEL_WRAPPERS)
    launches = dict.fromkeys((fn.__name__ for fn in wrappers), 0)
    from realise_tpu_torch.config import config_for

    layers = encoder_layers(config_for(ARCH3))
    steps, batch, n_train, n_test = 4, 16, 64, 64
    vocab = build_synthetic_vocab(size=21128, cjk_chars=REAL_VOCAB_CJK_CHARS)
    tok = WordPieceTokenizer(vocab_to_dict(vocab))
    sgml, test_input, test_truth = raw_corpus(tok, np.random.default_rng(SEED),
                                              n_train, n_test)
    seconds = {}

    def step(label, fn):
        before = {f.__name__: f.launches for f in wrappers}
        t = time.perf_counter()
        rc = fn()
        seconds[label] = time.perf_counter() - t
        for f in wrappers:
            launches[f.__name__] += f.launches - before[f.__name__]
        if rc != 0:
            fail(f"raw recipe: {label} exited {rc}")

    with tempfile.TemporaryDirectory() as d:
        def path(name):
            return os.path.join(d, name)

        for name, text in (("vocab.txt", "\n".join(vocab) + "\n"),
                           ("B1_training.sgml", sgml),
                           ("SIGHAN15_CSC_TestInput.txt", test_input),
                           ("SIGHAN15_CSC_TestTruth.txt", test_truth)):
            with open(path(name), "w", encoding="utf-8") as f:
                f.write(text)
        step("prepare_data train", lambda: prepare_data.main([
            "--format", "sighan-train", "--year", "14",
            "--input", path("B1_training.sgml"), "--vocab_path", path("vocab.txt"),
            "--repeat", "2", "--output_tsv", path("train.tsv"),
            "--output_lbl", path("train.lbl.tsv"),
            "--output_pkl", path("trainall.times2.pkl")]))
        step("prepare_data test", lambda: prepare_data.main([
            "--format", "sighan-test", "--year", "15",
            "--input", path("SIGHAN15_CSC_TestInput.txt"),
            "--truth", path("SIGHAN15_CSC_TestTruth.txt"),
            "--vocab_path", path("vocab.txt"), "--output_tsv", path("test.tsv"),
            "--output_lbl", path("test.sighan15.lbl.tsv"),
            "--output_pkl", path("test.sighan15.pkl")]))
        counts = {}
        for name in ("train.tsv", "train.lbl.tsv", "test.tsv",
                     "test.sighan15.lbl.tsv"):
            with open(path(name), encoding="utf-8") as f:
                counts[name] = len(f.read().splitlines())
        for name in ("trainall.times2.pkl", "test.sighan15.pkl"):
            with open(path(name), "rb") as f:
                counts[name] = len(pickle.load(f))
        want = {"train.tsv": n_train, "train.lbl.tsv": n_train,
                "trainall.times2.pkl": 2 * n_train, "test.tsv": n_test,
                "test.sighan15.lbl.tsv": n_test, "test.sighan15.pkl": n_test}
        log(f"raw recipe: prepare_data wrote {counts}")
        if counts != want:
            fail(f"raw recipe: prepare_data wrote {counts}, expected {want}")

        out = path("out")
        data = ["--data_dir", d, "--vocab_path", path("vocab.txt")]
        with recorded_steps() as rec:
            step("cli/train", lambda: cli_train.main(data + [
                "--do_train", "--do_eval", "--output_dir", out,
                "--dtype", "bfloat16", "--train_file", "trainall.times2.pkl",
                "--dev_file", "test.sighan15.pkl",
                "--dev_label_file", "test.sighan15.lbl.tsv",
                "--max_steps", str(steps), "--save_steps", str(steps),
                "--per_device_train_batch_size", str(batch),
                "--warmup_steps", "2", "--seed", str(SEED)]))
        losses = check_steps("raw recipe: cli/train", rec, steps, layers)
        step("cli/test", lambda: cli_test.main(data + [
            "--ckpt_dir", out, "--testset_year", "15"]))
        with open(os.path.join(out, "dev_results.json")) as f:
            dev = json.load(f)
        with open(os.path.join(out, "test_output", "test_results.json")) as f:
            test = json.load(f)
        ckpts = [s for s, _ in list_checkpoints(out)]
    log(f"raw recipe: losses {losses}; checkpoints {ckpts}; dev {dev}; "
        f"cli/test {test}")
    if ckpts != [steps] or list(dev) != [str(steps)] or not all(
            math.isfinite(v) for v in list(dev[str(steps)].values())
            + list(test.values())):
        fail(f"raw recipe: checkpoints {ckpts}, dev {dev}, test {test}")
    eval_launches = 2 * layers * math.ceil(n_test / 32)  # dev eval + cli/test
    serving = [launches["attention_block"], launches["ffn_block"]]
    if serving != [eval_launches] * 2:
        fail(f"raw recipe: serving kernels launched {serving} times, "
             f"expected {eval_launches} each")
    log("raw recipe: seconds " + ", ".join(f"{k} {v:.2f}"
                                           for k, v in seconds.items())
        + f"; launches {launches}; phase {time.perf_counter() - started:.1f} s "
        f"[{card}]")
    return launches


# ------------------------------------------------------- data parallelism
DP_TIMEOUT_S = 600
DP_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
# Phase 15b: two ranks against one process on the global batch (float32,
# dropout 0): the loss sum and gradients within the kernel-vs-plain limits
# (PATH_LOSS_REL, PATH_GRAD_REL), the BatchNorm running statistics within
# FACTOR_BN_TOL.
DP_ROWS, DP_RANKS = 32, 2
# Phase 15d profiles steps 4-9 of each rank (torch.profiler, the card's
# kernels) to set the ranks' kernel time beside their step time.
DP_PROFILE = dict(wait=3, warmup=1, active=6)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def torchrun_env(world, rank):
    """torchrun's variables for one rank of ``world`` on this host."""
    saved = {k: os.environ.get(k) for k in DP_ENV}
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_processes(cmds, label, timeout=DP_TIMEOUT_S, env=None):
    """Run the commands together; fail when one exits non-zero or the time
    runs out (every process is killed then). Returns their outputs."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for cmd in cmds]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                fail(f"{label}: timed out after {timeout} s")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"{label}: process {i} exited {p.returncode}:\n{out[-6000:]}")
    return outs


def dp_corpus(root, n_train, n_dev):
    """vocab.txt, train.pkl (20-100 chars: every bucket) and dev.pkl in
    ``root``; returns the cli/train data flags."""
    from realise_tpu_torch.data.dataset import synthetic_dataset
    from realise_tpu_torch.text.tokenizer import WordPieceTokenizer
    from realise_tpu_torch.text.vocab import (REAL_VOCAB_CJK_CHARS,
                                              build_synthetic_vocab,
                                              vocab_to_dict)

    vocab = build_synthetic_vocab(size=21128, cjk_chars=REAL_VOCAB_CJK_CHARS)
    tok = WordPieceTokenizer(vocab_to_dict(vocab))
    with open(os.path.join(root, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    for name, n, seed in (("train.pkl", n_train, SEED + 1500),
                          ("dev.pkl", n_dev, SEED + 1501)):
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump(synthetic_dataset(tok, num_examples=n, min_len=20,
                                          max_len=100, seed=seed), f)
    return ["--data_dir", root, "--train_file", "train.pkl", "--dev_file",
            "dev.pkl", "--dtype", "bfloat16", "--seed", str(SEED),
            "--logging_steps", "0", "--warmup_steps", "2"]


def checkpoint_bits(a, b):
    """The names of the checkpoint files (config, weights, trainer state)
    of dirs ``a`` and ``b`` whose contents differ."""
    import torch

    from realise_tpu_torch.training.checkpoint import (load_checkpoint,
                                                       load_trainer_state)

    def flat(obj, prefix=""):
        if isinstance(obj, dict):
            for k, v in obj.items():
                yield from flat(v, f"{prefix}{k}/")
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                yield from flat(v, f"{prefix}{i}/")
        else:
            yield prefix, obj

    def equal(x, y):
        if isinstance(x, torch.Tensor):
            return (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and torch.equal(x, y))
        return x == y

    bad = []
    with open(os.path.join(a, "config.json")) as f, \
            open(os.path.join(b, "config.json")) as g:
        if f.read() != g.read():
            bad.append("config.json")
    for name, load in (("model.pt", load_checkpoint),
                       ("trainer.pt", load_trainer_state)):
        x, y = dict(flat(load(a))), dict(flat(load(b)))
        if x.keys() != y.keys() or not all(equal(x[k], y[k]) for k in x):
            bad.append(name)
    return bad


def param_checksums(params):
    """One int64 checksum of each parameter's bits (a position-weighted sum
    of its int32 words, wrapping): equal bits, equal sums."""
    import torch

    out = []
    for p in params:
        words = p.detach().reshape(-1).view(torch.int32).to(torch.int64)
        weights = torch.arange(words.numel(), device=words.device) % 65521 + 1
        out.append((words * weights).sum())
    return torch.stack(out)


def dp_reference(model, batch, device, parts):
    """One process on the global batch, as ``parts`` data-parallel ranks
    compute it: each part's loss sum and gradient with its own BatchNorm
    batch statistics (the running statistics restarted for each part and
    averaged after), summed and divided by the global count. Returns the
    mean loss, the gradients and the running statistics."""
    import torch

    from realise_tpu_torch.data.features import to_device

    model.to(device).train()
    start = bn_state(model)
    rows = len(batch["src_idx"]) // parts
    loss_sum = count = 0.0
    after = []
    for i in range(parts):
        with torch.no_grad():
            for n, b in model.named_buffers():
                if n in start:
                    b.copy_(start[n])
        part = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        part.update(model.conv_rows(part["src_idx"]))
        out = model(to_device(part, device), use_kernels=True)
        out["loss_sum"].backward()
        loss_sum += out["loss_sum"].item()
        count += out["loss_count"].item()
        after.append(bn_state(model))
    grads = {n: p.grad / count for n, p in model.named_parameters()}
    stats = {n: sum(a[n] for a in after) / parts for n in start}
    return loss_sum / count, grads, stats


def dp_rank(rank, work, device_type="cuda"):
    """One of phase 15b-15c's two ranks on the one card (gloo, the library
    API; ``device_type`` "cpu" rehearses it on the CPU). Writes
    ``work/rank{rank}.json``."""
    import copy

    import numpy as np
    import torch
    import torch.distributed as dist

    from realise_tpu_torch.config import config_for
    from realise_tpu_torch.data.features import Featurizer, to_device
    from realise_tpu_torch.device import resolve_device
    from realise_tpu_torch.ops.kernels import bert_block as bb
    from realise_tpu_torch.ops.kernels import bert_block_train as tbt
    from realise_tpu_torch.ops.layers import dropout_generator
    from realise_tpu_torch.parallel.distributed import (gather_rows,
                                                        initialize, shutdown)
    from realise_tpu_torch.parallel.mesh import make_mesh
    from realise_tpu_torch.parallel.tensor import MeshGroups
    from realise_tpu_torch.text.tokenizer import WordPieceTokenizer
    from realise_tpu_torch.text.vocab import (REAL_VOCAB_CJK_CHARS,
                                              build_synthetic_vocab,
                                              vocab_to_dict)
    from realise_tpu_torch.training.trainer import Trainer

    os.environ["LOCAL_RANK"] = "0"  # both ranks on card 0
    initialize(f"file://{work}/store", DP_RANKS, rank, backend="gloo",
               device=device_type)
    out = {}
    try:
        device = resolve_device(None if device_type == "cuda" else device_type)
        solo = [dist.new_group([r]) for r in range(DP_RANKS)][rank]

        def mine(batch):
            return {k: v[rank * DP_ROWS:(rank + 1) * DP_ROWS]
                    for k, v in batch.items()}

        # 15b: float32, dropout 0, against one process on the global batch.
        cfg = config_for(ARCH3, vocab_size=21128, dtype="float32",
                         hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0)
        model = seeded_model(cfg, SEED + 20)
        reference = copy.deepcopy(model) if rank == 0 else None
        batch = train_batches(cfg, 1, DP_ROWS * DP_RANKS, SEED + 21)[0]
        tr = Trainer(cfg, model, device=device, max_grad_norm=None,
                     learning_rate=1e-5)
        loss = float(tr.train_step(mine(batch)))
        if rank == 0:
            want_loss, want_grads, want_stats = dp_reference(
                reference, batch, device, DP_RANKS)
            floor = 1e-4 * max(g.abs().max().item()
                               for g in want_grads.values())
            # The gradient as AdamW took it: its first moment after one
            # step over 0.1 (on the card p.grad stays the rank's sum).
            state = tr.optimizer.state
            grad_err = max(
                (state[p]["exp_avg"] / 0.1 - want_grads[n]).abs().max().item()
                / max(want_grads[n].abs().max().item(), floor)
                for n, p in tr.model.named_parameters())
            got_stats = bn_state(tr.model)
            out["15b"] = dict(
                loss=loss, want_loss=want_loss,
                loss_rel=abs(loss - want_loss) / abs(want_loss),
                grad_rel=grad_err,
                bn=max((got_stats[n] - s).abs().max().item()
                       for n, s in want_stats.items()))
            del want_grads, want_stats
        del tr, model, reference
        torch.cuda.empty_cache()

        # 15c: bfloat16 at the published dropout, three steps, twice.
        cfg = config_for(ARCH3, vocab_size=21128, dtype="bfloat16")
        model = seeded_model(cfg, SEED + 22)
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        batches = train_batches(cfg, 4, DP_ROWS * DP_RANKS, SEED + 23)
        wrappers = (bb.attention_block, bb.ffn_block) + tuple(tbt.KERNEL_WRAPPERS)
        calls = []
        for call in range(2):
            model.load_state_dict(sd)
            tr = Trainer(cfg, model, device=device, seed=SEED)
            if call == 0:
                for fn in wrappers:
                    fn.launches = 0
            sums, losses = [], []
            for b in batches[:3]:
                losses.append(float(tr.train_step(mine(b))))
                sums.append(param_checksums(tr.model.parameters()))
            if call == 0:
                launches = {fn.__name__: fn.launches for fn in wrappers}
            calls.append((losses, torch.stack(sums)))
        # Replicas: every step's checksums, gathered in rank order.
        both = gather_rows(calls[0][1][None]).cpu()
        out["15c"] = dict(
            losses=calls[0][0],
            replicas_equal=bool(torch.equal(both[0], both[1])),
            rerun_equal=(calls[0][0] == calls[1][0]
                         and bool(torch.equal(calls[0][1], calls[1][1]))))
        # The masks: both ranks' loss on the same rows, each drawn from its
        # rank's generator of one seed.
        tr.model.train()
        rows = {k: v[:DP_ROWS] for k, v in batches[0].items()}
        rows.update(tr.model.conv_rows(rows["src_idx"]))
        with torch.no_grad():
            masked = tr.model(to_device(rows, device), use_kernels=True,
                              generator=dropout_generator(SEED, rank))
        out["15c"]["mask_losses"] = gather_rows(
            masked["loss_sum"].float().reshape(1)).tolist()
        # The gathered eval against one process (a group of one) on the
        # global rows, through the (V, H) tables.
        vocab = build_synthetic_vocab(size=21128, cjk_chars=REAL_VOCAB_CJK_CHARS)
        feat = Featurizer(WordPieceTokenizer(vocab_to_dict(vocab)), cfg)
        eval_batch = batches[3]
        tr.prepare_eval_tables(feat)
        before = {fn.__name__: fn.launches for fn in wrappers}
        got = tr.eval_step(mine(eval_batch))
        for fn in wrappers:
            launches[fn.__name__] += fn.launches - before[fn.__name__]
        alone = Trainer(cfg, tr.model, device=device, mesh=MeshGroups(
            make_mesh({"data": 1}, world_size=1), data_group=solo))
        alone.prepare_eval_tables(feat)
        want = alone.eval_step(eval_batch)
        out["15c"].update(
            eval_equal=bool(np.array_equal(got["pred_idx"], want["pred_idx"])),
            eval_rows=int(got["pred_idx"].shape[0]),
            eval_loss=got["loss"], eval_loss_alone=want["loss"])
        out["launches"] = launches
    finally:
        shutdown()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def dp_cli_rank(work, argv):
    """One torchrun rank of phase 15's multi-card run: ``cli/train`` with
    each step timed to its end (a sync after it), its loss, the rows with a
    loss, the train kernels' launches and the CUDA-event time of its
    all-reduces (the flat copies and NCCL, from the end of the backward)
    recorded, the kernel time of steps 4-9 (``DP_PROFILE``; NCCL's
    kernels apart, since they include the wait for the other ranks), the
    CUDA-event time of the model group's reduces (phase 16e's tensor
    parallelism; 0 without a model axis) and the checkpoints the rank
    wrote. Writes ``work/rank{RANK}.json``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from realise_tpu_torch.cli import train as cli_train
    from realise_tpu_torch.ops.kernels import bert_block_train as tbt
    from realise_tpu_torch.parallel.distributed import shutdown
    from realise_tpu_torch.training import checkpoint
    from realise_tpu_torch.training.trainer import Trainer

    rec = {"steps": [], "writes": []}
    step, write = Trainer.train_step, checkpoint._write_checkpoint
    reduce = Trainer.all_reduce_sum
    events = []

    def all_reduce_sum(self, tensors):
        if self.device.type != "cuda":
            return reduce(self, tensors)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        reduce(self, tensors)
        end.record()
        events.append((start, end))

    prof = None
    model_reduces = ModelReduces()

    def train_step(self, batch):
        before = [fn.launches for fn in tbt.KERNEL_WRAPPERS]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        events.clear()
        model_reduces.take()
        t = time.perf_counter()
        loss = float(step(self, batch))  # reads back: synchronised
        rec["steps"].append(dict(
            seconds=time.perf_counter() - t, loss=loss,
            all_reduce_ms=sum(a.elapsed_time(b) for a, b in events),
            model_reduce_ms=model_reduces.take()[2],
            length=int(np.shape(batch["src_idx"])[1]),
            rows=int((np.asarray(batch["loss_masks"]).sum(1) > 0).sum()),
            launches=[fn.launches - n for fn, n in
                      zip(tbt.KERNEL_WRAPPERS, before)]))
        if prof is not None:
            prof.step()
        return loss

    def recording_write(ckpt_dir, *a):
        rec["writes"].append(os.path.basename(ckpt_dir))
        return write(ckpt_dir, *a)

    Trainer.train_step, checkpoint._write_checkpoint = train_step, recording_write
    Trainer.all_reduce_sum = all_reduce_sum
    try:
        model_reduces.__enter__()
        if torch.cuda.is_available():
            with profile(activities=[ProfilerActivity.CUDA],
                         schedule=schedule(repeat=1, **DP_PROFILE)) as prof:
                rc = cli_train.main(argv)
            kernels = nccl = 0.0
            for evt in prof.key_averages():
                us = (getattr(evt, "device_time_total", 0)
                      or getattr(evt, "cuda_time_total", 0))
                if "nccl" in evt.key.lower():
                    nccl += us / 1e3
                else:
                    kernels += us / 1e3
            rec["profiled"] = dict(kernel_ms=kernels, nccl_ms=nccl)
        else:
            rc = cli_train.main(argv)
    finally:
        model_reduces.__exit__()
        shutdown()
    rec["rc"] = rc
    rec["threads"] = torch.get_num_threads()
    with open(os.path.join(work, f"rank{os.environ['RANK']}.json"), "w") as f:
        json.dump(rec, f)
    return rc


def dp_scaling(card, root, data_flags, layers, cards):
    """Phase 15d: ``torchrun --nproc_per_node N`` of ``cli/train
    --distributed --mesh data=N --length_buckets 32,64,128`` at 64 rows a
    card on NCCL, for each N in ``cards``: every rank's loss trace equal,
    19 launches of each train kernel a step, the checkpoint written by rank
    0 alone; the step time and sentences/s after two warm-up steps."""
    import statistics as st

    from realise_tpu_torch.training.checkpoint import list_checkpoints

    steps = 12
    env = {k: v for k, v in os.environ.items() if k not in DP_ENV}
    rates = {}
    for n in cards:
        work = os.path.join(root, f"cards{n}")
        os.makedirs(work)
        argv = data_flags + [
            "--distributed", "--mesh", f"data={n}", "--length_buckets",
            ",".join(map(str, BUCKETS)), "--per_device_train_batch_size", "64",
            "--max_steps", str(steps), "--save_steps", "100000",
            "--do_train", "--output_dir",
            os.path.join(work, "out")]
        t = time.perf_counter()
        run_processes([[sys.executable, "-m", "torch.distributed.run",
                        "--standalone", f"--nproc_per_node={n}",
                        os.path.abspath(__file__), "dp-cli-rank", work] + argv],
                      f"data parallel: torchrun {n} cards", env=env)
        wall = time.perf_counter() - t
        ranks = []
        for r in range(n):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        traces = [[s["loss"] for s in rk["steps"]] for rk in ranks]
        if any(tr != traces[0] for tr in traces) or len(traces[0]) != steps:
            fail(f"data parallel: {n} cards: loss traces {traces}")
        bad = [s["launches"] for rk in ranks for s in rk["steps"]
               if s["launches"] != [layers] * 4]
        if bad:
            fail(f"data parallel: {n} cards: train kernels launched {bad[:4]}")
        writes = [rk["writes"] for rk in ranks]
        ckpts = [s for s, _ in list_checkpoints(os.path.join(work, "out"))]
        if writes[0] != [f"saved_ckpt-{steps}"] or any(writes[1:]) \
                or ckpts != [steps]:
            fail(f"data parallel: {n} cards: checkpoint writes {writes}, "
                 f"checkpoints {ckpts}")
        timed = ranks[0]["steps"][2:]
        secs = [max(rk["steps"][i]["seconds"] for rk in ranks)
                for i in range(2, steps)]
        sent = [sum(rk["steps"][i]["rows"] for rk in ranks)
                for i in range(2, steps)]
        rates[n] = (st.median(secs), sum(sent) / sum(secs))
        # A rank's all-reduce time holds its wait for the last rank to
        # arrive: the least over the ranks is the collective itself.
        reduce_ms = [[rk["steps"][i]["all_reduce_ms"] for rk in ranks]
                     for i in range(2, steps)]
        rank_ms = [1e3 * st.median(s["seconds"] for s in rk["steps"][2:])
                   for rk in ranks]
        first = DP_PROFILE["wait"] + DP_PROFILE["warmup"]
        window = range(first, first + DP_PROFILE["active"])
        profiled = [
            (rk["profiled"]["kernel_ms"], rk["profiled"]["nccl_ms"],
             1e3 * sum(rk["steps"][i]["seconds"] for i in window))
            for rk in ranks if "profiled" in rk]
        log(f"data parallel: {n} card(s), steps {window.start}-"
            f"{window.stop - 1} profiled, each rank's kernels / NCCL "
            f"kernels / step ms: " + "; ".join(
                f"{k:.3f} / {c:.3f} / {w:.3f}" for k, c, w in profiled)
            + f" [{card}]")
        log(f"data parallel: {n} card(s), torchrun {wall:.1f} s: losses "
            f"{traces[0]}; step lengths {[s['length'] for s in ranks[0]['steps']]}; "
            f"median step {1e3 * rates[n][0]:.3f} ms (each rank's median "
            f"{[round(x, 3) for x in rank_ms]}), all-reduce median "
            f"{st.median(min(r) for r in reduce_ms):.3f} ms least over the "
            f"ranks, {st.median(max(r) for r in reduce_ms):.3f} ms most; "
            f"{rates[n][1]:.1f} sentences/s over {len(timed)} steps; "
            f"{ranks[0]['threads']} torch threads a rank, {os.cpu_count()} "
            f"host cores [{card}]")
    base = rates[cards[0]][1]
    log("data parallel: sentences/s by cards " + ", ".join(
        f"{n}: {r:.1f} ({r / base:.2f}x)" for n, (_, r) in rates.items())
        + f" [{card}]")
    return {n: r for n, (_, r) in rates.items()}


def data_parallel(device, card):
    """Phase 15: data parallelism on the card. Returns the kernels' launches
    on its path (15a's distributed cli/train, 15c's steps and eval on both
    ranks) and 15d's sentences/s by card count ({} on one card)."""
    import math

    import torch

    from realise_tpu_torch.cli import train as cli_train
    from realise_tpu_torch.config import config_for
    from realise_tpu_torch.ops.kernels import bert_block as bb
    from realise_tpu_torch.ops.kernels import bert_block_train as tbt
    from realise_tpu_torch.parallel.distributed import shutdown

    started = time.perf_counter()
    wrappers = (bb.attention_block, bb.ffn_block) + tuple(tbt.KERNEL_WRAPPERS)
    layers = encoder_layers(config_for(ARCH3))
    with tempfile.TemporaryDirectory() as root:
        data_flags = dp_corpus(root, 4096, 64)
        if device.type == "cpu":  # a rehearsal of the phase on the CPU
            data_flags += ["--device", "cpu"]
        # 15a: cli/train --distributed --mesh data=1 on NCCL against the same
        # run without a process group: every checkpoint file's bits.
        argv = data_flags + ["--per_device_train_batch_size", "64",
                             "--max_steps", "4", "--save_steps", "2",
                             "--do_train", "--do_eval"]
        outs, seconds = {}, {}
        launches = None
        for label, extra in (("distributed", ["--distributed", "--mesh",
                                              "data=1"]), ("plain", [])):
            out = os.path.join(root, label)
            for fn in wrappers:
                fn.launches = 0
            t = time.perf_counter()
            with recorded_steps() as rec:
                if extra:
                    with torchrun_env(1, 0):
                        try:
                            rc = cli_train.main(argv + extra +
                                                ["--output_dir", out])
                        finally:
                            shutdown()
                else:
                    rc = cli_train.main(argv + ["--output_dir", out])
            seconds[label] = time.perf_counter() - t
            if rc != 0:
                fail(f"data parallel: cli/train ({label}) exited {rc}")
            outs[label] = check_steps(f"data parallel: cli/train ({label})",
                                      rec, 4, layers)
            if launches is None:
                launches = {fn.__name__: fn.launches for fn in wrappers}
        bad = {s: checkpoint_bits(os.path.join(root, "distributed",
                                               f"saved_ckpt-{s}"),
                                  os.path.join(root, "plain",
                                               f"saved_ckpt-{s}"))
               for s in (2, 4)}
        log(f"data parallel 15a: cli/train --distributed --mesh data=1 (NCCL) "
            f"{seconds['distributed']:.2f} s, without {seconds['plain']:.2f} s; "
            f"losses {outs['distributed']} / {outs['plain']}; checkpoint "
            f"files that differ {bad}; launches {launches} [{card}]")
        if any(bad.values()) or outs["distributed"] != outs["plain"]:
            fail(f"data parallel: a world of one on NCCL changed the bits: {bad}")
        serving_want = 2 * layers * math.ceil(64 / 32)  # two checkpoints
        if [launches["attention_block"], launches["ffn_block"]] \
                != [serving_want] * 2:
            fail(f"data parallel: serving kernels {launches}, expected "
                 f"{serving_want} each")

        # 15b-15c: two ranks on the one card (gloo), the library API.
        torch.cuda.empty_cache()
        work = os.path.join(root, "ranks")
        os.makedirs(work)
        t = time.perf_counter()
        run_processes([[sys.executable, os.path.abspath(__file__), "dp-rank",
                        str(r), work, device.type] for r in range(DP_RANKS)],
                      "data parallel: two ranks on one card")
        ranks = []
        for r in range(DP_RANKS):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        b, c = ranks[0]["15b"], ranks[0]["15c"]
        log(f"data parallel 15b: two ranks of {DP_ROWS} rows (gloo, one card) "
            f"against one process on {DP_ROWS * DP_RANKS}, f32 dropout 0, S=128: "
            f"loss {b['loss']:.6f} / {b['want_loss']:.6f} (relative "
            f"{b['loss_rel']:.2e}, tol {PATH_LOSS_REL}); worst gradient "
            f"relative {b['grad_rel']:.2e} (tol {PATH_GRAD_REL}); BN running "
            f"statistics {b['bn']:.2e} (tol {FACTOR_BN_TOL})")
        log(f"data parallel 15c: bf16 dropout {TRAIN_RATE}, 3 steps: losses "
            f"{c['losses']}; replicas equal {c['replicas_equal']} (rank 1 "
            f"{ranks[1]['15c']['replicas_equal']}); rerun equal "
            f"{c['rerun_equal']}; mask losses {c['mask_losses']}; gathered "
            f"eval of {c['eval_rows']} rows equal {c['eval_equal']}, loss "
            f"{c['eval_loss']:.6f} / {c['eval_loss_alone']:.6f}; ranks "
            f"{time.perf_counter() - t:.1f} s [{card}]")
        if (b["loss_rel"] > PATH_LOSS_REL or b["grad_rel"] > PATH_GRAD_REL
                or b["bn"] > FACTOR_BN_TOL):
            fail("data parallel: two ranks disagree with one process")
        if not (c["replicas_equal"] and ranks[1]["15c"]["replicas_equal"]
                and all(rk["15c"]["rerun_equal"] for rk in ranks)
                and c["mask_losses"][0] != c["mask_losses"][1]
                and all(rk["15c"]["eval_equal"] for rk in ranks)
                and c["eval_rows"] == DP_ROWS * DP_RANKS):
            fail("data parallel: the ranks' replicas, masks or eval broke "
                 "their contract")
        for rk in ranks:
            for name, n in rk["launches"].items():
                launches[name] += n
            if rk["launches"]["attention_train_forward"] != 3 * layers:
                fail(f"data parallel: a rank's steps launched {rk['launches']}")

        # 15d: the CLI on NCCL over several cards, when the host has them.
        count = torch.cuda.device_count()
        rates = {}
        if count >= 2:
            rates = dp_scaling(card, root, data_flags, layers,
                               [n for n in (1, 2, 4) if n <= count])
        else:
            log("data parallel 15d: skipped, one card (the multi-card "
                "torchrun runs need two or more)")
    log(f"data parallel: launches {launches}; phase "
        f"{time.perf_counter() - started:.1f} s [{card}]")
    return launches, rates


# Phase 16: tensor parallelism (the ``model`` axis) on the one card, each
# rank a process of a gloo group (NCCL refuses two ranks on one card).
# (a) and (d): data=1,model=2, float32, dropout 0, TP_ROWS rows at S=128;
# (c): data=2,model=2, TP_DP_ROWS rows a data rank at S=64. Each against
# one process on the plain path over the same rows (GSPMD semantics: the
# global batch's BatchNorm statistics): the loss and the clip's norm within
# TP_LOSS_REL relative, every gathered gradient and updated weight within
# TP_REL of its tensor's largest entry (the gradients' largest floored at
# 1e-4 of the largest over all tensors, as phase 15b floors them: the key
# biases' gradient is zero in exact arithmetic), the BN running statistics
# within FACTOR_BN_TOL. Adam's first steps move a weight by about the
# learning rate whatever the size of its gradient, so a skipped or
# sign-flipped update parts a weight from one process's by about lr or
# 2 lr, while two summation orders part it by far less, but where they
# disagree on the sign of a near-zero gradient (the key biases' gradient is
# all rounding noise), by up to 2 lr: so every updated weight lies within
# 2 lr of one process's, and at most TP_FLIP_SHARE of them further than
# TP_NEAR lr (the rule of tests/test_torch_tensor_parallel.py, which holds
# it to fail a skipped and a sign-flipped update of the split weights).
# The glyph stream's gradients pass the BatchNorm backward over its rows,
# whose mean subtractions cancel most of each sum, so the summation order
# of the gradient reaching them moves them more than the others (most with
# a data axis, whose ranks' parts the all-reduce adds; PERF.md §6): they
# take phase 8's PATH_GRAD_REL, the limit of those tensors where two
# float32 summation orders meet.
TP_ROWS, TP_DP_ROWS = 16, 8
TP_LOSS_REL, TP_REL, TP_LR, TP_FLIP_SHARE, TP_NEAR = 1e-5, 1e-4, 1e-5, 1e-3, 0.1
TP_BF16_STEPS = 3


class ModelReduces:
    """CUDA events around every collective of ``parallel/tensor.py`` (the
    model group's all-reduces, forward and backward, and its gathers): the
    module's ``dist`` swapped for a shim that times ``all_reduce``."""

    def __init__(self):
        self.events = []

    def __enter__(self):
        import torch
        import torch.distributed as dist

        from realise_tpu_torch.parallel import tensor

        events = self.events

        class Shim:
            def __getattr__(self, name):
                return getattr(dist, name)

            @staticmethod
            def all_reduce(t, *a, **kw):
                if t.device.type != "cuda":
                    return dist.all_reduce(t, *a, **kw)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                dist.all_reduce(t, *a, **kw)
                end.record()
                events.append((start, end, t.numel() * t.element_size()))

        self._module = tensor
        tensor.dist = Shim()
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        self._module.dist = dist

    def take(self):
        """(count, bytes, ms) of the reduces since the last call."""
        import torch

        if self.events:
            torch.cuda.synchronize()
        out = (len(self.events), sum(e[2] for e in self.events),
               sum(a.elapsed_time(b) for a, b, _ in self.events))
        self.events.clear()
        return out


@contextlib.contextmanager
def recorded_norms():
    """The norms the Trainer's clip returns, in order: the plain path's
    (``clip_by_global_norm``) and the kernel path's (``AdamW.clip``, a 0-d
    tensor that its step fills), as tensors: read each after its step."""
    from realise_tpu_torch.training import optim
    from realise_tpu_torch.training import trainer as trainer_module

    norms = []
    clip, kernel_clip = trainer_module.clip_by_global_norm, optim.AdamW.clip

    def recording(*a, **kw):
        norm = clip(*a, **kw)
        norms.append(norm)
        return norm

    def kernel_recording(self, *a, **kw):
        norm = kernel_clip(self, *a, **kw)
        norms.append(norm)
        return norm

    trainer_module.clip_by_global_norm = recording
    optim.AdamW.clip = kernel_recording
    try:
        yield norms
    finally:
        trainer_module.clip_by_global_norm = clip
        optim.AdamW.clip = kernel_clip


@contextlib.contextmanager
def recorded_masks():
    """(key, kept elements, the sum of their indices in the global array,
    head-split) of every dropout call of the BERT stacks and the model, in
    order: the mask is the call's dropout of ones."""
    import torch

    from realise_tpu_torch.models import realise as realise_module
    from realise_tpu_torch.ops import bert as bert_module
    from realise_tpu_torch.ops.layers import dropout, global_index

    calls = []

    def recording(x, rate, key, layout=None):
        kept = dropout(torch.ones(x.shape, device=x.device), rate, key,
                       layout) != 0
        idx = (torch.arange(x.numel(), device=x.device).reshape(x.shape)
               if layout is None else
               global_index(x.shape, *layout, device=x.device))
        calls.append((list(key), int(kept.sum()), int(idx[kept].sum()),
                      x.dim() == 4))
        return dropout(x, rate, key, layout)

    bert_module.dropout = realise_module.dropout = recording
    try:
        yield calls
    finally:
        bert_module.dropout = realise_module.dropout = dropout


def gathered_grads(tr):
    """Every parameter's gradient, the split ones gathered whole."""
    from realise_tpu_torch.parallel.tensor import gather_tensor

    return {n: (gather_tensor(p.grad, tr.splits[n], tr.groups.model_group)
                if n in tr.splits else p.grad.clone())
            for n, p in tr.model.named_parameters()}


def rel_errors(got, want, floor=0.0, rel=None, slack=0.0):
    """(max over tensors of (max |got - want| - ``slack``) / max(max |want|,
    floor), its name) over ``want``'s floating-point entries; with ``rel``
    also the share of all their elements further than ``rel`` · max |want|
    of their tensor."""
    worst, name, beyond, total = 0.0, None, 0, 0
    for n, w in want.items():
        if not w.is_floating_point():
            continue
        d = (got[n].float() - w.float()).abs()
        scale = max(w.float().abs().max().item(), floor, 1e-30)
        err = max(d.max().item() - slack, 0.0) / scale
        if err > worst:
            worst, name = err, n
        if rel is not None:
            beyond += int((d > rel * scale).sum())
            total += d.numel()
    if rel is None:
        return worst, name
    return worst, name, beyond / max(total, 1)


def weight_errors(got, want, lr):
    """(max |got - want| / ``lr``, its name, the share of the elements
    further than TP_NEAR · ``lr``) over ``want``'s floating-point entries
    but the BatchNorm running statistics (held apart)."""
    worst, name, beyond, total = 0.0, None, 0, 0
    for n, w in want.items():
        if not w.is_floating_point() or "running_" in n:
            continue
        d = (got[n].double() - w.double()).abs()
        err = d.max().item() / lr
        if err > worst:
            worst, name = err, n
        beyond += int((d > TP_NEAR * lr).sum())
        total += d.numel()
    return worst, name, beyond / max(total, 1)


def weights_agree(errors) -> bool:
    """:func:`weight_errors` within the limits: no weight beyond 2 lr, at
    most TP_FLIP_SHARE of them beyond TP_NEAR lr."""
    return errors[0] <= 2 and errors[2] <= TP_FLIP_SHARE


def mask_agreement(rank_masks, want_masks, model_size):
    """For each dropout call that :func:`recorded_masks` recorded in one
    process, whether the mesh's ranks (in rank order) drew its mask: their
    blocks' kept counts and global index sums add up to one process's. A
    head-split call's blocks are every rank's; a call on hidden rows has
    the same rows on a data index's model ranks, which must draw the same
    block, so its blocks are those of model index 0."""
    agree = []
    for i, (_, *want, heads) in enumerate(want_masks):
        got = [rk[i][1:3] for rk in rank_masks]
        blocks, same = got, True
        if not heads:
            blocks = got[::model_size]
            same = all(g == got[r - r % model_size] for r, g in enumerate(got))
        agree.append(same and [sum(b[0] for b in blocks),
                               sum(b[1] for b in blocks)] == want)
    return agree


def tp_step_check(mesh, rank, cfg, batch, device, second=None, work=None):
    """One float32 step of the rank's rows of ``batch`` under ``mesh``
    (16a, 16c) against one process on the plain path over all of them; on
    rank 0 the errors. With ``work`` (16d) the mesh's checkpoint after the
    step is loaded in one process, and both take a step on ``second``."""
    import copy

    import numpy as np
    import torch

    from realise_tpu_torch.parallel.distributed import local_slice
    from realise_tpu_torch.parallel.mesh import make_mesh
    from realise_tpu_torch.parallel.tensor import MeshGroups
    from realise_tpu_torch.training.checkpoint import (load_checkpoint,
                                                       load_trainer_state,
                                                       save_checkpoint)
    from realise_tpu_torch.training.trainer import Trainer

    model = seeded_model(cfg, SEED + 30)
    reference = copy.deepcopy(model) if rank == 0 else None
    kw = dict(learning_rate=TP_LR, max_grad_norm=1.0, device=device)
    d, n = mesh.data_index(rank), mesh.data

    def mine(b):
        return {k: np.asarray(local_slice(v, d, n)) for k, v in b.items()}

    with recorded_norms() as norms:
        tr = Trainer(cfg, model, mesh=mesh, **kw)
        if tr.use_kernels or not tr.tensor_parallel:
            fail(f"tensor parallel: a trainer under {mesh} has kernels "
                 f"{tr.use_kernels}, split {tr.tensor_parallel}")
        loss = float(tr.train_step(mine(batch)))
        norm = float(norms[-1])
        grads = gathered_grads(tr)
        weights = {k: v.clone() for k, v in tr.model_state_dict().items()}
        stats = bn_state(tr.model)
        if work is not None:
            ckpt = save_checkpoint(os.path.join(work, "tp_ckpt"), 1,
                                   tr.model_state_dict(), cfg,
                                   trainer_state=tr.state_dict())
            loss2 = float(tr.train_step(mine(second)))
            weights2 = tr.model_state_dict()
        res = {}
        if rank == 0:
            alone = MeshGroups(make_mesh({"data": 1}, world_size=1))
            ref = Trainer(cfg, reference, mesh=alone, use_kernels=False, **kw)
            want_loss = float(ref.train_step(batch))
            want_norm = float(norms[-1])
            want_grads = {n_: p.grad for n_, p in
                          ref.model.named_parameters()}
            floor = 1e-4 * max(g.abs().max().item()
                               for g in want_grads.values())
            glyph = {k for k in want_grads if k.startswith("resnet.")}
            grad_rel, grad_name = rel_errors(grads, {
                k: g for k, g in want_grads.items() if k not in glyph}, floor)
            conv_rel, conv_name = rel_errors(grads, {
                k: want_grads[k] for k in glyph}, floor)
            weight_lr, weight_name, flips = weight_errors(
                weights, ref.model.state_dict(), TP_LR)
            want_stats = bn_state(ref.model)
            res = dict(
                loss=loss, want_loss=want_loss,
                loss_rel=abs(loss - want_loss) / abs(want_loss),
                norm=norm, want_norm=want_norm,
                norm_rel=abs(norm - want_norm) / abs(want_norm),
                grad_rel=grad_rel, grad_name=grad_name, conv_rel=conv_rel,
                conv_name=conv_name, weight_lr=weight_lr,
                weight_name=weight_name, flips=flips,
                bn=max((stats[k] - s).abs().max().item()
                       for k, s in want_stats.items()))
            del want_grads
            if work is not None:
                ref.model.load_state_dict(load_checkpoint(ckpt))
                ref.load_state_dict(load_trainer_state(ckpt))
                want2 = float(ref.train_step(second))
                w_lr, w_name, w_flips = weight_errors(
                    weights2, ref.model.state_dict(), TP_LR)
                res["16d"] = dict(loss=loss2, one_process=want2,
                                  loss_rel=abs(loss2 - want2) / abs(want2),
                                  weight_lr=w_lr, weight_name=w_name,
                                  flips=w_flips)
            del ref
        del tr, model, reference, grads, weights
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return res


def tp_bf16(mesh, rank, cfg, batches, device):
    """16b: three bf16 steps at the published dropout under ``mesh``, twice
    from one init, each step's replicated weights' checksums gathered; the
    first step's dropout calls; the step time and the model group's
    reduces; then on rank 0 one process's three steps with the same seed
    (masks, weights) and the eval of both."""
    import copy

    import numpy as np
    import torch

    from realise_tpu_torch.data.features import to_device
    from realise_tpu_torch.parallel.distributed import gather_rows
    from realise_tpu_torch.parallel.mesh import make_mesh
    from realise_tpu_torch.parallel.tensor import MeshGroups
    from realise_tpu_torch.training.trainer import Trainer

    model = seeded_model(cfg, SEED + 31)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    reference = copy.deepcopy(model) if rank == 0 else None
    runs = []
    for call in range(2):
        model.load_state_dict(sd)
        tr = Trainer(cfg, model, device=device, seed=SEED, mesh=mesh)
        replicated = [p for n, p in tr.model.named_parameters()
                      if n not in tr.splits]
        losses, sums, secs, reduces = [], [], [], []
        masks = None
        with ModelReduces() as timer:
            for i, b in enumerate(batches[:TP_BF16_STEPS]):
                sync(device)
                timer.take()
                t = time.perf_counter()
                if i == 0 and call == 0:
                    with recorded_masks() as masks:
                        losses.append(float(tr.train_step(b)))
                else:
                    losses.append(float(tr.train_step(b)))
                secs.append(time.perf_counter() - t)
                reduces.append(timer.take())
                sums.append(param_checksums(replicated))
        runs.append(dict(losses=losses, sums=torch.stack(sums), masks=masks,
                         secs=secs, reduces=reduces))
    # Every step's replicated checksums, gathered in rank order.
    both = gather_rows(runs[0]["sums"][None]).cpu()
    res = dict(losses=runs[0]["losses"], secs=runs[0]["secs"],
               reduces=runs[0]["reduces"], masks=runs[0]["masks"],
               replicas_equal=bool(all(torch.equal(both[0], x)
                                       for x in both[1:])),
               rerun_equal=(runs[0]["losses"] == runs[1]["losses"] and bool(
                   torch.equal(runs[0]["sums"], runs[1]["sums"]))))
    weights = {k: v.clone() for k, v in tr.model_state_dict().items()}
    eval_batch = dict(batches[TP_BF16_STEPS])
    tr.model.eval()
    with torch.inference_mode():
        rows = dict(eval_batch)
        rows.update(tr.model.conv_rows(rows["src_idx"]))
        logits = tr.model(to_device(rows, device))["logits"]
    preds = tr.eval_step(eval_batch)["pred_idx"]
    if rank == 0:
        alone = MeshGroups(make_mesh({"data": 1}, world_size=1))
        ref = Trainer(cfg, reference, device=device, seed=SEED, mesh=alone,
                      use_kernels=False)
        want_losses, ref_secs = [], []
        for i, b in enumerate(batches[:TP_BF16_STEPS]):
            sync(device)
            t = time.perf_counter()
            if i == 0:
                with recorded_masks() as want_masks:
                    want_losses.append(float(ref.train_step(b)))
            else:
                want_losses.append(float(ref.train_step(b)))
            ref_secs.append(time.perf_counter() - t)
        lr = ref.schedule(0)
        weight_rel, weight_name, flips = rel_errors(
            weights, ref.model.state_dict(), rel=TRAIN_REL["bfloat16"],
            slack=2 * lr * TP_BF16_STEPS)
        ref.model.eval()
        with torch.inference_mode():
            want_logits = ref.model(to_device(rows, device))["logits"]
        want_preds = ref.eval_step(eval_batch)["pred_idx"]
        res.update(want_losses=want_losses, ref_secs=ref_secs,
                   want_masks=want_masks, weight_rel=weight_rel,
                   weight_name=weight_name, flips=flips,
                   loss_rel=max(abs(a - b) / abs(b) for a, b in
                                zip(res["losses"], want_losses)))
        valid = torch.as_tensor(np.asarray(eval_batch["masks"]),
                                device=device).bool()
        res["logit_diff"] = (logits.float() - want_logits.float()).abs()[
            valid].max().item()
        top2 = want_logits.float().topk(2, dim=-1).values
        clear = (valid & (top2[..., 0] - top2[..., 1] > LOGIT_TOL)).cpu()
        same = torch.as_tensor(preds == want_preds)
        res["eval_clear"] = int(clear.sum())
        res["eval_agree"] = same[clear].float().mean().item()
        res["eval_agree_all"] = same[valid.cpu()].float().mean().item()
        del ref
    return res


def tp_rank(rank, world, work, device_type="cuda"):
    """One rank of phase 16a-16d on the one card (gloo, the library API;
    ``device_type`` "cpu" rehearses it on the CPU): at world 2
    data=1,model=2 (16a with 16d, then 16b), at world 4 data=2,model=2
    (16c). Writes ``work/rank{rank}.json``."""
    import torch

    from realise_tpu_torch.config import config_for
    from realise_tpu_torch.device import resolve_device
    from realise_tpu_torch.ops.kernels import bert_block as bb
    from realise_tpu_torch.ops.kernels import bert_block_train as tbt
    from realise_tpu_torch.parallel.distributed import initialize, shutdown
    from realise_tpu_torch.parallel.mesh import make_mesh

    os.environ["LOCAL_RANK"] = "0"  # every rank on card 0
    initialize(f"file://{work}/store", world, rank, backend="gloo",
               device=device_type)
    wrappers = (bb.attention_block, bb.ffn_block) + tuple(tbt.KERNEL_WRAPPERS)
    for fn in wrappers:
        fn.launches = 0
    out = {}
    t0 = time.perf_counter()
    try:
        device = resolve_device(None if device_type == "cuda" else device_type)
        f32 = config_for(ARCH3, vocab_size=21128, dtype="float32",
                         hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0)
        if world == 2:
            mesh = make_mesh({"data": 1, "model": 2})
            batches = train_batches(f32, 2, TP_ROWS, SEED + 32)
            out["16a"] = tp_step_check(mesh, rank, f32, batches[0], device,
                                       second=batches[1], work=work)
            bf16 = config_for(ARCH3, vocab_size=21128, dtype="bfloat16")
            out["16b"] = tp_bf16(mesh, rank, bf16, train_batches(
                bf16, TP_BF16_STEPS + 1, TP_ROWS, SEED + 33), device)
        else:
            mesh = make_mesh({"data": 2, "model": 2})
            batch = train_batches(f32, 1, TP_DP_ROWS * 2, SEED + 34,
                                  seq_len=64)[0]
            out["16c"] = tp_step_check(mesh, rank, f32, batch, device)
        out["launches"] = {fn.__name__: fn.launches for fn in wrappers}
        out["seconds"] = time.perf_counter() - t0
        if device.type == "cuda":
            out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        shutdown()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def tp_scaling(card, root, data_flags, cards, dp_rates):
    """Phase 16e: ``torchrun --nproc_per_node N`` of ``cli/train
    --distributed --mesh data=N/2,model=2`` at 64 rows a data rank on NCCL
    for N = 2 and 4 (up to the count), 4 steps: every rank's loss trace
    equal within a data group, no kernel launched, the step time, the
    model group's reduces' CUDA-event ms and sentences/s beside phase 15d's
    data-only run on the same cards."""
    import statistics as st

    steps = 4
    env = {k: v for k, v in os.environ.items() if k not in DP_ENV}
    for n in cards:
        mesh = f"data={n // 2},model=2"
        work = os.path.join(root, f"tp_cards{n}")
        os.makedirs(work)
        argv = data_flags + [
            "--distributed", "--mesh", mesh,
            "--per_device_train_batch_size", "64", "--max_steps", str(steps),
            "--save_steps", "100000", "--do_train", "--output_dir",
            os.path.join(work, "out")]
        t = time.perf_counter()
        run_processes([[sys.executable, "-m", "torch.distributed.run",
                        "--standalone", f"--nproc_per_node={n}",
                        os.path.abspath(__file__), "dp-cli-rank", work] + argv],
                      f"tensor parallel: torchrun {n} cards", env=env)
        wall = time.perf_counter() - t
        ranks = []
        for r in range(n):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        traces = [[s["loss"] for s in rk["steps"]] for rk in ranks]
        if any(tr != traces[0] for tr in traces) or len(traces[0]) != steps:
            fail(f"tensor parallel: {n} cards ({mesh}): loss traces {traces}")
        if any(s["launches"] != [0] * 4 for rk in ranks for s in rk["steps"]):
            fail(f"tensor parallel: {n} cards: a train kernel launched")
        secs = [max(rk["steps"][i]["seconds"] for rk in ranks)
                for i in range(1, steps)]
        sent = [sum(rk["steps"][i]["rows"] for rk in ranks[::2])
                for i in range(1, steps)]
        model_ms = [st.median(rk["steps"][i]["model_reduce_ms"]
                              for i in range(1, steps)) for rk in ranks]
        rate = sum(sent) / sum(secs)
        dp = dp_rates.get(n)
        log(f"tensor parallel 16e: {n} cards, {mesh}, torchrun {wall:.1f} s: "
            f"losses {traces[0]} (every rank's); median step {1e3 * st.median(secs):.3f} ms; "
            f"model reduces a step (CUDA events, each rank's median) "
            f"{[round(x, 3) for x in model_ms]} ms; {rate:.1f} sentences/s "
            f"over {steps - 1} steps"
            + (f" (15d data={n}: {dp:.1f})" if dp else "") + f" [{card}]")


def tensor_parallel(device, card, dp_rates):
    """Phase 16: tensor parallelism on the card. Returns the kernels'
    launches on its path (none: a model axis runs the plain path)."""
    import torch

    started = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as root:
        for world, label in ((2, "data=1,model=2"), (4, "data=2,model=2")):
            torch.cuda.empty_cache()
            work = os.path.join(root, f"ranks{world}")
            os.makedirs(work)
            t = time.perf_counter()
            run_processes([[sys.executable, os.path.abspath(__file__),
                            "tp-rank", str(r), str(world), work, device.type]
                           for r in range(world)],
                          f"tensor parallel: {world} ranks on one card")
            ranks = []
            for r in range(world):
                with open(os.path.join(work, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
            log(f"tensor parallel: {world} ranks ({label}) "
                f"{time.perf_counter() - t:.1f} s, each rank's seconds "
                f"{[round(rk['seconds'], 1) for rk in ranks]}, peak GiB "
                f"{[round(rk.get('peak_gib', 0), 2) for rk in ranks]} [{card}]")
            for rk in ranks:
                for name, n in rk["launches"].items():
                    launches[name] = launches.get(name, 0) + n
            for key in ("16a", "16c"):
                if key in ranks[0]:
                    tp_step_report(key, label, ranks[0][key])
            if "16b" in ranks[0]:
                tp_bf16_report(label, [rk["16b"] for rk in ranks], card)
        if any(launches.values()):
            fail(f"tensor parallel: kernels launched under a model axis: "
                 f"{launches}")
        count = torch.cuda.device_count()
        if count >= 2:
            tp_scaling(card, root, dp_corpus(root, 1024, 64),
                       [n for n in (2, 4) if n <= count], dp_rates)
        else:
            log("tensor parallel 16e: skipped, one card (the multi-card "
                "torchrun runs need two or more)")
    log(f"tensor parallel: launches {launches}; phase "
        f"{time.perf_counter() - started:.1f} s [{card}]")
    return launches


def tp_step_report(key, label, r):
    rows = TP_ROWS if key == "16a" else f"2 x {TP_DP_ROWS}"
    conv_tol = PATH_GRAD_REL
    log(f"tensor parallel {key}: {label} against one process on {rows} rows, "
        f"f32 dropout 0: loss {r['loss']:.6f} / {r['want_loss']:.6f} "
        f"(relative {r['loss_rel']:.2e}, tol {TP_LOSS_REL}); clip norm "
        f"{r['norm']:.6f} / {r['want_norm']:.6f} (relative "
        f"{r['norm_rel']:.2e}, tol {TP_LOSS_REL}); worst gradient "
        f"{r['grad_name']} relative {r['grad_rel']:.2e} (tol {TP_REL}), of the "
        f"glyph stream {r['conv_name']} {r['conv_rel']:.2e} (tol {conv_tol}); "
        f"worst weight {r['weight_name']} {r['weight_lr']:.3f} lr (tol 2), "
        f"{r['flips']:.2e} of the weights beyond {TP_NEAR} lr (tol "
        f"{TP_FLIP_SHARE}); BN running statistics {r['bn']:.2e} (tol "
        f"{FACTOR_BN_TOL})")
    if (r["loss_rel"] > TP_LOSS_REL or r["norm_rel"] > TP_LOSS_REL
            or r["grad_rel"] > TP_REL or r["conv_rel"] > conv_tol
            or not weights_agree((r["weight_lr"], None, r["flips"]))
            or r["bn"] > FACTOR_BN_TOL):
        fail(f"tensor parallel {key}: the mesh disagrees with one process")
    if "16d" in r:
        d = r["16d"]
        log(f"tensor parallel 16d: the data=1,model=2 checkpoint in one "
            f"process, next step: loss {d['one_process']:.6f} against the "
            f"mesh's {d['loss']:.6f} (relative {d['loss_rel']:.2e}); worst "
            f"weight {d['weight_name']} {d['weight_lr']:.3f} lr (tol 2), "
            f"{d['flips']:.2e} of the weights beyond {TP_NEAR} lr (tol "
            f"{TP_FLIP_SHARE})")
        if (d["loss_rel"] > TP_LOSS_REL
                or not weights_agree((d["weight_lr"], None, d["flips"]))):
            fail("tensor parallel 16d: the checkpoint's next step disagrees")


def tp_bf16_report(label, ranks, card):
    b = ranks[0]
    keys = [m[0] for m in b["masks"]] == [m[0] for m in b["want_masks"]]
    model_ranks = len(ranks)
    kept = mask_agreement([rk["masks"] for rk in ranks], b["want_masks"],
                          len(ranks))
    n_red, n_bytes, red_ms = zip(*b["reduces"])
    log(f"tensor parallel 16b: {label}, bf16 dropout {TRAIN_RATE}, "
        f"{TP_BF16_STEPS} steps of {TP_ROWS} rows at S=128: losses "
        f"{b['losses']} / one process {b['want_losses']} (worst relative "
        f"{b['loss_rel']:.2e}); {len(b['masks'])} dropout calls of the first "
        f"step, keys equal {keys}, masks (kept count and index sum) equal "
        f"{sum(kept)}/{len(kept)}; worst weight "
        f"{b['weight_name']} relative {b['weight_rel']:.2e} beyond 2 lr a "
        f"step (tol {TRAIN_REL['bfloat16']}), {b['flips']:.2e} of the weights "
        f"beyond it; replicated weights the same bits "
        f"{[rk['replicas_equal'] for rk in ranks]}; rerun the same bits "
        f"{[rk['rerun_equal'] for rk in ranks]}; eval argmax agreement "
        f"{b['eval_agree']:.4%} over the {b['eval_clear']} tokens with a "
        f"top-2 margin above {LOGIT_TOL} ({b['eval_agree_all']:.4%} over "
        f"all), logits max diff {b['logit_diff']:.4f} (tol {LOGIT_TOL})")
    log(f"tensor parallel 16b: step seconds {[round(s, 4) for s in b['secs']]}"
        f" ({model_ranks} ranks, gloo), one process plain path "
        f"{[round(s, 4) for s in b['ref_secs']]}; model reduces a step "
        f"{list(n_red)}, {[round(x / 2 ** 20, 1) for x in n_bytes]} MiB, "
        f"CUDA-event ms {[round(x, 3) for x in red_ms]} [{card}]")
    if not (keys and all(kept) and all(rk["replicas_equal"] for rk in ranks)
            and all(rk["rerun_equal"] for rk in ranks)
            and b["loss_rel"] <= TRAIN_REL["bfloat16"]
            and b["weight_rel"] <= TRAIN_REL["bfloat16"]
            and b["flips"] <= TP_FLIP_SHARE and b["logit_diff"] <= LOGIT_TOL and b["eval_clear"] > 0
            and b["eval_agree"] >= ARGMAX_AGREE):
        fail("tensor parallel 16b: the mesh broke its bf16 contract")


# -------------------------------------------------------------------- main
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from realise_tpu_torch.config import config_for
    from realise_tpu_torch.device import resolve_device
    from realise_tpu_torch.ops.kernels._build import build

    started = time.perf_counter()
    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} (sm_{''.join(map(str, torch.cuda.get_device_capability(0)))}), "
        f"nvidia-smi: {card}")

    t = time.perf_counter()
    # One compiler each, together: nvcc for the kernels, g++ for the
    # featurizer.
    logs = build(["bert_block", "bert_block_train", "adamw", "masked_ce",
                  "batch_norm", "realise_featurizer"])
    log(f"build: {time.perf_counter() - t:.2f} s")
    for line in "".join(logs.values()).splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

    gen = torch.Generator().manual_seed(SEED)
    worst = check_kernels(device, gen)
    rows = time_kernels(device, gen, card)
    cfg = config_for("bert-pho2-res-arch3", vocab_size=21128, dtype="bfloat16")
    with tempfile.TemporaryDirectory() as ckpt_root:
        launches, corrector, requests = serve(device, cfg, gen, ckpt_root)
        native, _ = daemon(device, cfg, ckpt_root, corrector, card)
        check_featurizer(native, requests, card)
        check_reference_weights(device, cfg, corrector, ckpt_root, requests)
        check_batch_invariance(device, cfg, corrector, card)
        del corrector, native
    torch.cuda.empty_cache()
    worst_train = check_train_kernels(device, gen)
    rows.update(time_train_kernels(device, gen, card))
    time_backward_gemm(device, gen, card)
    update_row = update_kernels(device, card)
    ce_row = ce_kernels(device, card)
    bn_row = bn_kernels(device, card)
    train_launches, trainer = train(device, cfg, card)
    launches.update(train_launches)
    check_train_paths(device, cfg)
    check_factorized_paths(device, cfg)
    evaluate(device, cfg, trainer, card)
    check_stream_determinism(trainer, train_batches(cfg, 1, 32, SEED + 6)[0])
    del trainer
    torch.cuda.empty_cache()
    bucket_launches, worst_buckets = buckets(device, card, gen)
    for key, err in worst_buckets.items():
        worst_train[key] = max(worst_train[key], err)
    torch.cuda.empty_cache()
    resume(device, cfg, card)
    torch.cuda.empty_cache()
    presets(device, card)
    torch.cuda.empty_cache()
    for name, n in pretraining(device, card).items():
        launches[name] += n
    for name, n in bucket_launches.items():
        launches[name] += n
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as ckpt_root:
        for name, n in fullwidth(device, card, ckpt_root).items():
            launches[name] += n
    torch.cuda.empty_cache()
    for name, n in raw_recipe(device, card).items():
        launches[name] += n
    torch.cuda.empty_cache()
    dp_launches, dp_rates = data_parallel(device, card)
    for name, n in dp_launches.items():
        launches[name] += n
    torch.cuda.empty_cache()
    for name, n in tensor_parallel(device, card, dp_rates).items():
        launches[name] += n

    train_src = "realise_tpu/ops/pallas/bert_block_train.py"
    sources = {"attention_block": "realise_tpu/ops/pallas/bert_block.py:67",
               "ffn_block": "realise_tpu/ops/pallas/bert_block.py:162",
               "attention_train_forward": f"{train_src}:226",
               "attention_train_backward": f"{train_src}:356",
               "ffn_train_forward": f"{train_src}:737",
               "ffn_train_backward": f"{train_src}:821"}
    kernels = [dict(name=name, route="cuda",
                    source=("realise_tpu_torch/csrc/bert_block.cu"
                            if name in ("attention_block", "ffn_block") else
                            "realise_tpu_torch/csrc/bert_block_train.cu"),
                    replaces=src, launches=launches[name], **rows[name])
               for name, src in sources.items()]
    kernels.append(dict(name="clip_adamw", route="cuda",
                        source="realise_tpu_torch/csrc/adamw.cu",
                        replaces=None, launches=launches["clip_adamw"],
                        **update_row))
    kernels.append(dict(name="masked_ce", route="cuda",
                        source="realise_tpu_torch/csrc/masked_ce.cu",
                        replaces=None, launches=launches["masked_ce"],
                        **ce_row))
    kernels.append(dict(name="batch_norm", route="cuda",
                        source="realise_tpu_torch/csrc/batch_norm.cu",
                        replaces=None, launches=launches["batch_norm"],
                        **bn_row))
    log("worst |kernel-plain| over the checks: " + ", ".join(
        f"{k} {d} {v:.3e}" for (k, d), v in sorted(worst.items())))
    log("worst relative |kernel-plain| of the train kernels: " + ", ".join(
        f"{k} {d} {v:.3e}" for (k, d), v in sorted(worst_train.items())))
    log(f"all phases passed in {time.perf_counter() - started:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    # Phase 15's and 16's own processes: a rank of 15b-15c, a torchrun rank
    # of 15d and 16e, a rank of 16a-16d.
    if sys.argv[1:2] == ["dp-rank"]:
        dp_rank(int(sys.argv[2]), sys.argv[3], *sys.argv[4:5])
        sys.exit(0)
    if sys.argv[1:2] == ["tp-rank"]:
        tp_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                *sys.argv[5:6])
        sys.exit(0)
    if sys.argv[1:2] == ["dp-cli-rank"]:
        sys.exit(dp_cli_rank(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
