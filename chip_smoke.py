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
   kernel name); every loss must be finite and every encoder layer must have
   gone through the four train kernels each step; then the split of a B=32
   and a B=256 step by stream (CUDA events around each part) on the
   factorized and on the per-token path, with kernel time, host clock and
   peak memory; then, in float32 at dropout 0 on one B=32 batch, the kernel
   path's loss and gradients must agree with the plain path's, and the
   factorized streams' loss, gradients and BatchNorm statistics with the
   per-token streams'; two bf16 backward calls must give the same bits for
   every gradient (the pinyin embeddings, the GRU and the CharResNet too);
9. eval and scoring: the trained model saved as a port checkpoint, loaded
   as ``cli/test`` loads it and scored by ``cli.common.evaluate_model`` on
   1024 synthetic sentences in batches of 32 with the serving kernels
   (19 launches of each per batch); metrics finite, files written, and the
   kernel path's argmax equal to the plain path's on >= 99% of the clearly
   decided tokens of one batch.

The last three lines are the kernels' JSON record (all six kernels), the
card's name and power limit as nvidia-smi prints them, and the run's JSON
result.
"""

from __future__ import annotations

import contextlib
import json
import os
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


def kernel_breakdown(fn, iters=5):
    """[(ms per call, CUDA kernel name)] of fn from torch.profiler, largest
    first; empty if the profiler recorded no device time. One more call of
    fn goes first, in the schedule's warm-up step: a trace loses or clips
    kernels at its start (a B=256 backward profile once lacked the first
    product of all its calls, and 3-call profiles read the first call's
    first launch as nothing, PERF.md §6)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=iters,
                                   repeat=1)) as prof:
        for i in range(iters + 1):
            fn()
            if i == iters:
                torch.cuda.synchronize()
            prof.step()
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", 0) or getattr(evt, "cuda_time_total", 0)
        if us > 0:
            rows.append((us / iters / 1e3, evt.key))
    return sorted(rows, reverse=True)


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
                parts = kernel_breakdown(kern)
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


def serve(device, cfg, gen, batch_size=32, requests=((1, 16, 28), (8, 40, 60),
                                                       (32, 90, 120))):
    """Phase 5: save a seeded full-width checkpoint, serve requests through
    the Corrector, check launches and outputs. Returns the launch counts."""
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
    layers = (cfg.num_hidden_layers + cfg.pho_num_layers + cfg.out_num_layers)
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, 0, model.state_dict(), cfg)
        del model
        t1 = time.perf_counter()
        corrector = Corrector(tmp, synthetic_vocab=True, batch_size=batch_size,
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
        parts = kernel_breakdown(lambda: corrector.logits(arrays).argmax(-1))
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
    return launches


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


def check_train_kernels(device, gen):
    """Phase 6: the train kernels against their plain versions; returns the
    worst relative error per (kernel, dtype)."""
    import torch

    from realise_tpu_torch.ops.kernels import bert_block_train as tbt

    worst = {}
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for b, s, lengths in ((8, 128, (128, 100, 128, 64, 128, 7, 128, 128)),
                              (4, 37, (37, 20, 37, 5))):
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
                parts = kernel_breakdown(kern, iters=3)
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


# ---------------------------------------------------------------- training
def train_batches(cfg, n, batch_size, seed):
    """``n`` host batches of synthetic sentences (20-100 chars, the JAX
    package's bench data) featurized at bucket 128 through the Featurizer."""
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
    return [feat.device_batch(feat.featurize(
        data[i * batch_size:(i + 1) * batch_size], seq_len=128))
        for i in range(n)]


def seeded_model(cfg, seed):
    """Seeded weights, the procedural glyph table of the synthetic vocab
    (non-CJK tokens share the zero image, as in the real vocab) and its
    pinyin tables: the tables the training CLI installs."""
    import torch

    from realise_tpu_torch.data.features import Featurizer
    from realise_tpu_torch.models.realise import Realise
    from realise_tpu_torch.text.glyphs import build_glyph_table
    from realise_tpu_torch.text.tokenizer import WordPieceTokenizer
    from realise_tpu_torch.text.vocab import (REAL_VOCAB_CJK_CHARS,
                                              build_synthetic_vocab,
                                              vocab_to_dict)

    vocab = build_synthetic_vocab(size=cfg.vocab_size,
                                  cjk_chars=REAL_VOCAB_CJK_CHARS)
    model = Realise(cfg, generator=torch.Generator().manual_seed(seed))
    model.install_glyphs(build_glyph_table(
        vocab, num_fonts=cfg.num_fonts,
        use_traditional_font=cfg.use_traditional_font))
    feat = Featurizer(WordPieceTokenizer(vocab_to_dict(vocab)), cfg)
    model.install_pho_vocab_tables(*feat.pho2_tables())
    return model


class StepSplit:
    """CUDA events around each part of a training step that the model and
    the Trainer bracket (``Realise.span``), summed by name."""

    def __init__(self):
        self.events = []

    @contextlib.contextmanager
    def span(self, name):
        import torch

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self.events.append((name, start, end))

    def totals(self):
        import torch

        torch.cuda.synchronize()
        out = {}
        for name, start, end in self.events:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out


def step_split(trainer, batch, label, card):
    """A warm-up step of ``trainer`` on ``batch`` (cuDNN plans its
    convolutions for new shapes on the host), one step with its parts timed,
    then one under the profiler; returns {'parts': {part: ms}, 'step_ms',
    'host_ms', 'kernel_ms', 'peak_gib', 'loss'} and logs them with the rows
    each stream ran."""
    import numpy as np
    import torch

    model = trainer.model
    b, s = np.asarray(batch["src_idx"]).shape
    if trainer.per_token_streams:
        conv_rows = gru_rows = f"{b * s}"
    else:
        rows = model.conv_rows(batch["src_idx"])["res_rows"]
        conv_rows = f"{len(np.unique(rows))} (bucket {len(rows)})"
        gru_rows = f"{min(model.pho_uniq_idx.shape[0], b * s)}"
    device = next(model.parameters()).device
    trainer.train_step(batch)
    split, plain_span = StepSplit(), model.span
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
    parts = split.totals()
    step_ms = parts.pop("step")
    kernel_ms = sum(ms for ms, _ in kernel_breakdown(
        lambda: trainer.train_step(batch), iters=1))
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    log(f"split {label} B={b}: conv rows {conv_rows}, GRU rows {gru_rows} "
        f"(of {b * s} token slots); step {step_ms:.3f} ms on the device "
        f"(events), {host_ms:.3f} ms on the host clock, {b / host_ms * 1e3:.1f} "
        f"sentences/s; profiled step {kernel_ms:.3f} ms of kernels; peak "
        f"memory {peak:.2f} GiB; loss {loss:.6f} [{card}]")
    log(f"  split {label} B={b}: " + ", ".join(
        f"{name} {ms:.3f}" for name, ms in parts.items())
        + f", rest {step_ms - sum(parts.values()):.3f} ms")
    return dict(parts=parts, step_ms=step_ms, host_ms=host_ms,
                kernel_ms=kernel_ms, peak_gib=peak, loss=loss,
                conv_rows=conv_rows, gru_rows=gru_rows)


def train(device, cfg, card):
    """Phase 8: the Trainer at full width in bf16 on the factorized streams;
    then the per-stream split of a B=32 and a B=256 step on the factorized
    and on the per-token path. Returns (the launches of the train kernels
    over the main run, the trainer)."""
    import math

    import torch

    from realise_tpu_torch.ops.kernels import bert_block_train as tbt
    from realise_tpu_torch.training.trainer import Trainer

    layers = cfg.num_hidden_layers + cfg.pho_num_layers + cfg.out_num_layers
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
    for fn in tbt.KERNEL_WRAPPERS:
        fn.launches = 0
    for b, batches in ((32, small), (256, large)):
        torch.cuda.reset_peak_memory_stats(device)
        times = []
        for i, batch in enumerate(batches):
            before = [fn.launches for fn in tbt.KERNEL_WRAPPERS]
            sync(device)
            t = time.perf_counter()
            loss = float(trainer.train_step(batch))  # reads back: synchronised
            dt = time.perf_counter() - t
            per_step = [fn.launches - n for fn, n in zip(tbt.KERNEL_WRAPPERS,
                                                         before)]
            warm = b == 32 and i == 0
            log(f"train: B={b} step {trainer.step}{' (warm-up)' if warm else ''}"
                f": loss {loss:.6f}, {1e3 * dt:.3f} ms, {b / dt:.1f} sentences/s,"
                f" launches {per_step}")
            if not math.isfinite(loss):
                fail(f"non-finite loss at step {trainer.step}")
            if per_step != [layers] * 4:
                fail(f"train kernels launched {per_step} times in a step, "
                     f"expected {layers} each")
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
    before = [fn.launches for fn in tbt.KERNEL_WRAPPERS]
    t = time.perf_counter()
    parts = kernel_breakdown(lambda: trainer.train_step(large[-1]), iters=1)
    dt = (time.perf_counter() - t) / 2
    if [fn.launches - n for fn, n in zip(tbt.KERNEL_WRAPPERS, before)] != \
            [2 * layers] * 4:
        fail("the profiled steps missed a train kernel launch")
    busy = sum(ms for ms, _ in parts)
    log(f"train: profiled B=256 step: {busy:.3f} ms of kernels in "
        f"{1e3 * dt:.3f} ms on the host clock (profiler on), "
        f"{len(parts)} kernel names")
    for part_ms, kname in parts[:16]:
        log(f"  profile train step: {part_ms:.4f} ms {kname[:100]}")
    launches = {fn.__name__: fn.launches for fn in tbt.KERNEL_WRAPPERS}

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
    log(f"train paths f32 dropout 0 B=32: loss_sum kernel {loss_k:.6f} plain "
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


def check_stream_determinism(trainer, batch):
    """Two bf16 forward + backward calls of the trained model on one B=32
    batch, the Trainer's route and one dropout seed: every gradient, those
    of the pinyin embeddings, the GRU and the CharResNet among them, must be
    the same bits."""
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
    log(f"determinism bf16 B=32: two backward calls give the same gradient "
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
    layers = cfg.num_hidden_layers + cfg.pho_num_layers + cfg.out_num_layers
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


# -------------------------------------------------------------------- main
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from realise_tpu_torch.config import config_for
    from realise_tpu_torch.device import resolve_device
    from realise_tpu_torch.ops.kernels._build import build

    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} (sm_{''.join(map(str, torch.cuda.get_device_capability(0)))}), "
        f"nvidia-smi: {card}")

    t = time.perf_counter()
    logs = build(["bert_block", "bert_block_train"])  # one nvcc each, together
    log(f"build: {time.perf_counter() - t:.2f} s")
    for line in "".join(logs.values()).splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

    gen = torch.Generator().manual_seed(SEED)
    worst = check_kernels(device, gen)
    rows = time_kernels(device, gen, card)
    cfg = config_for("bert-pho2-res-arch3", vocab_size=21128, dtype="bfloat16")
    launches = serve(device, cfg, gen)
    worst_train = check_train_kernels(device, gen)
    rows.update(time_train_kernels(device, gen, card))
    time_backward_gemm(device, gen, card)
    train_launches, trainer = train(device, cfg, card)
    launches.update(train_launches)
    check_train_paths(device, cfg)
    check_factorized_paths(device, cfg)
    evaluate(device, cfg, trainer, card)
    check_stream_determinism(trainer, train_batches(cfg, 1, 32, SEED + 6)[0])

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
    log("worst |kernel-plain| over the checks: " + ", ".join(
        f"{k} {d} {v:.3e}" for (k, d), v in sorted(worst.items())))
    log("worst relative |kernel-plain| of the train kernels: " + ", ".join(
        f"{k} {d} {v:.3e}" for (k, d), v in sorted(worst_train.items())))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
