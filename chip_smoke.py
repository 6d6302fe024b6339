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
5. serving at full width: the published arch3 preset with seeded random
   weights and glyphs, saved as a port checkpoint and served by
   ``realise_tpu_torch.serving.Corrector`` on the card for requests of 1, 8
   and 32 sentences (length buckets 32, 64, 128); every encoder layer must
   have gone through both kernels, and the kernel path's logits must agree
   with the plain path's.

The last two lines are the kernels' JSON record and the run's JSON result.
"""

from __future__ import annotations

import json
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


def attention_library(x, p, bias, eps=1e-12):
    """One PyTorch route to the same function: matmul projections, SDPA,
    layer_norm. Timed as a yardstick only."""
    import torch
    import torch.nn.functional as F

    b, s, h = x.shape
    qkv = torch.matmul(x, p["qkv_weight"].t()) + p["qkv_bias"].to(x.dtype)
    q, k, v = (t.view(b, s, HEADS, h // HEADS).transpose(1, 2)
               for t in qkv.split(h, dim=-1))
    ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    attn = torch.matmul(ctx.transpose(1, 2).reshape(b, s, h),
                        p["out_weight"].t()) + p["out_bias"].to(x.dtype)
    return F.layer_norm(x + attn, (h,), p["ln_weight"].to(x.dtype),
                        p["ln_bias"].to(x.dtype), eps)


def ffn_library(x, p, eps=1e-12):
    import torch.nn.functional as F

    t = F.gelu(F.linear(x, p["w1"], p["b1"].to(x.dtype)))
    out = F.linear(t, p["w2"], p["b2"].to(x.dtype))
    return F.layer_norm(x + out, (x.shape[-1],), p["ln_weight"].to(x.dtype),
                        p["ln_bias"].to(x.dtype), eps)


def kernel_breakdown(fn, iters=5):
    """[(ms per call, CUDA kernel name)] of fn from torch.profiler, largest
    first; empty if the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
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

    # Where the largest request's time goes: host clock, each part ending
    # synchronised (the device step ends in a copy of the ids to the host).
    sents = batches[-1]
    t0 = time.perf_counter()
    host = corrector.featurizer.featurize_raw(sents, seq_len=128)
    arrays = corrector.featurizer.device_batch(host)
    t1 = time.perf_counter()
    host["pred_idx"] = corrector._device_step(arrays)
    t2 = time.perf_counter()
    for i, src in enumerate(sents):
        corrector._reconstruct(src, host, i)
    t3 = time.perf_counter()
    log(f"serve: request of {len(sents)} sentences split: featurize "
        f"{1e3 * (t1 - t0):.3f} ms, device step {1e3 * (t2 - t1):.3f} ms, "
        f"reconstruct {1e3 * (t3 - t2):.3f} ms")
    parts = kernel_breakdown(lambda: corrector.logits(arrays).argmax(-1))
    busy = sum(ms for ms, _ in parts)
    log(f"serve: device step kernels {busy:.3f} ms, "
        f"{busy / (1e3 * (t2 - t1)):.1%} of the step's host-clock time")
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
    valid = batch["masks"].bool()
    diff = (got.float() - want.float()).abs()[valid].max().item()
    same = got.argmax(-1) == want.argmax(-1)
    top2 = want.float().topk(2, dim=-1).values
    clear = valid & (top2[..., 0] - top2[..., 1] > LOGIT_TOL)
    agree = same[clear].float().mean().item()
    log(f"serve: kernel vs plain path logits max diff {diff:.4f} (tol "
        f"{LOGIT_TOL}); argmax agreement {agree:.4%} (need "
        f"{ARGMAX_AGREE:.0%}) over the {int(clear.sum())} of "
        f"{int(valid.sum())} valid tokens with a top-2 margin above "
        f"{LOGIT_TOL}, {same[valid].float().mean().item():.4%} over all")
    if diff > LOGIT_TOL or not clear.any() or agree < ARGMAX_AGREE:
        fail("kernel path disagrees with the plain path")
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
    logs = build(["bert_block"])
    log(f"build: {time.perf_counter() - t:.2f} s")
    for line in "".join(logs.values()).splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

    gen = torch.Generator().manual_seed(SEED)
    worst = check_kernels(device, gen)
    rows = time_kernels(device, gen, card)
    cfg = config_for("bert-pho2-res-arch3", vocab_size=21128, dtype="bfloat16")
    launches = serve(device, cfg, gen)

    sources = {"attention_block": "realise_tpu/ops/pallas/bert_block.py:67",
               "ffn_block": "realise_tpu/ops/pallas/bert_block.py:162"}
    kernels = [dict(name=name, route="cuda",
                    source="realise_tpu_torch/csrc/bert_block.cu",
                    replaces=sources[name], launches=launches[name],
                    **rows[name]) for name in sources]
    log("worst |kernel-plain| over the checks: " + ", ".join(
        f"{k} {d} {v:.3e}" for (k, d), v in sorted(worst.items())))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
