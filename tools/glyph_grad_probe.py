#!/usr/bin/env python3
"""How far the CharResNet's float32 weight gradients move, on the card.

    python3 tools/glyph_grad_probe.py      # from the repository root; one card

A ``pho2-res-pretrain`` model (random weights and glyphs, dropout 0) takes
four float32 forward + backward calls on one batch: twice on the kernel
path, twice on the plain path. For each setting it prints the worst
gradient difference, relative to each tensor's largest |value| (floored at
1e-4 of the largest over all tensors, chip_smoke.py's rule), and the tensor
it is in: kernel path against plain path, and each path against itself.
The settings: cuDNN's TF32 convolutions on (PyTorch's default) or off (what
``device.resolve_device`` sets), cuDNN's deterministic algorithms off or on,
at a batch of 3 x 37 (H=128), 32 x 128 (H=128) and 32 x 128 at the
published widths (H=768, V=21128).

The CharResNet's weight gradients pass the BatchNorm backward, whose mean
subtractions cancel most of each sum: the probe says how much of a
kernel-vs-plain difference there is rounding upstream, TF32 or cuDNN's
call-to-call order.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from realise_tpu_torch.config import config_for  # noqa: E402
from realise_tpu_torch.models.realise import RealisePretrain  # noqa: E402


def worst(got, want):
    floor = 1e-4 * max(g.abs().max().item() for g in want.values())
    return max(((got[n] - g).abs().max().item()
                / max(g.abs().max().item(), floor), n)
               for n, g in want.items())


def probe(device, b, s, vocab, hidden):
    cfg = config_for("pho2-res-pretrain", vocab_size=vocab, hidden_size=hidden,
                     num_attention_heads=hidden // 64,
                     intermediate_size=4 * hidden if hidden == 768 else 2 * hidden,
                     pho_num_layers=4 if hidden == 768 else 2, num_fonts=1,
                     hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    gen = torch.Generator().manual_seed(0)
    model = RealisePretrain(cfg, generator=gen)
    model.install_glyphs((torch.rand(model.char_images_multifonts.shape,
                                     generator=gen) < 0.5).float())
    model = model.to(device)
    rng = np.random.RandomState(2)
    p = cfg.pho2_max_len
    masks = np.ones((b, s), np.int64)
    masks[1, s // 2:] = 0
    src = rng.randint(0, vocab, (b, s))
    batch = {"src_idx": src, "tgt_idx": src, "masks": masks,
             "loss_masks": masks * (rng.rand(b, s) < 0.8),
             "pho_idx": rng.randint(1, 30, (b, s, p)),
             "pho_lens": rng.randint(0, p + 1, (b, s))}
    batch = {k: torch.as_tensor(v, dtype=torch.long, device=device)
             for k, v in batch.items()}
    state = {k: v.clone() for k, v in model.state_dict().items()}
    grads = []
    for use_kernels in (True, True, False, False):
        model.load_state_dict(state)
        model.train().zero_grad(set_to_none=True)
        out = model(batch, use_kernels=use_kernels,
                    generator=torch.Generator().manual_seed(0))
        out["loss_sum"].backward()
        grads.append({n: q.grad.clone() for n, q in model.named_parameters()})
    return (worst(grads[0], grads[2]), worst(grads[0], grads[1]),
            worst(grads[2], grads[3]))


def main() -> int:
    if not torch.cuda.is_available():
        print("glyph_grad_probe: CUDA is not available")
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    for tf32 in (True, False):
        for deterministic in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cudnn.deterministic = deterministic
            for b, s, vocab, hidden in ((3, 37, 300, 128), (32, 128, 8192, 128),
                                        (32, 128, 21128, 768)):
                kp, kk, pp = probe(device, b, s, vocab, hidden)
                print(f"cudnn tf32 {tf32}, deterministic {deterministic}, "
                      f"B={b} S={s} H={hidden}: kernel vs plain {kp[0]:.2e} "
                      f"({kp[1]}), kernel vs kernel {kk[0]:.2e} ({kk[1]}), "
                      f"plain vs plain {pp[0]:.2e} ({pp[1]}) [{card}]",
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
