#!/usr/bin/env python3
"""Where a full-width training step's time goes, by stream, on one GPU.

    python3 tools/stream_split.py [--paths per_token,factorized]

The published arch3 preset in bfloat16 at its published dropout (0.1),
seeded weights, the procedural glyph table and the pinyin tables of the
synthetic vocab, synthetic sentences of 20-100 chars at bucket 128 (the
batches of ``chip_smoke.py``'s training phase), the fused train kernels on.
For each path (``per_token``: both streams over every token slot;
``factorized``: over the distinct rows, as the Trainer runs them) and
B = 32 and 256: a warm-up step, then one step with CUDA events around each
part of it (``chip_smoke.step_split``: the semantic BERT, the glyph gather +
CharResNet + LayerNorm, the GRU, the pho BERT, the fusion + output block, the
head + CE forward, the backward, the clip + AdamW), then one under the
profiler for its kernel time, and the peak memory. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--paths", default="per_token,factorized")
    args = p.parse_args(argv)
    import torch

    from realise_tpu_torch.config import config_for
    from realise_tpu_torch.device import resolve_device
    from realise_tpu_torch.ops.kernels._build import build
    from realise_tpu_torch.training.trainer import Trainer

    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    build(["bert_block_train"])
    cfg = config_for("bert-pho2-res-arch3", vocab_size=21128, dtype="bfloat16")
    batches = {32: chip_smoke.train_batches(cfg, 1, 32, chip_smoke.SEED)[0],
               256: chip_smoke.train_batches(cfg, 1, 256, chip_smoke.SEED + 1)[0]}
    for path in args.paths.split(","):
        trainer = Trainer(cfg, chip_smoke.seeded_model(cfg, chip_smoke.SEED),
                          learning_rate=5e-5, warmup_steps=2, total_steps=100,
                          weight_decay=0.01, max_grad_norm=1.0, device=device,
                          seed=chip_smoke.SEED,
                          per_token_streams=(path == "per_token"))
        for batch in batches.values():
            chip_smoke.step_split(trainer, batch, path, card)
        del trainer
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
