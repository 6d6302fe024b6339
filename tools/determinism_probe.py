#!/usr/bin/env python3
"""Which parts of a bf16 training step are not deterministic on the card.

    python3 tools/determinism_probe.py

The published arch3 preset in bfloat16 at dropout 0.1, seeded weights, the
procedural glyph table and the pinyin tables of the synthetic vocab, the
fused train kernels on (the training phase of ``chip_smoke.py``):

1. the library op: ``embedding_dense_backward`` (the backward of
   ``F.embedding``) and the one-hot product of ``table_gather`` called
   twice on one float32 cotangent, for the gathers of a step (the token
   types, the pinyin symbols, the positions, the GRU and conv tables, the
   word embeddings) at B=32 and B=256: whether the two calls give the same
   bits;
2. two forward + backward calls on one B=32 batch with one dropout seed, on
   the per-token and on the factorized streams, with cuDNN's default
   algorithms and with ``torch.backends.cudnn.deterministic``: the
   parameters whose gradients differ in their bits;
3. one such call under ``torch.use_deterministic_algorithms(True)``: the
   error it raises; then under ``warn_only=True``: every operation PyTorch
   names as nondeterministic;
4. the loss trace of six Trainer steps (B=32) in four fresh processes: two
   with the default settings, two under ``use_deterministic_algorithms``
   with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``; whether the processes of each
   pair agree.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def setup():
    from realise_tpu_torch.config import config_for
    from realise_tpu_torch.device import resolve_device
    from realise_tpu_torch.ops.kernels._build import build

    device = resolve_device("cuda")
    build(["bert_block_train"])
    cfg = config_for("bert-pho2-res-arch3", vocab_size=21128, dtype="bfloat16")
    return device, cfg


def grads_of_one_call(model, batch, per_token):
    import torch

    from realise_tpu_torch.data.features import to_device

    batch = dict(batch)
    if not per_token:
        batch.update(model.conv_rows(batch["src_idx"]))
    model.zero_grad(set_to_none=True)
    out = model(to_device(batch, next(model.parameters()).device),
                use_kernels=True, generator=torch.Generator().manual_seed(7),
                per_token=per_token)
    out["loss_sum"].backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def trace(mode: str) -> None:
    """Child: the bit patterns of two Trainer steps' losses."""
    import torch

    from realise_tpu_torch.training.trainer import Trainer

    if mode == "deterministic":
        torch.use_deterministic_algorithms(True)
    device, cfg = setup()
    trainer = Trainer(cfg, chip_smoke.seeded_model(cfg, chip_smoke.SEED),
                      learning_rate=5e-5, warmup_steps=2, total_steps=100,
                      weight_decay=0.01, max_grad_norm=1.0, device=device,
                      seed=chip_smoke.SEED)
    losses = [float(trainer.train_step(b))
              for b in chip_smoke.train_batches(cfg, 6, 32, chip_smoke.SEED)]
    print("trace " + " ".join(x.hex() for x in losses), flush=True)


def library_op_check(device) -> None:
    """Part 1: two calls of each gather backward on one seeded cotangent."""
    import torch

    from realise_tpu_torch.ops.layers import ONEHOT_MAX_ROWS

    gen = torch.Generator(device=device).manual_seed(0)
    pinyin_len = 7
    for b in (32, 256):
        n = b * 128
        # (name, table rows, ids): the distributions of a step's gathers,
        # half the slots padding (id 0 or the padding's own row).
        half = torch.arange(n, device=device) % 2 == 0
        cases = [
            ("token types", 2, torch.zeros(n, dtype=torch.long, device=device)),
            ("pinyin symbols per token", 33, torch.where(
                half.repeat_interleave(pinyin_len), 0, torch.randint(
                    0, 33, (n * pinyin_len,), device=device, generator=gen))),
            ("positions", 512, torch.arange(n, device=device) % 128),
            ("GRU table", 1142, torch.where(half, 0, torch.randint(
                0, 1142, (n,), device=device, generator=gen))),
            ("conv rows", 1792 if b == 32 else 6656, torch.where(
                half, 0, torch.randint(0, 1792 if b == 32 else 6656, (n,),
                                       device=device, generator=gen))),
            ("word embeddings", 21128, torch.where(half, 0, torch.randint(
                0, 21128, (n,), device=device, generator=gen))),
        ]
        for name, rows, ids in cases:
            g = torch.randn(ids.shape[0], 768, device=device, generator=gen)
            same = {}
            for route in ("embedding_dense_backward", "one-hot matmul"):
                if route == "one-hot matmul" and rows > 2048:
                    continue
                outs = []
                for _ in range(2):
                    if route == "embedding_dense_backward":
                        outs.append(torch.ops.aten.embedding_dense_backward(
                            g, ids, rows, -1, False))
                    else:
                        onehot = (ids[:, None] == torch.arange(
                            rows, device=device)).float()
                        outs.append(torch.matmul(onehot.t(), g))
                same[route] = torch.equal(outs[0], outs[1])
            print(f"library op, B={b}, {name} ({rows} rows, {ids.shape[0]} "
                  f"ids; table_gather takes the "
                  f"{'one-hot matmul' if rows <= ONEHOT_MAX_ROWS else 'embedding_dense_backward'}): "
                  + ", ".join(f"{r} {'same bits' if ok else 'DIFFERENT bits'} "
                              f"over two calls" for r, ok in same.items()),
                  flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--trace", choices=["default", "deterministic"],
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.trace:
        trace(args.trace)
        return 0
    import torch

    device, cfg = setup()
    library_op_check(device)
    model = chip_smoke.seeded_model(cfg, chip_smoke.SEED).to(device).train()
    batch = chip_smoke.train_batches(cfg, 1, 32, chip_smoke.SEED)[0]
    for cudnn_det in (False, True):
        torch.backends.cudnn.deterministic = cudnn_det
        for per_token in (True, False):
            a = grads_of_one_call(model, batch, per_token)
            b = grads_of_one_call(model, batch, per_token)
            differ = [n for n in a if not torch.equal(a[n], b[n])]
            print(f"two calls, {'per-token' if per_token else 'factorized'} "
                  f"streams, cudnn.deterministic={cudnn_det}: {len(differ)} of "
                  f"{len(a)} gradients differ: {differ}", flush=True)
    torch.backends.cudnn.deterministic = False

    torch.use_deterministic_algorithms(True)
    for per_token in (True, False):
        try:
            grads_of_one_call(model, batch, per_token)
            print(f"use_deterministic_algorithms, per_token={per_token}: "
                  f"nothing raised", flush=True)
        except RuntimeError as e:
            print(f"use_deterministic_algorithms, per_token={per_token}: "
                  f"raised: {str(e).splitlines()[0][:400]}", flush=True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    for per_token in (True, False):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            grads_of_one_call(model, batch, per_token)
        names = sorted({str(w.message).splitlines()[0][:300] for w in caught})
        print(f"warn_only, per_token={per_token}: {len(names)} distinct "
              f"warnings", flush=True)
        for name in names:
            print(f"  {name}", flush=True)
    torch.use_deterministic_algorithms(False)
    del model

    for mode in ("default", "default", "deterministic", "deterministic"):
        env = dict(os.environ)
        if mode == "deterministic":
            env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--trace", mode], env=env, capture_output=True,
                             text=True)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("trace")]
        print(f"process, {mode}: exit {out.returncode}, "
              f"{lines[-1] if lines else out.stderr.strip()[-400:]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
