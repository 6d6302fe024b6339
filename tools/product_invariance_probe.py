#!/usr/bin/env python3
"""Does a row of a weight product keep its bits inside a larger batch?

    python3 tools/product_invariance_probe.py     # on the card

The served rows of a request must not depend on the rows beside them
(``chip_smoke.py`` phase 5e). The plain bf16 products outside the kernels
decide it: the merged and concat presets' ``integrate`` (N = 768, K = 1536
or 2304) and the MLM head's transform (K = 768). For each K this runs
``torch.matmul`` in bf16 (the port's ``dense``), ``torch.matmul`` in
float32 of the same bf16 inputs rounded once, and the port's Hopper GEMM
(``bert_block_train.forward_gemm``, EPI_BIAS) on a request of n rows alone
and at the start and the end of batches of 2n to 32768 rows, and prints how
many placements change a bit of the request's rows, and each route's time
at M = 32768 (host clock over 20 calls, synchronised).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from realise_tpu_torch.ops.kernels import bert_block_train as tbt  # noqa: E402
from realise_tpu_torch.ops.kernels._build import build  # noqa: E402

N, M_MAX = 768, 32768


def placements(fn, xs, n):
    """[(rows, start, max |diff|)] of the placements that change bits."""
    ref = fn(xs[:n])
    bad = []
    for m in sorted({min(f * n, M_MAX) for f in (2, 4, 8, 16)} | {M_MAX}):
        for at in (0, m - n):
            x = torch.cat([xs[n:n + at], xs[:n], xs[n + at:m]])
            got = fn(x)[at:at + n]
            if not torch.equal(got, ref):
                bad.append((m, at, float((got.float() - ref.float()).abs().max())))
    return bad


def main() -> int:
    if not torch.cuda.is_available():
        print("product_invariance_probe: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__}, {card}", flush=True)
    build(["bert_block_train"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for k in (768, 1536, 2304):
        w = (torch.randn(N, k, device=dev, generator=gen) * 0.02).bfloat16()
        b = torch.randn(N, device=dev, generator=gen) * 0.02
        xs = torch.randn(M_MAX, k, device=dev, generator=gen).bfloat16()
        routes = (
            ("bf16 matmul", lambda x: torch.matmul(x, w.t()) + b.bfloat16()),
            ("f32 matmul", lambda x: torch.matmul(x.float(), w.float().t())
             .bfloat16() + b.bfloat16()),
            ("forward_gemm", lambda x: tbt.forward_gemm(x, w, b, tbt.EPI_BIAS)),
        )
        for name, fn in routes:
            bad = [len(placements(fn, xs, n)) for n in (256, 1024, 4096)]
            fn(xs)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(20):
                fn(xs)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) / 20 * 1e3
            print(f"K={k} {name}: placements that change bits, for requests "
                  f"of 256/1024/4096 rows (of 10/10/6): {bad}; M={M_MAX} "
                  f"{ms:.3f} ms [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
