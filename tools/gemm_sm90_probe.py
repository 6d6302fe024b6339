#!/usr/bin/env python3
"""Time the blocks' weight products on each GEMM of the port, on one NVIDIA H100.

    python3 tools/gemm_sm90_probe.py      # from the repository root; needs a card

Builds tools/gemm_sm90_probe.cu (realise_tpu_torch's GEMM headers, a plain C
entry point) with nvcc into build/, then times the attention's x·Wqkvᵀ with
its bias (EPI_BIAS, N=2304, K=768) and ctx·Woᵀ into the float32 residual,
rounded, without and with the output dropout (EPI_RESID_ROUND,
EPI_RESID_ROUND_DROP, N=768, K=768), and the FFN's x·W1ᵀ with bias and gelu
(EPI_BIAS_GELU, N=3072, K=768) and inter·W2ᵀ into the float32 residual
without and with the output dropout (EPI_RESID_F32, EPI_RESID_F32_DROP,
N=768, K=3072) at M = B*S from one sentence of bucket 32 to B=256 at
S=128, on the three routes linear_product chooses between: gemm_bf16_tc
(mma.sync), gemm_sm90 cooperative (128 x 256 tiles) and gemm_sm90
ping-pong (128 x 128 tiles). Each time is the median of 30 CUDA-event
timings, the L2 flushed before each; every route's output is held to the
first's (outputs with a bf16 rounding within 2^-7 of their largest value,
the unrounded float32 ones within 1e-4). Prints the card's name and power
limit first.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROUTES = ("gemm_bf16_tc", "gemm_sm90 cooperative", "gemm_sm90 ping-pong")
ROWS = (32, 512, 2048, 4096, 8192, 32768)
PRODUCTS = (("x.Wqkv^T bias", 0, 2304, 768), ("ctx.Wo^T resid", 2, 768, 768),
            ("ctx.Wo^T resid drop", 4, 768, 768),
            ("x.W1^T gelu", 1, 3072, 768), ("inter.W2^T resid", 3, 768, 3072),
            ("inter.W2^T resid drop", 5, 768, 3072))


def build() -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT))
    from realise_tpu_torch.ops.kernels._build import NVCC_FLAGS, find_nvcc

    out = ROOT / "build" / "gemm_sm90_probe.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(out),
                    str(ROOT / "tools" / "gemm_sm90_probe.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_gemm.argtypes = [i, i] + [p] * 5 + [i] * 4 + [p]
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gemm_sm90_probe: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    lib = build()
    dev = torch.device("cuda")
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    st = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator().manual_seed(0)

    def time_ms(fn, iters=30):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(iters):
            flush.zero_()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            fn()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)

    for m in ROWS:
        for label, mode, n, k in PRODUCTS:
            x = torch.randn((m, k), generator=gen).to(dev, torch.bfloat16)
            w = (torch.randn((n, k), generator=gen) * k ** -0.5).to(dev, torch.bfloat16)
            bias = (torch.randn((n,), generator=gen) * 0.1).to(dev)
            resid = torch.randn((m, n), generator=gen).to(dev, torch.bfloat16)
            f32 = mode not in (0, 1)
            out = torch.empty((m, n), dtype=torch.float32 if f32 else torch.bfloat16,
                              device=dev)
            tol = 1e-4 if mode in (3, 5) else 2.0 ** -7
            times, first = [], None
            for gemm in range(len(ROUTES)):
                def fn():
                    err = lib.probe_gemm(gemm, mode, x.data_ptr(), w.data_ptr(),
                                         bias.data_ptr(), resid.data_ptr(),
                                         out.data_ptr(), m, n, k, 32, st)
                    if err:
                        raise RuntimeError(f"{ROUTES[gemm]} failed: CUDA error {err}")
                fn()
                got = out.float().clone()
                first = got if first is None else first
                rel = ((got - first).abs().max() / first.abs().max()).item()
                if rel > tol:
                    raise RuntimeError(f"{ROUTES[gemm]} {label} M={m}: {rel:.2e} off")
                times.append(time_ms(fn))
            print(f"M={m} {label} (N={n}, K={k}): " + ", ".join(
                f"{r} {t:.4f} ms" for r, t in zip(ROUTES, times)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
