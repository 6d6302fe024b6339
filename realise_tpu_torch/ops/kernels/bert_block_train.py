"""Differentiable fused BERT sub-blocks of the training step, with dropout.

Counterparts of ``realise_tpu/ops/pallas/bert_block_train.py``
``attention_block_train`` and ``ffn_block_train``. Each sub-block is a
``torch.autograd.Function`` over four kernel wrappers, one per TPU kernel:

* :func:`attention_train_forward` ← ``_attn_fwd_impl`` (y; saves only x);
* :func:`attention_train_backward` ← ``_attn_bwd_impl`` (recomputes q/k/v,
  the probabilities and the pre-LN z from x, then dx and every parameter
  gradient; dWo and dbo too, which JAX takes outside its kernel);
* :func:`ffn_train_forward` ← ``_ffn_fwd_impl`` (y and the pre-LN z rounded
  to the activation dtype; saves x and z);
* :func:`ffn_train_backward` ← ``_ffn_bwd_impl`` (LN backward from the
  rounded z, recomputes t1 = x·W1 + b1, then dx and every gradient).

For tests and timing, on the routes the blocks take: :func:`backward_gemm`
runs one product of the two backward kernels alone (their Hopper GEMM,
``csrc/gemm_sm90.cuh``), :func:`forward_gemm` one weight product of the
forward blocks (serving and training, and the backward's replays of them),
and :func:`attention_core` the attention core alone.

Each Function keeps the span hook it was given in the forward (``span``,
the model's ``Realise.span`` at that time) and brackets its backward in
``span('encoder.attn_bwd')`` or ``span('encoder.ffn_bwd')``; the autograd
engine runs it on its own thread, on the forward's stream.

For a CPU tensor a wrapper runs its plain PyTorch version; for a CUDA tensor
it launches its kernel (CUDA C++ for sm_90a, ``csrc/bert_block_train.cu``) or
raises. Parameters arrive as the live ``nn.Parameter``s (torch (out, in)
layout, float32), so their gradients are float32 whatever the activation
dtype. Each Function packs them once, in its forward
(``bert_block.pack_attention`` / ``pack_ffn``, the serving kernels' layout
too), and its backward reads that saved pack. The mask bias and the seed
get no gradient.

**Dropout masks** are the counter hash of the JAX kernels, bit for bit: a
murmur3 fmix32 stream id per (seed, site, example[, head]) (:func:`site_base`)
XORed with the mixed element index (:func:`keep_mask`). Site 1 is the
attention probabilities (one stream per example and head), site 2 the
attention output, site 3 the FFN output (one stream per example each). When
``cols % 256 == 0`` one hash gives two 16-bit samples (left half of the
columns from the low bits, right half from the high bits), else one 24-bit
sample: the JAX package's default stream. Kept values are scaled by
``float32(1 / keep)``. The forward and the backward replay the same masks.

**Rounding points** (the Pallas kernels'): matmul outputs round to the
activation dtype and biases are added in it; the attention output is rounded
again after its dropout; the FFN's W2 sum stays float32 through its bias,
dropout and the residual, and the saved z is that sum rounded; the softmax
gradient is scaled by head_dim^-1/2 and rounded; dq/dk/dv round to the
activation dtype; weight gradients accumulate in float32. gelu is the exact
erf form (the Pallas kernels use an Abramowitz–Stegun erf, |err| ≤ 1.5e-7).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from realise_tpu_torch.ops.kernels import ATTN_MAX_HEAD_DIM, ATTN_MAX_SEQ
from realise_tpu_torch.ops.kernels.bert_block import (
    ATTN_PARAMS,
    FFN_PARAMS,
    _check,
    _check_x,
    _stream,
    attention_context,
    attention_probs,
    pack_attention,
    pack_ffn,
)
from realise_tpu_torch.ops.layers import M32, dense, layer_norm, mix32, mul32
from realise_tpu_torch.utils.profiler import no_span

SITE_PROBS, SITE_ATTN_OUT, SITE_FFN_OUT = 1, 2, 3
# Epilogues of the forward products (csrc/bert_block_common.cuh EPI_*):
# x·Wqkvᵀ with its bias; x·W1ᵀ with bias and gelu; ctx·Woᵀ with its bias into
# the float32 residual, rounded, without (serving) and with (training) the
# output dropout; inter·W2ᵀ into the float32 residual, without and with the
# output dropout; the FFN backward's t1 replay (t1 and gelu(t1)).
EPI_BIAS, EPI_BIAS_GELU, EPI_RESID_ROUND, EPI_RESID_F32 = 0, 1, 2, 3
EPI_RESID_ROUND_DROP, EPI_RESID_F32_DROP, EPI_BIAS_T1_GELU = 4, 5, 9
FORWARD_MODES = (EPI_BIAS, EPI_BIAS_GELU, EPI_RESID_ROUND, EPI_RESID_F32,
                 EPI_RESID_ROUND_DROP, EPI_RESID_F32_DROP, EPI_BIAS_T1_GELU)
# The dropout site each dropping mode has in the blocks.
FORWARD_SITES = {EPI_RESID_ROUND_DROP: SITE_ATTN_OUT,
                 EPI_RESID_F32_DROP: SITE_FFN_OUT}
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT2PI = 0.3989422804014327

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


# ------------------------------------------------------------- mask hash
def site_base(seed: int, site: int, example: torch.Tensor,
              head=0) -> torch.Tensor:
    """uint32 stream id (as int64) for (seed, site, example[, head])."""
    s = mul32(int(seed) & M32, 0x9E3779B1)
    s = (s + mul32(site, 0x85EBCA6B)) & M32
    s = (s + mul32(example, 0xC2B2AE35)) & M32
    s = (s + mul32(head, 0x27D4EB2F)) & M32
    return mix32(s)


def keep_mask(base: torch.Tensor, rows: int, cols: int,
              keep: float) -> torch.Tensor:
    """(..., rows, cols) float32 multiplier in {0, 1/keep} for the stream ids
    ``base`` (shape (..., 1, 1))."""
    device = base.device
    if cols % 256 == 0:
        half = cols // 2
        idx = (torch.arange(rows, device=device)[:, None] * half
               + torch.arange(half, device=device)[None, :])
        bits = mix32(base ^ mix32(idx))
        thresh = min(int(keep * (1 << 16)), 1 << 16)
        m = torch.cat([(bits & 0xFFFF) < thresh, (bits >> 16) < thresh], -1)
    else:
        idx = (torch.arange(rows, device=device)[:, None] * cols
               + torch.arange(cols, device=device)[None, :])
        bits = mix32(base ^ mix32(idx))
        m = (bits >> 8) < min(int(keep * (1 << 24)), 1 << 24)
    return m.float() * (1.0 / keep)


def block_keep_mask(seed: int, site: int, b: int, s: int, cols: int,
                    keep: float, device) -> torch.Tensor:
    """(B, S, cols) multiplier of a hidden site: one stream per example."""
    ex = torch.arange(b, dtype=torch.int64, device=device)
    return keep_mask(site_base(seed, site, ex)[:, None, None], s, cols, keep)


def probs_keep_mask(seed: int, b: int, num_heads: int, s: int, keep: float,
                    device) -> torch.Tensor:
    """(B, heads, S, S) multiplier of the probabilities: one stream per
    (example, head)."""
    ex = torch.arange(b, dtype=torch.int64, device=device)[:, None]
    head = torch.arange(num_heads, dtype=torch.int64, device=device)[None, :]
    return keep_mask(site_base(seed, SITE_PROBS, ex, head)[..., None, None],
                     s, s, keep)


# ------------------------------------------------------- plain versions
def _ln_bwd(z32, dy32, g, eps):
    """LayerNorm backward over the last dim → (dz, dgamma, dbeta)."""
    mu = z32.mean(-1, keepdim=True)
    var = (z32 - mu).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    norm = (z32 - mu) * rstd
    gg = dy32 * g
    dz = rstd * (gg - gg.mean(-1, keepdim=True)
                 - norm * (gg * norm).mean(-1, keepdim=True))
    return dz, (dy32 * norm).sum(0), dy32.sum(0)


def _attn_core(qkv, b, mask_bias, seed, num_heads, p_rate):
    """q, k, v, probs, the probabilities' keep multiplier (None without
    dropout), the dropped probabilities rounded to qkv's dtype, and ctx."""
    dt = qkv.dtype
    q, k, v, probs = attention_probs(qkv, b, mask_bias, num_heads)
    keep = None
    if p_rate > 0.0:
        keep = probs_keep_mask(seed, b, num_heads, qkv.shape[0] // b,
                               1.0 - p_rate, qkv.device)
    probs_d = (probs * keep if keep is not None else probs).to(dt).float()
    return q, k, v, probs, keep, probs_d, attention_context(probs_d, v, dt)


def attention_core_plain(qkv, mask_bias, seed, num_heads, p_rate=0.0):
    """ctx (B, S, H) = drop_p(softmax(q·kᵀ·d^-½ + mask))·v per head of the
    (B, S, 3H) q/k/v, the probabilities' dropout stream per (example, head)
    from ``seed``."""
    b, s, h3 = qkv.shape
    ctx = _attn_core(qkv.reshape(b * s, h3), b, mask_bias, seed, num_heads,
                     p_rate)[-1]
    return ctx.reshape(b, s, h3 // 3)


def _attn_recompute(x, p, mask_bias, seed, num_heads, p_rate, h_rate):
    """q/k/v, probs, mask, ctx and the attention output of the forward."""
    b, s, h = x.shape
    dt = x.dtype
    xf = x.reshape(b * s, h)
    qkv = dense(xf, p["qkv_weight"], p["qkv_bias"])
    q, k, v, probs, keep, probs_d, ctx = _attn_core(qkv, b, mask_bias, seed,
                                                    num_heads, p_rate)
    attn = dense(ctx, p["out_weight"], p["out_bias"])
    keep_h = None
    if h_rate > 0.0:
        keep_h = block_keep_mask(seed, SITE_ATTN_OUT, b, s, h, 1.0 - h_rate,
                                 x.device).reshape(b * s, h)
        attn = (attn.float() * keep_h).to(dt)
    return q, k, v, probs, keep, probs_d, ctx, attn, keep_h


def attention_train_forward_plain(x, p, mask_bias, seed, num_heads,
                                  eps=1e-12, p_rate=0.0, h_rate=0.0):
    """y = LN(x + drop_h(ctx·Wo + bo)), ctx = drop_p(softmax(q·kᵀ·d^-½ +
    mask))·v per head."""
    b, s, h = x.shape
    *_, attn, _ = _attn_recompute(x, p, mask_bias, seed, num_heads, p_rate,
                                  h_rate)
    z32 = x.reshape(b * s, h).float() + attn.float()
    return layer_norm(z32, p["ln_weight"], p["ln_bias"], eps).to(
        x.dtype).reshape(b, s, h)


def attention_train_backward_plain(x, dy, p, mask_bias, seed, num_heads,
                                   eps=1e-12, p_rate=0.0, h_rate=0.0):
    """(dx, {qkv_weight (3H, H), qkv_bias, out_weight, out_bias, ln_weight,
    ln_bias} float32 gradients) of the attention sub-block."""
    b, s, h = x.shape
    hd = h // num_heads
    dt = x.dtype
    xf = x.reshape(b * s, h)
    q, k, v, probs, keep, probs_d, ctx, attn, keep_h = _attn_recompute(
        x, p, mask_bias, seed, num_heads, p_rate, h_rate)
    z32 = xf.float() + attn.float()
    dz, dg, dbeta = _ln_bwd(z32, dy.reshape(b * s, h).float(),
                            p["ln_weight"], eps)
    dattn = (dz * keep_h if keep_h is not None else dz).to(dt)
    dctx = torch.matmul(dattn, p["out_weight"]).reshape(b, s, num_heads, hd)
    dctx = dctx.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", probs_d, dctx).to(dt)
    dp = torch.einsum("bqhd,bkhd->bhqk", dctx, v)
    if keep is not None:
        dp = dp * keep
    ds = probs * (dp - (dp * probs).sum(-1, keepdim=True))
    ds = (ds * (1.0 / hd ** 0.5)).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k).to(dt)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q).to(dt)
    dqkv = torch.cat([t.reshape(b * s, h) for t in (dq, dk, dv)], -1).float()
    dx = dz + torch.matmul(dqkv, p["qkv_weight"].float())
    grads = {"qkv_weight": dqkv.t() @ xf.float(),
             "qkv_bias": dqkv.sum(0),
             "out_weight": dattn.float().t() @ ctx.float(),
             "out_bias": dattn.float().sum(0),
             "ln_weight": dg, "ln_bias": dbeta}
    return dx.to(dt).reshape(b, s, h), grads


def ffn_train_forward_plain(x, p, seed, eps=1e-12, h_rate=0.0):
    """(y, z): z = x + drop(gelu(round(x·W1) + b1)·W2 + b2) in float32, y =
    LN(z); z is returned rounded to the activation dtype."""
    b, s, h = x.shape
    dt = x.dtype
    xf = x.reshape(b * s, h)
    t1 = dense(xf, p["w1"], p["b1"]).float()
    inter = ((t1 * 0.5) * (1.0 + torch.erf(t1 * _INV_SQRT2))).to(dt)
    out = torch.matmul(inter.float(), p["w2"].float().t()) + p["b2"].float()
    if h_rate > 0.0:
        out = out * block_keep_mask(seed, SITE_FFN_OUT, b, s, h, 1.0 - h_rate,
                                    x.device).reshape(b * s, h)
    z32 = xf.float() + out
    y = layer_norm(z32, p["ln_weight"], p["ln_bias"], eps)
    return y.to(dt).reshape(b, s, h), z32.to(dt).reshape(b, s, h)


def ffn_train_backward_plain(x, z, dy, p, seed, eps=1e-12, h_rate=0.0):
    """(dx, {w1, b1, w2, b2, ln_weight, ln_bias} float32 gradients)."""
    b, s, h = x.shape
    dt = x.dtype
    xf = x.reshape(b * s, h)
    dz, dg, dbeta = _ln_bwd(z.reshape(b * s, h).float(),
                            dy.reshape(b * s, h).float(), p["ln_weight"], eps)
    dout = dz
    if h_rate > 0.0:
        dout = dz * block_keep_mask(seed, SITE_FFN_OUT, b, s, h, 1.0 - h_rate,
                                    x.device).reshape(b * s, h)
    dout_lo = dout.to(dt).float()
    t1 = dense(xf, p["w1"], p["b1"]).float()
    cdf = 0.5 * (1.0 + torch.erf(t1 * _INV_SQRT2))
    inter = (t1 * cdf).to(dt).float()
    dinter = torch.matmul(dout_lo, p["w2"].float())
    phi = _INV_SQRT2PI * torch.exp(-0.5 * t1 * t1)
    dt1 = (dinter * (cdf + t1 * phi)).to(dt).float()
    dx = torch.matmul(dt1, p["w1"].float()) + dz
    grads = {"w1": dt1.t() @ xf.float(), "b1": dt1.sum(0),
             "w2": dout_lo.t() @ inter, "b2": dout.sum(0),
             "ln_weight": dg, "ln_bias": dbeta}
    return dx.to(dt).reshape(b, s, h), grads


# ----------------------------------------------------------- CUDA binding
class _Dropout(ctypes.Structure):
    """csrc RtDropout: the seed and both sites' thresholds and scales."""
    _fields_ = [("seed", ctypes.c_uint32),
                ("p_thr16", ctypes.c_uint32), ("p_thr24", ctypes.c_uint32),
                ("p_scale", ctypes.c_float), ("p_on", ctypes.c_int32),
                ("h_thr16", ctypes.c_uint32), ("h_thr24", ctypes.c_uint32),
                ("h_scale", ctypes.c_float), ("h_on", ctypes.c_int32)]


def _site_args(rate: float) -> Tuple[int, int, float, int]:
    keep = 1.0 - rate
    return (min(int(keep * (1 << 16)), 1 << 16),
            min(int(keep * (1 << 24)), 1 << 24), 1.0 / keep, int(rate > 0.0))


def _dropout_args(seed: int, p_rate: float, h_rate: float) -> _Dropout:
    return _Dropout(int(seed) & M32, *_site_args(p_rate), *_site_args(h_rate))


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from realise_tpu_torch.ops.kernels._build import load

        lib = load("bert_block_train")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        d = ctypes.POINTER(_Dropout)
        lib.rt_attention_train_fwd.argtypes = (
            [p] * 12 + [i] * 4 + [f, f, d, i, p])
        lib.rt_attention_train_bwd.argtypes = (
            [p] * 25 + [i] * 4 + [f, f, d, i, p])
        lib.rt_ffn_train_fwd.argtypes = [p] * 11 + [i] * 4 + [f, d, i, p]
        lib.rt_ffn_train_bwd.argtypes = [p] * 23 + [i] * 4 + [f, d, i, p]
        for fn in (lib.rt_attention_train_fwd, lib.rt_attention_train_bwd,
                   lib.rt_ffn_train_fwd, lib.rt_ffn_train_bwd):
            fn.restype = i
        lib.rt_train_gemm.argtypes = [p] * 4 + [i] * 4 + [p]
        lib.rt_train_gemm.restype = i
        lib.rt_forward_gemm.argtypes = [p] * 6 + [i] * 6 + [d, i, p]
        lib.rt_forward_gemm.restype = i
        lib.rt_attention_core.argtypes = [p] * 3 + [i] * 4 + [f, d, i, p]
        lib.rt_attention_core.restype = i
        for fn in (lib.rt_train_colsum_scratch, lib.rt_train_split_scratch):
            fn.argtypes, fn.restype = [i, i], ctypes.c_longlong
        _LIB = lib
    return _LIB


def _run(name: str, *args) -> None:
    err = getattr(_lib(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _ptrs(*tensors) -> list:
    return [t.data_ptr() for t in tensors]


def _check_attention(x, p, mask_bias, num_heads):
    _check_x(x)
    b, s, h = x.shape
    if h % num_heads:
        raise ValueError(f"hidden {h} is not divisible by {num_heads} heads")
    hd = h // num_heads
    if hd > ATTN_MAX_HEAD_DIM or s > ATTN_MAX_SEQ:
        raise ValueError(f"attention kernel holds head_dim <= {ATTN_MAX_HEAD_DIM} "
                         f"and S <= {ATTN_MAX_SEQ}, got {hd} and {s}")
    dev, dt, f32 = x.device, x.dtype, torch.float32
    _check("qkv_weight", p["qkv_weight"], (3 * h, h), dt, dev)
    _check("qkv_bias", p["qkv_bias"], (3 * h,), f32, dev)
    _check("out_weight", p["out_weight"], (h, h), dt, dev)
    for k in ("out_bias", "ln_weight", "ln_bias"):
        _check(k, p[k], (h,), f32, dev)
    mask = mask_bias.reshape(b, s).float().contiguous()
    _check("mask_bias", mask, (b, s), f32, dev)
    return mask


def _check_ffn(x, p):
    _check_x(x)
    h = x.shape[-1]
    inter = p["w1"].shape[0]
    dev, dt, f32 = x.device, x.dtype, torch.float32
    _check("w1", p["w1"], (inter, h), dt, dev)
    _check("b1", p["b1"], (inter,), f32, dev)
    _check("w2", p["w2"], (h, inter), dt, dev)
    for k in ("b2", "ln_weight", "ln_bias"):
        _check(k, p[k], (h,), f32, dev)
    return inter


def _partials(m: int, n: int, device) -> torch.Tensor:
    """Scratch of the two-pass column sums over ``m`` rows, ``n`` columns."""
    return torch.empty(_lib().rt_train_colsum_scratch(m, n),
                       dtype=torch.float32, device=device)


def _splits(m: int, n: int, device) -> torch.Tensor:
    """Scratch of the K-split partials of an ``m`` x ``n`` weight gradient."""
    return torch.empty(_lib().rt_train_split_scratch(m, n),
                       dtype=torch.float32, device=device)


def backward_gemm_plain(a: torch.Tensor, b: torch.Tensor,
                        transpose_a: bool = False) -> torch.Tensor:
    """float32 aᵀ·b (a (K, M), b (K, N)), or a·b (a (M, K), b (K, N))
    rounded to a's dtype."""
    if transpose_a:
        return a.float().t() @ b.float()
    return (a.float() @ b.float()).to(a.dtype)


def backward_gemm(a: torch.Tensor, b: torch.Tensor,
                  transpose_a: bool = False) -> torch.Tensor:
    """One product of the train backward kernels alone, bf16, on their
    route: ``transpose_a`` is a weight gradient (aᵀ·b over the rows, float32
    out, split-K partials summed in order), else a data gradient (a·b
    rounded to bf16). For tests and timing; the backward never calls it."""
    if a.device.type == "cpu":
        return backward_gemm_plain(a, b, transpose_a)
    if a.device.type != "cuda":
        raise ValueError(f"the kernels run on CUDA tensors, got {a.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[0 if transpose_a else 1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(b.shape)} do not "
                         f"multiply{' with a transposed' if transpose_a else ''}")
    k, n = b.shape
    m = a.shape[1] if transpose_a else a.shape[0]
    _check("a", a, a.shape, torch.bfloat16, a.device)
    _check("b", b, b.shape, torch.bfloat16, a.device)
    if transpose_a:
        out = torch.empty((m, n), dtype=torch.float32, device=a.device)
        wsplit = _splits(m, n, a.device)
    else:
        out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
        wsplit = out
    _run("rt_train_gemm", *_ptrs(a, b, out, wsplit), m, n, k, int(transpose_a),
         _stream(a.device))
    return out


def _site(mode: int, site) -> int:
    return FORWARD_SITES.get(mode, SITE_FFN_OUT) if site is None else int(site)


def forward_gemm_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       mode: int, resid=None, seed: int = 0,
                       rows_per_example: int = 1, h_rate: float = 0.0,
                       site=None):
    """One weight product a·wᵀ (a (M, K), w a torch (N, K) weight) with the
    epilogue ``mode`` (:data:`FORWARD_MODES`), in the blocks' rounding, t =
    round(a·wᵀ) + b: EPI_BIAS → t; EPI_BIAS_GELU → gelu(t); EPI_RESID_ROUND →
    float32 resid + t; EPI_RESID_ROUND_DROP → float32 resid + round(t ·
    keep); EPI_RESID_F32 → float32 (resid + b) + a·wᵀ; EPI_RESID_F32_DROP →
    float32 resid + (a·wᵀ + b) · keep; EPI_BIAS_T1_GELU → (t, gelu(t)). keep
    is the hidden dropout site ``site`` (by default the one the blocks use
    for ``mode``, :data:`FORWARD_SITES`) over examples of
    ``rows_per_example`` rows."""
    dt = a.dtype

    def keep():
        m, n = resid.shape
        s = rows_per_example
        return block_keep_mask(seed, _site(mode, site), m // s, s, n,
                               1.0 - h_rate, a.device).reshape(m, n)

    if mode in (EPI_BIAS, EPI_BIAS_GELU, EPI_BIAS_T1_GELU,
                EPI_RESID_ROUND, EPI_RESID_ROUND_DROP):
        t1 = dense(a, w, bias)
        if mode == EPI_BIAS:
            return t1
        if mode in (EPI_RESID_ROUND, EPI_RESID_ROUND_DROP):
            if mode == EPI_RESID_ROUND_DROP and h_rate > 0.0:
                t1 = (t1.float() * keep()).to(dt)
            return resid.float() + t1.float()
        t = t1.float()
        inter = ((t * 0.5) * (1.0 + torch.erf(t * _INV_SQRT2))).to(dt)
        return inter if mode == EPI_BIAS_GELU else (t1, inter)
    part = torch.matmul(a.float(), w.float().t())
    if mode == EPI_RESID_F32:
        return (resid.float() + bias.float()) + part
    if mode != EPI_RESID_F32_DROP:
        raise ValueError(f"mode {mode} is not one of {FORWARD_MODES}")
    out = part + bias.float()
    if h_rate > 0.0:
        out = out * keep()
    return resid.float() + out


def forward_gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 mode: int, resid=None, seed: int = 0,
                 rows_per_example: int = 1, h_rate: float = 0.0, site=None):
    """:func:`forward_gemm_plain`'s product on the route the blocks take
    (``csrc/gemm_sm90.cuh`` linear_product). For tests and timing; the blocks
    never call it."""
    if a.device.type == "cpu":
        return forward_gemm_plain(a, w, bias, mode, resid, seed,
                                  rows_per_example, h_rate, site)
    if a.device.type != "cuda":
        raise ValueError(f"the kernels run on CUDA tensors, got {a.device}")
    if mode not in FORWARD_MODES:
        raise ValueError(f"mode {mode} is not one of {FORWARD_MODES}")
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[1]:
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(w.shape)} do not "
                         f"multiply as a·wᵀ")
    m, k = a.shape
    n = w.shape[0]
    dev, dt, f32 = a.device, a.dtype, torch.float32
    if dt not in _DTYPE_CODE:
        raise ValueError(f"dtype {dt} not in {tuple(_DTYPE_CODE)}")
    if m % rows_per_example:
        raise ValueError(f"{m} rows are not whole examples of {rows_per_example}")
    _check("a", a, (m, k), dt, dev)
    _check("w", w, (n, k), dt, dev)
    _check("bias", bias, (n,), f32, dev)
    with_resid = mode in (EPI_RESID_ROUND, EPI_RESID_F32, EPI_RESID_ROUND_DROP,
                          EPI_RESID_F32_DROP)
    if with_resid:
        _check("resid", resid, (m, n), dt, dev)
    out = torch.empty((m, n), dtype=f32 if with_resid else dt, device=dev)
    out2 = torch.empty((m, n), dtype=dt, device=dev) \
        if mode == EPI_BIAS_T1_GELU else out
    _run("rt_forward_gemm",
         *_ptrs(a, w, bias), resid.data_ptr() if with_resid else None,
         *_ptrs(out, out2),
         m, n, k, rows_per_example, mode, _site(mode, site),
         ctypes.byref(_dropout_args(seed, 0.0, h_rate)), _DTYPE_CODE[dt],
         _stream(dev))
    return (out, out2) if mode == EPI_BIAS_T1_GELU else out


def attention_core(qkv: torch.Tensor, mask_bias: torch.Tensor, seed: int,
                   num_heads: int, p_rate: float = 0.0) -> torch.Tensor:
    """:func:`attention_core_plain` on the attention blocks' core (the
    persistent tensor-core core for bf16 at head_dim 64). For tests and
    timing; the blocks never call it."""
    if qkv.device.type == "cpu":
        return attention_core_plain(qkv, mask_bias, seed, num_heads, p_rate)
    _check_x(qkv)
    b, s, h3 = qkv.shape
    h = h3 // 3
    if h3 % 3 or h % num_heads:
        raise ValueError(f"q/k/v width {h3} is not 3 x {num_heads} heads")
    if h // num_heads > ATTN_MAX_HEAD_DIM or s > ATTN_MAX_SEQ:
        raise ValueError(f"attention kernel holds head_dim <= {ATTN_MAX_HEAD_DIM} "
                         f"and S <= {ATTN_MAX_SEQ}, got {h // num_heads} and {s}")
    mask = mask_bias.reshape(b, s).float().contiguous()
    _check("mask_bias", mask, (b, s), torch.float32, qkv.device)
    ctx = torch.empty((b, s, h), dtype=qkv.dtype, device=qkv.device)
    _run("rt_attention_core", *_ptrs(qkv, mask, ctx), b, s, h, num_heads,
         1.0 / (h // num_heads) ** 0.5,
         ctypes.byref(_dropout_args(seed, p_rate, 0.0)),
         _DTYPE_CODE[qkv.dtype], _stream(qkv.device))
    return ctx


# ---------------------------------------------------------- the wrappers
def attention_train_forward(x, p, mask_bias, seed, num_heads, eps=1e-12,
                            p_rate=0.0, h_rate=0.0, scratch=None):
    """Kernel #3: the attention sub-block's training forward → y (B, S, H).

    ``scratch``, a dict, receives the kernel's q/k/v, ctx and pre-LN z32
    buffers (a test hook of the CUDA path)."""
    if x.device.type == "cpu":
        return attention_train_forward_plain(x, p, mask_bias, seed, num_heads,
                                             eps, p_rate, h_rate)
    mask = _check_attention(x, p, mask_bias, num_heads)
    b, s, h = x.shape
    dev, dt = x.device, x.dtype
    qkv = torch.empty((b * s, 3 * h), dtype=dt, device=dev)
    ctx = torch.empty((b * s, h), dtype=dt, device=dev)
    z32 = torch.empty((b * s, h), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    _run("rt_attention_train_fwd",
         *_ptrs(x, p["qkv_weight"], p["qkv_bias"], p["out_weight"],
                p["out_bias"], p["ln_weight"], p["ln_bias"], mask, qkv, ctx,
                z32, y),
         b, s, h, num_heads, 1.0 / (h // num_heads) ** 0.5, eps,
         ctypes.byref(_dropout_args(seed, p_rate, h_rate)), _DTYPE_CODE[dt],
         _stream(dev))
    attention_train_forward.launches += 1
    if scratch is not None:
        scratch.update(qkv=qkv, ctx=ctx, z32=z32)
    return y


def attention_train_backward(x, dy, p, mask_bias, seed, num_heads,
                             eps=1e-12, p_rate=0.0, h_rate=0.0, scratch=None):
    """Kernel #4: (dx, float32 gradients of the packed parameters).

    ``scratch``, a dict, receives the q/k/v, ctx and pre-LN z32 that the
    kernel recomputed (a test hook of the CUDA path)."""
    if x.device.type == "cpu":
        return attention_train_backward_plain(x, dy, p, mask_bias, seed,
                                              num_heads, eps, p_rate, h_rate)
    mask = _check_attention(x, p, mask_bias, num_heads)
    _check("dy", dy, x.shape, x.dtype, x.device)
    b, s, h = x.shape
    m, dev, dt, f32 = b * s, x.device, x.dtype, torch.float32
    e = lambda *shape, dtype=dt: torch.empty(shape, dtype=dtype, device=dev)
    bufs = [e(m, 3 * h), e(m, h), e(m, h, dtype=f32), e(m, h, dtype=f32),
            e(m, h, dtype=f32), e(m, h), e(m, h), e(m, 3 * h),
            _partials(m, 3 * h, dev), _splits(3 * h, h, dev)]
    dx = torch.empty_like(x)
    grads = {"qkv_weight": e(3 * h, h, dtype=f32),
             "qkv_bias": e(3 * h, dtype=f32),
             "out_weight": e(h, h, dtype=f32), "out_bias": e(h, dtype=f32),
             "ln_weight": e(h, dtype=f32), "ln_bias": e(h, dtype=f32)}
    _run("rt_attention_train_bwd",
         *_ptrs(x, dy, p["qkv_weight"], p["qkv_bias"], p["out_weight"],
                p["out_bias"], p["ln_weight"], mask, *bufs, dx,
                *grads.values()),
         b, s, h, num_heads, 1.0 / (h // num_heads) ** 0.5, eps,
         ctypes.byref(_dropout_args(seed, p_rate, h_rate)), _DTYPE_CODE[dt],
         _stream(dev))
    attention_train_backward.launches += 1
    if scratch is not None:
        scratch.update(qkv=bufs[0], ctx=bufs[1], z32=bufs[2])
    return dx, grads


def ffn_train_forward(x, p, seed, eps=1e-12, h_rate=0.0):
    """Kernel #5: (y, z rounded to the activation dtype)."""
    if x.device.type == "cpu":
        return ffn_train_forward_plain(x, p, seed, eps, h_rate)
    inter_size = _check_ffn(x, p)
    b, s, h = x.shape
    dev, dt = x.device, x.dtype
    inter = torch.empty((b * s, inter_size), dtype=dt, device=dev)
    z32 = torch.empty((b * s, h), dtype=torch.float32, device=dev)
    z = torch.empty_like(x)
    y = torch.empty_like(x)
    _run("rt_ffn_train_fwd",
         *_ptrs(x, p["w1"], p["b1"], p["w2"], p["b2"], p["ln_weight"],
                p["ln_bias"], inter, z32, z, y),
         b * s, s, h, inter_size, eps,
         ctypes.byref(_dropout_args(seed, 0.0, h_rate)), _DTYPE_CODE[dt],
         _stream(dev))
    ffn_train_forward.launches += 1
    return y, z


def ffn_train_backward(x, z, dy, p, seed, eps=1e-12, h_rate=0.0):
    """Kernel #6: (dx, float32 gradients of the packed parameters)."""
    if x.device.type == "cpu":
        return ffn_train_backward_plain(x, z, dy, p, seed, eps, h_rate)
    inter_size = _check_ffn(x, p)
    _check("z", z, x.shape, x.dtype, x.device)
    _check("dy", dy, x.shape, x.dtype, x.device)
    b, s, h = x.shape
    m, i, dev, dt, f32 = b * s, inter_size, x.device, x.dtype, torch.float32
    e = lambda *shape, dtype=dt: torch.empty(shape, dtype=dtype, device=dev)
    scratch = [e(m, h, dtype=f32), e(m, h, dtype=f32), e(m, h, dtype=f32),
               e(m, h), e(m, i), e(m, i), e(m, i),
               _partials(m, max(i, h), dev), _splits(i, h, dev)]
    dx = torch.empty_like(x)
    grads = {"w1": e(i, h, dtype=f32), "b1": e(i, dtype=f32),
             "w2": e(h, i, dtype=f32), "b2": e(h, dtype=f32),
             "ln_weight": e(h, dtype=f32), "ln_bias": e(h, dtype=f32)}
    _run("rt_ffn_train_bwd",
         *_ptrs(x, z, dy, p["w1"], p["b1"], p["w2"], p["ln_weight"],
                *scratch, dx, *grads.values()),
         m, s, h, i, eps,
         ctypes.byref(_dropout_args(seed, 0.0, h_rate)), _DTYPE_CODE[dt],
         _stream(dev))
    ffn_train_backward.launches += 1
    return dx, grads


attention_train_forward.launches = 0
attention_train_backward.launches = 0
ffn_train_forward.launches = 0
ffn_train_backward.launches = 0
KERNEL_WRAPPERS = (attention_train_forward, attention_train_backward,
                   ffn_train_forward, ffn_train_backward)


# ------------------------------------------------- the autograd Functions
class _AttentionTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask_bias, seed, num_heads, eps, p_rate, h_rate,
                span, *params):
        x = x.contiguous()
        pack = pack_attention(params, x.dtype)
        y = attention_train_forward(x, pack, mask_bias, seed, num_heads, eps,
                                    p_rate, h_rate)
        # The pack, not the parameters: the backward packs nothing, and a
        # float32 pack that is a parameter's storage keeps autograd's check
        # of in-place writes.
        ctx.save_for_backward(x, mask_bias, *pack.values())
        ctx.pack_keys = tuple(pack)
        ctx.args = (seed, num_heads, eps, p_rate, h_rate)
        ctx.span = span
        return y

    @staticmethod
    def backward(ctx, dy):
        with ctx.span("encoder.attn_bwd"):
            x, mask_bias, *pack = ctx.saved_tensors
            seed, num_heads, eps, p_rate, h_rate = ctx.args
            dx, g = attention_train_backward(
                x, dy.contiguous(), dict(zip(ctx.pack_keys, pack)), mask_bias,
                seed, num_heads, eps, p_rate, h_rate)
            h = x.shape[-1]
            dwq, dwk, dwv = g["qkv_weight"].split(h)
            dbq, dbk, dbv = g["qkv_bias"].split(h)
        return (dx, None, None, None, None, None, None, None,
                dwq, dbq, dwk, dbk, dwv, dbv, g["out_weight"], g["out_bias"],
                g["ln_weight"], g["ln_bias"])


class _FfnTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, eps, h_rate, span, *params):
        x = x.contiguous()
        pack = pack_ffn(params, x.dtype)
        y, z = ffn_train_forward(x, pack, seed, eps, h_rate)
        ctx.save_for_backward(x, z, *pack.values())
        ctx.pack_keys = tuple(pack)
        ctx.args = (seed, eps, h_rate)
        ctx.span = span
        return y

    @staticmethod
    def backward(ctx, dy):
        with ctx.span("encoder.ffn_bwd"):
            x, z, *pack = ctx.saved_tensors
            seed, eps, h_rate = ctx.args
            dx, g = ffn_train_backward(x, z, dy.contiguous(),
                                       dict(zip(ctx.pack_keys, pack)), seed,
                                       eps, h_rate)
        return (dx, None, None, None, None, g["w1"], g["b1"], g["w2"],
                g["b2"], g["ln_weight"], g["ln_bias"])


def attention_block_train(x: torch.Tensor, params: Dict[str, torch.Tensor],
                          mask_bias: torch.Tensor, seed: int, num_heads: int,
                          eps: float = 1e-12, p_rate: float = 0.0,
                          h_rate: float = 0.0, span=no_span) -> torch.Tensor:
    """Differentiable fused attention sub-block with in-kernel dropout.

    x: (B, S, H); params: the ATTN_PARAMS tensors by name; mask_bias: (B, S)
    additive float32 bias; seed: int in [0, 2**31) driving every dropout
    site of the layer (p_rate: probabilities, h_rate: output); span: the
    span hook whose 'encoder.attn_bwd' brackets the backward."""
    return _AttentionTrain.apply(x, mask_bias, int(seed), num_heads, eps,
                                 p_rate, h_rate, span,
                                 *(params[k] for k in ATTN_PARAMS))


def ffn_block_train(x: torch.Tensor, params: Dict[str, torch.Tensor],
                    seed: int, eps: float = 1e-12,
                    h_rate: float = 0.0, span=no_span) -> torch.Tensor:
    """Differentiable fused FFN sub-block with in-kernel output dropout;
    ``span``'s 'encoder.ffn_bwd' brackets the backward."""
    return _FfnTrain.apply(x, int(seed), eps, h_rate, span,
                           *(params[k] for k in FFN_PARAMS))
