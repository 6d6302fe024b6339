"""Fused BERT-block kernels: the attention sub-block and the FFN sub-block.

Counterparts of ``realise_tpu/ops/pallas/bert_block.py`` ``attention_block``
and ``ffn_block``: each wrapper computes what its TPU kernel computes, in
CUDA C++ for sm_90a (``csrc/bert_block.cu``, see the notes there for the
design and the bound). For a CPU tensor a wrapper runs its plain PyTorch
version; for a CUDA tensor it launches the kernel or raises.

Parameters arrive packed by :func:`pack_attention` and :func:`pack_ffn`, the
one layout of every block kernel, serving and training
(``bert_block_train``): weights in torch's (out, in) layout and in the
activation dtype, the q/k/v weights stacked into one (3H, H) matrix; biases
and LayerNorm parameters in float32.

Numerics of the Pallas kernels, kept by both the kernels and the plain
versions: matmul outputs round to the activation dtype and biases are added
in it; scores, softmax and LayerNorm are float32 (eps as given). Two places
differ from the jnp sub-blocks ``realise_tpu.ops.bert._self_attention`` and
``_ffn`` (and so from ``realise_tpu_torch.ops.bert``):

* the FFN's second matmul is accumulated in float32 and NOT rounded before
  the residual (``_ffn`` rounds it to the activation dtype first);
* the attention scores are multiplied by ``scale = head_dim ** -0.5``
  (``_self_attention`` divides by ``sqrt(head_dim)``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from realise_tpu_torch.ops.kernels import (
    ATTN_MAX_HEAD_DIM,
    ATTN_MAX_SEQ,
    KERNEL_DTYPES,
)
from realise_tpu_torch.ops.layers import dense, layer_norm

# The parameters of one BertLayer, in the order the packers take them
# (ops/bert.BertLayer.block_params has them by these names).
ATTN_PARAMS = ("q_weight", "q_bias", "k_weight", "k_bias", "v_weight",
               "v_bias", "out_weight", "out_bias", "ln_weight", "ln_bias")
FFN_PARAMS = ("w1", "b1", "w2", "b2", "ln_weight", "ln_bias")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from realise_tpu_torch.ops.kernels._build import load

        lib = load("bert_block")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rt_attention_block.argtypes = [p] * 12 + [i] * 4 + [f, f, i, p]
        lib.rt_attention_block.restype = i
        lib.rt_ffn_block.argtypes = [p] * 10 + [i] * 3 + [f, i, p]
        lib.rt_ffn_block.restype = i
        _LIB = lib
    return _LIB


def pack_attention(params: Sequence[torch.Tensor],
                   dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The ATTN_PARAMS tensors, in that order → the layout the kernels read:
    [Wq|Wk|Wv] stacked (3H, H) and Wo in ``dtype``; biases and LayerNorm
    float32. Detached; a tensor that needs no cast or concatenation is its
    parameter's storage, not a copy."""
    wq, bq, wk, bk, wv, bv, wo, bo, g, beta = params
    packed = {"qkv_weight": torch.cat([wq, wk, wv]).to(dtype),
              "qkv_bias": torch.cat([bq, bk, bv]).float(),
              "out_weight": wo.to(dtype), "out_bias": bo.float(),
              "ln_weight": g.float(), "ln_bias": beta.float()}
    return {k: t.detach().contiguous() for k, t in packed.items()}


def pack_ffn(params: Sequence[torch.Tensor],
             dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The FFN_PARAMS tensors, in that order → W1 and W2 in ``dtype``;
    biases and LayerNorm float32 (as :func:`pack_attention`)."""
    w1, b1, w2, b2, g, beta = params
    packed = {"w1": w1.to(dtype), "b1": b1.float(), "w2": w2.to(dtype),
              "b2": b2.float(), "ln_weight": g.float(),
              "ln_bias": beta.float()}
    return {k: t.detach().contiguous() for k, t in packed.items()}


def _mask_rows(mask_bias: torch.Tensor, b: int, s: int) -> torch.Tensor:
    """(B, 1, 1, S) or (B, S) additive bias → contiguous float32 (B, S)."""
    return mask_bias.reshape(b, s).float().contiguous()


def attention_probs(qkv: torch.Tensor, b: int, mask_bias: torch.Tensor,
                    num_heads: int):
    """(q, k, v, probs) of a (B·S, 3H) q/k/v: the heads (B, S, heads, hd) in
    float32 and softmax(q·kᵀ·scale + mask) (B, heads, S, S) in float32."""
    h = qkv.shape[-1] // 3
    s, hd = qkv.shape[0] // b, h // num_heads
    q, k, v = (t.reshape(b, s, num_heads, hd).float()
               for t in qkv.split(h, dim=-1))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / hd ** 0.5)
    probs = torch.softmax(
        scores + _mask_rows(mask_bias, b, s)[:, None, None, :], dim=-1)
    return q, k, v, probs


def attention_context(probs: torch.Tensor, v: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """ctx (B·S, H) = probs·v per head, rounded to ``dtype``; probs (B,
    heads, S, S) already rounded to it."""
    b, s, heads, hd = v.shape
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(dtype).reshape(
        b * s, heads * hd)


def attention_block_plain(x: torch.Tensor, p: Dict[str, torch.Tensor],
                          mask_bias: torch.Tensor, num_heads: int,
                          eps: float = 1e-12) -> torch.Tensor:
    """y = LN(x + ctx·Wo + bo), ctx = softmax(q·kᵀ·scale + mask)·v per head."""
    b, s, h = x.shape
    dt = x.dtype
    xf = x.reshape(b * s, h)
    qkv = dense(xf, p["qkv_weight"], p["qkv_bias"])
    _, _, v, probs = attention_probs(qkv, b, mask_bias, num_heads)
    ctx = attention_context(probs.to(dt).float(), v, dt)
    attn = dense(ctx, p["out_weight"], p["out_bias"])
    y = layer_norm(xf.float() + attn.float(), p["ln_weight"], p["ln_bias"],
                   eps)
    return y.to(dt).reshape(b, s, h)


def ffn_block_plain(x: torch.Tensor, p: Dict[str, torch.Tensor],
                    eps: float = 1e-12) -> torch.Tensor:
    """y = LN(x + b2 + gelu(round(x·W1) + b1)·W2), the W2 product in float32."""
    b, s, h = x.shape
    dt = x.dtype
    xf = x.reshape(b * s, h)
    inter = F.gelu(dense(xf, p["w1"], p["b1"]).float()).to(dt)
    part = torch.matmul(inter.float(), p["w2"].to(dt).float().t())
    z = (xf.float() + p["b2"].float()) + part
    y = layer_norm(z, p["ln_weight"], p["ln_bias"], eps)
    return y.to(dt).reshape(b, s, h)


def _check(name: str, t: torch.Tensor, shape, dtype, device):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_x(x: torch.Tensor):
    if x.device.type != "cuda":
        raise ValueError(f"the kernels run on CUDA tensors, got {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, H), got shape {tuple(x.shape)}")
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"x dtype {x.dtype} not in {KERNEL_DTYPES}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def attention_block(x: torch.Tensor, p: Dict[str, torch.Tensor],
                    mask_bias: torch.Tensor, num_heads: int,
                    eps: float = 1e-12) -> torch.Tensor:
    """Fused q/k/v projection → attention → output projection → residual LN.

    x: (B, S, H); p: :func:`pack_attention`; mask_bias: (B, 1, 1, S)
    or (B, S) additive bias (−10000 on padding)."""
    if x.device.type == "cpu":
        return attention_block_plain(x, p, mask_bias, num_heads, eps)
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
    mask = _mask_rows(mask_bias, b, s)
    _check("mask_bias", mask, (b, s), f32, dev)
    qkv = torch.empty((b * s, 3 * h), dtype=dt, device=dev)
    ctx = torch.empty((b * s, h), dtype=dt, device=dev)
    z = torch.empty((b * s, h), dtype=f32, device=dev)
    y = torch.empty_like(x)
    ptrs = [t.data_ptr() for t in (
        x, p["qkv_weight"], p["qkv_bias"], p["out_weight"], p["out_bias"],
        p["ln_weight"], p["ln_bias"], mask, qkv, ctx, z, y)]
    err = _lib().rt_attention_block(
        *ptrs, b, s, h, num_heads, 1.0 / (hd ** 0.5), eps, _DTYPE_CODE[dt],
        _stream(dev))
    if err != 0:
        raise RuntimeError(f"rt_attention_block launch failed: CUDA error {err}")
    attention_block.launches += 1
    return y


def ffn_block(x: torch.Tensor, p: Dict[str, torch.Tensor],
              eps: float = 1e-12) -> torch.Tensor:
    """Fused intermediate → exact gelu → output → residual LN.

    x: (B, S, H); p: :func:`pack_ffn`."""
    if x.device.type == "cpu":
        return ffn_block_plain(x, p, eps)
    _check_x(x)
    b, s, h = x.shape
    inter_size = p["w1"].shape[0]
    dev, dt, f32 = x.device, x.dtype, torch.float32
    _check("w1", p["w1"], (inter_size, h), dt, dev)
    _check("b1", p["b1"], (inter_size,), f32, dev)
    _check("w2", p["w2"], (h, inter_size), dt, dev)
    for k in ("b2", "ln_weight", "ln_bias"):
        _check(k, p[k], (h,), f32, dev)
    inter = torch.empty((b * s, inter_size), dtype=dt, device=dev)
    z = torch.empty((b * s, h), dtype=f32, device=dev)
    y = torch.empty_like(x)
    ptrs = [t.data_ptr() for t in (
        x, p["w1"], p["b1"], p["w2"], p["b2"], p["ln_weight"], p["ln_bias"],
        inter, z, y)]
    err = _lib().rt_ffn_block(
        *ptrs, b * s, h, inter_size, eps, _DTYPE_CODE[dt], _stream(dev))
    if err != 0:
        raise RuntimeError(f"rt_ffn_block launch failed: CUDA error {err}")
    ffn_block.launches += 1
    return y


attention_block.launches = 0
ffn_block.launches = 0
