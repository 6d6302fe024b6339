"""Primitive layers as functions on tensors.

Numerics follow ``realise_tpu.ops.layers``: parameters are stored in float32
and cast down to the activation dtype at the matmul, the matmul output is in
that dtype and the bias is added in it; layer norm runs in float32 whatever
the activation dtype. Weights keep torch's (out, in) layout. Dropout belongs
to training and is not part of this module.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T + bias`` with the mixed-precision rule: the weight and
    the bias are cast to x's dtype, the product is rounded to it and the bias
    is added in it."""
    return torch.matmul(x, weight.to(x.dtype).t()) + bias.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm computed in float32 regardless of the activation dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def embed(table: torch.Tensor, ids: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    return F.embedding(ids, table).to(dtype)


ACTIVATIONS = {
    "gelu": F.gelu,  # exact (erf) gelu, the reference BERT's 'gelu'
    "relu": F.relu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
}
