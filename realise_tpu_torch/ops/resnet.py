"""CharResNet glyph encoder (the "See" stream).

The port of ``realise_tpu.ops.resnet.char_resnet`` for the
``resnet`` variant (reference: src/char_cnn.py:9-55): five stride-2
BasicBlocks take an F×32×32 glyph stack to an H-vector, each block
conv3×3-BN-ReLU-conv3×3-BN plus a 1×1-conv-BN shortcut. Inputs stay NCHW and
kernels OIHW, torch's own layout; convolutions pad symmetrically (torch's
``padding=1``). BatchNorm (eps 1e-5) is applied in float32 as
``x * inv + (bias - mean * inv)``, the JAX form: in eval mode with the
running statistics, in training mode (the module's ``training`` flag) with
the batch's mean and biased variance over (N, H, W), while the running
statistics move by momentum 0.1 towards the batch mean and the unbiased
variance (torch's and the JAX package's rule; updated in place), or with
per-row weights, the statistics of a batch holding each row that many
times (the factorized conv stream's occurrence counts). The
module names are the reference's (``res_block{k}.residual_function.{0,1,3,4}``,
``res_block{k}.shortcut.{0,1}``). ``CharResNet`` starts in eval mode.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def _channels(variant: str, hidden_size: int = 768) -> List[int]:
    """Channel plan scaled off the model width: 64→128→256→512→768 at 768."""
    if variant != "resnet":
        raise NotImplementedError(f"res encoder {variant!r} is not ported yet")
    h = hidden_size
    return [max(h // 12, 1), max(h // 6, 1), max(h // 3, 1),
            max((2 * h) // 3, 1), h]


def batch_norm_eval(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    inv = torch.rsqrt(bn.running_var + BN_EPS) * bn.weight
    shift = bn.bias - bn.running_mean * inv
    return (x.float() * inv[:, None, None] + shift[:, None, None]).to(x.dtype)


class _BatchNormTrain(torch.autograd.Function):
    """``x * inv + (bias - mean * inv)`` (inv = weight·r, r = rsqrt(var +
    eps)) for statistics computed apart, with the batch-norm gradient in its
    centred form, x̂ = (x − mean)·r:

        dx = weight·r · (dy − w/T · (Σdy + x̂ · Σ(dy·x̂))),

    w the row weights (1 without), T the weighted count. The statistics'
    dependence on x is in the formula, so they come in without a graph, and
    only x in its own dtype is kept for the backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, weights, total):
        inv = torch.rsqrt(var + BN_EPS) * weight
        shift = bias - mean * inv
        ctx.save_for_backward(x, weight, mean, var, weights)
        ctx.total = total
        return (x.float() * inv[:, None, None] + shift[:, None, None]).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, var, weights = ctx.saved_tensors
        r = torch.rsqrt(var + BN_EPS)
        xhat = (x.float() - mean[:, None, None]) * r[:, None, None]
        g = dy.float()
        sum_dy = g.sum(dim=(0, 2, 3))
        sum_dyx = (g * xhat).sum(dim=(0, 2, 3))
        scale = 1.0 / ctx.total
        if weights is not None:
            scale = weights.float()[:, None, None, None] / ctx.total
        dx = (weight * r)[:, None, None] * (
            g - scale * (sum_dy[:, None, None] + xhat * sum_dyx[:, None, None]))
        return dx.to(x.dtype), sum_dyx, sum_dy, None, None, None, None


def batch_norm_train(bn: nn.BatchNorm2d, x: torch.Tensor,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batch statistics accumulated in float64 and rounded to float32;
    updates ``bn``'s running statistics.

    ``weights``: optional (N,) row multiplicities (the factorized conv
    stream's occurrence counts). Then the statistics are the weighted mean
    and variance, those of a batch holding row n ``weights[n]`` times, with
    the JAX package's formulas (ops/resnet.py:122-146): tot = max(Σw·H·W,
    1), var = max(E_w[x²] − mean², 0), the running variance unbiased by
    tot / max(tot − 1, 1).

    Float64 accumulation: after a ReLU, and with most rows one shared glyph
    (the padding's), a channel's mean can dwarf its spread. The one-pass
    weighted variance in float32 then loses most of its digits, and the
    per-token and the factorized streams, whose float32 statistics came
    from different formulas, gave conv gradients further apart than
    chip_smoke.py's equality limit. Accumulated in float64 and rounded to
    float32, both streams' statistics agree up to that rounding. The
    gradient is :class:`_BatchNormTrain`'s."""
    with torch.no_grad():
        x64 = x.double()
        if weights is None:
            mean = x64.mean(dim=(0, 2, 3))
            var = x64.var(dim=(0, 2, 3), unbiased=False)
            n = x.shape[0] * x.shape[2] * x.shape[3]
            unbiased_n = max(n - 1, 1)
        else:
            w = weights.double()
            n = torch.clamp(w.sum() * (x.shape[2] * x.shape[3]), min=1.0)
            unbiased_n = torch.clamp(n - 1.0, min=1.0)
            mean = torch.einsum("nchw,n->c", x64, w) / n
            var = torch.clamp(torch.einsum("nchw,n->c", x64 * x64, w) / n
                              - mean * mean, min=0.0)
        del x64
        mean, var = mean.float(), var.float()
        unbiased = var * (n / unbiased_n)
        bn.running_mean.copy_((1 - BN_MOMENTUM) * bn.running_mean
                              + BN_MOMENTUM * mean)
        bn.running_var.copy_((1 - BN_MOMENTUM) * bn.running_var
                             + BN_MOMENTUM * unbiased)
        bn.num_batches_tracked += 1
    return _BatchNormTrain.apply(x, bn.weight, bn.bias, mean, var, weights, n)


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eval mode: the running statistics (``weights`` unused); training
    mode: :func:`batch_norm_train`."""
    if bn.training:
        return batch_norm_train(bn, x, weights)
    return batch_norm_eval(bn, x)


def conv2d(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(x.dtype), stride=conv.stride,
                    padding=conv.padding)


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int):
        super().__init__()
        self.residual_function = nn.Sequential(
            nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1, bias=False),
            nn.BatchNorm2d(out_ch, eps=BN_EPS),
            nn.ReLU(inplace=True),
            nn.Conv2d(out_ch, out_ch, 3, stride=1, padding=1, bias=False),
            nn.BatchNorm2d(out_ch, eps=BN_EPS),
        )
        if stride != 1 or in_ch != out_ch:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                nn.BatchNorm2d(out_ch, eps=BN_EPS),
            )
        else:
            self.shortcut = nn.Sequential()

    def forward(self, x: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        rf = self.residual_function
        h = torch.relu(batch_norm(rf[1], conv2d(rf[0], x), weights))
        h = batch_norm(rf[4], conv2d(rf[3], h), weights)
        sc = x
        if len(self.shortcut):
            sc = batch_norm(self.shortcut[1], conv2d(self.shortcut[0], x),
                            weights)
        return torch.relu(h + sc)


class CharResNet(nn.Module):
    """(N, F, 32, 32) glyphs → (N, hidden) features; ``weights``: optional
    (N,) row multiplicities of the training-mode BatchNorm statistics."""

    def __init__(self, in_channels: int, hidden_size: int = 768,
                 variant: str = "resnet"):
        super().__init__()
        prev = in_channels
        for i, ch in enumerate(_channels(variant, hidden_size)):
            self.add_module(f"res_block{i + 1}", BasicBlock(prev, ch, stride=2))
            prev = ch
        self.eval()

    def forward(self, x: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        for block in self.children():
            x = block(x, weights)
        return x.reshape(x.shape[0], -1)
