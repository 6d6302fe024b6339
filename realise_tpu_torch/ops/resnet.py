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
variance (torch's and the JAX package's rule; updated in place). The
module names are the reference's (``res_block{k}.residual_function.{0,1,3,4}``,
``res_block{k}.shortcut.{0,1}``). ``CharResNet`` starts in eval mode.
"""

from __future__ import annotations

from typing import List

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


def batch_norm_train(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Batch statistics in float32; updates ``bn``'s running statistics."""
    x32 = x.float()
    mean = x32.mean(dim=(0, 2, 3))
    var = x32.var(dim=(0, 2, 3), unbiased=False)
    with torch.no_grad():
        n = x.shape[0] * x.shape[2] * x.shape[3]
        unbiased = var * (n / max(n - 1, 1))
        bn.running_mean.copy_((1 - BN_MOMENTUM) * bn.running_mean
                              + BN_MOMENTUM * mean)
        bn.running_var.copy_((1 - BN_MOMENTUM) * bn.running_var
                             + BN_MOMENTUM * unbiased)
        bn.num_batches_tracked += 1
    inv = torch.rsqrt(var + BN_EPS) * bn.weight
    shift = bn.bias - mean * inv
    return (x32 * inv[:, None, None] + shift[:, None, None]).to(x.dtype)


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    return batch_norm_train(bn, x) if bn.training else batch_norm_eval(bn, x)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rf = self.residual_function
        h = torch.relu(batch_norm(rf[1], conv2d(rf[0], x)))
        h = batch_norm(rf[4], conv2d(rf[3], h))
        sc = x
        if len(self.shortcut):
            sc = batch_norm(self.shortcut[1], conv2d(self.shortcut[0], x))
        return torch.relu(h + sc)


class CharResNet(nn.Module):
    """(N, F, 32, 32) glyphs → (N, hidden) features."""

    def __init__(self, in_channels: int, hidden_size: int = 768,
                 variant: str = "resnet"):
        super().__init__()
        prev = in_channels
        for i, ch in enumerate(_channels(variant, hidden_size)):
            self.add_module(f"res_block{i + 1}", BasicBlock(prev, ch, stride=2))
            prev = ch
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.children():
            x = block(x)
        return x.reshape(x.shape[0], -1)
