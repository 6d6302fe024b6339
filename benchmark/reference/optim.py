"""The optimizer's arithmetic of the reference recipe (src/run.py:146-154,
203-207; transformers' AdamW and get_linear_schedule_with_warmup):

* the gradients of the loss sum are divided by the count of loss positions;
* the global-norm clip scales every gradient by max_norm / norm when the
  norm reaches max_norm;
* AdamW (b1 0.9, b2 0.999, eps outside the bias-corrected root): decoupled
  weight decay, p <- p * (1 - lr * wd), on every parameter whose name holds
  neither "bias" nor "LayerNorm"/"layernorm"; then
  p <- p - lr * m_hat / (sqrt(v_hat) + eps);
* the learning rate rises linearly from 0 over the warmup steps, then falls
  linearly to 0 at the last step.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def decayed(name: str) -> bool:
    return not ("bias" in name or "LayerNorm" in name or "layernorm" in name)


def learning_rate(step: int, peak: float, warmup: int, total: int) -> float:
    if warmup and step < warmup:
        return peak * step / warmup
    span = max(total - warmup, 1)
    return peak * (1.0 - min(max(step - warmup, 0), span) / span)


class AdamW:
    def __init__(self, names: List[str], opt: Dict):
        self.names = names
        self.opt = opt
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], step: int) -> None:
        o = self.opt
        lr = learning_rate(step, o["learning_rate"], o["warmup_steps"],
                           o["total_steps"])
        b1, b2, eps, wd = 0.9, 0.999, o["adam_epsilon"], o["weight_decay"]
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for n in self.names:
            p, g = params[n], grads[n]
            if n not in self.m:
                self.m[n] = torch.zeros_like(p)
                self.v[n] = torch.zeros_like(p)
            m, v = self.m[n], self.v[n]
            if decayed(n):
                p.mul_(1 - lr * wd)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.addcdiv_(m, (v.sqrt() / c2 ** 0.5).add_(eps), value=-lr / c1)


@torch.no_grad()
def clip(grads: Dict[str, torch.Tensor], max_norm: float) -> torch.Tensor:
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads.values()]))
    if float(norm) >= max_norm:
        for g in grads.values():
            g.mul_(max_norm / norm)
    return norm
