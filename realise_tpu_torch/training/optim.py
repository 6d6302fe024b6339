"""Optimizer: AdamW with decoupled decay groups, global-norm clipping and the
linear warmup schedule (the port of ``realise_tpu.training.optim``).

The reference's recipe (run.py:146-154, optimization.py:45-169), with the JAX
package's arithmetic (optax ``clip_by_global_norm`` then ``adamw``):

* weight decay excluded for every parameter whose torch name contains
  ``bias`` (the GRU's ``bias_ih_l0``/``bias_hh_l0`` too) and for every
  LayerNorm (``resnet_layernorm`` too); BatchNorm weights are decayed;
* the gradient is scaled by ``max_norm / norm`` only when its global norm
  reaches ``max_norm`` (no ``+ 1e-6`` as in ``torch.nn.utils.clip_grad_norm_``);
* the update is ``-lr * (m̂ / (√v̂ + eps) + wd * p)``, which
  ``torch.optim.AdamW`` computes within float rounding;
* linear warmup 0 → peak, then linear decay to 0 at ``total_steps``,
  evaluated on the host.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn


def decay_mask(named_parameters: Iterable[Tuple[str, torch.Tensor]]
               ) -> List[Tuple[str, bool]]:
    """[(name, receives weight decay)] over torch parameter names."""
    return [(name, not ("bias" in name or "LayerNorm" in name
                        or "layernorm" in name))
            for name, _ in named_parameters]


def linear_warmup_schedule(peak_lr: float, warmup_steps: int,
                           total_steps: int) -> Callable[[int], float]:
    """Linear 0 → peak over ``warmup_steps``, then linear peak → 0 over the
    remaining steps (optax ``linear_schedule`` pieces joined at the warmup
    boundary, as the JAX package builds it)."""
    warmup_steps = max(warmup_steps, 0)
    decay_steps = max(total_steps - warmup_steps, 1)

    def linear(init: float, end: float, steps: int, count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    def schedule(step: int) -> float:
        if warmup_steps == 0:
            return linear(peak_lr, 0.0, decay_steps, step)
        if step < warmup_steps:
            return linear(0.0, peak_lr, warmup_steps, step)
        return linear(peak_lr, 0.0, decay_steps, step - warmup_steps)

    return schedule


def make_optimizer(model: nn.Module, learning_rate: float = 5e-5,
                   weight_decay: float = 0.0,
                   adam_epsilon: float = 1e-8) -> torch.optim.AdamW:
    """AdamW (b1 0.9, b2 0.999) over two groups: decayed and not decayed."""
    params = dict(model.named_parameters())
    mask = decay_mask(params.items())
    groups = [
        {"params": [params[n] for n, d in mask if d],
         "weight_decay": weight_decay},
        {"params": [params[n] for n, d in mask if not d],
         "weight_decay": 0.0},
    ]
    return torch.optim.AdamW(groups, lr=learning_rate, betas=(0.9, 0.999),
                             eps=adam_epsilon)


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        split: Optional[Sequence[bool]] = None,
                        group=None) -> torch.Tensor:
    """Scale the gradients in place by ``max_norm / norm`` when their global
    norm reaches ``max_norm`` (optax's rule); returns the norm. No host sync.

    Tensor parallelism: ``split[i]`` marks a gradient that is this rank's
    slice of its parameter's. The squared norms of the split ones are
    summed over the model ``group``; the replicated ones, the same on every
    rank of the group, count once. The norm is then one process's."""
    norms = torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    if split is None or not any(split):
        norm = torch.linalg.vector_norm(norms)
    else:
        mask = torch.tensor(list(split), device=norms.device)
        sq = norms.square()
        shards = sq[mask].sum().reshape(1)
        dist.all_reduce(shards, op=dist.ReduceOp.SUM, group=group)
        norm = torch.sqrt(sq[~mask].sum() + shards[0])
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm
