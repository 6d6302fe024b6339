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

On CUDA parameters the division, the clip and AdamW are the two kernels of
``ops/kernels/adamw`` (:class:`AdamW`); on CPU ones they are
:func:`clip_by_global_norm` and ``torch.optim.AdamW``, their plain version.
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import torch
import torch.distributed as dist
from torch import nn

from realise_tpu_torch.ops.kernels import adamw as kernels


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


class AdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` whose update of CUDA parameters is two kernels.

    On CPU parameters every method is torch's. On CUDA ones
    (:attr:`runs_kernels`) each :meth:`step` follows a :meth:`clip`, which
    declares the gradients the step's undivided sums and launches the norm
    kernel; :meth:`step` then launches ``ops/kernels/adamw``'s update
    kernel, or raises: it takes float32 contiguous tensors on one card, a
    gradient for every parameter, and none of amsgrad, maximize, capturable
    or differentiable. The gradients are left as they were. The state keeps
    torch's format, ``state[p]`` with ``step``, ``exp_avg`` and
    ``exp_avg_sq`` (the moments updated in place, and their versions and
    the parameters' bumped as an in-place op bumps them), but the kernel path
    counts the steps once per group and writes them into each
    ``state[p]['step']`` only in :meth:`state_dict` (and when pickled).
    ``split``: the parameters that are a rank's slice of a tensor-parallel
    tensor; their squares are summed apart (:meth:`clip`)."""

    def __init__(self, params, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2, *, split: Iterable = (), **kw):
        super().__init__(params, lr=lr, betas=betas, eps=eps,
                         weight_decay=weight_decay, **kw)
        self._split = {id(p) for p in split}
        self._forget_tables()

    def _forget_tables(self) -> None:
        # The tables and the step counts are taken again from the state at
        # the next kernel step.
        self._tables: Optional[kernels.Tables] = None
        self._steps: Optional[List[int]] = None
        self._pending = None
        self._order: List[torch.Tensor] = []

    def __setstate__(self, state: Dict[str, Any]) -> None:
        super().__setstate__(state)  # also the end of load_state_dict
        self._forget_tables()
        self.__dict__.setdefault("_split", set())

    def __getstate__(self) -> Dict[str, Any]:
        self._write_steps()
        return super().__getstate__()

    def add_param_group(self, param_group: Dict[str, Any]) -> None:
        self._write_steps()
        super().add_param_group(param_group)
        self._forget_tables()

    def state_dict(self) -> Dict[str, Any]:
        self._write_steps()
        return super().state_dict()

    def _write_steps(self) -> None:
        if getattr(self, "_steps", None) is None:
            return
        for n, group in zip(self._steps, self.param_groups):
            for p in group["params"]:
                self.state[p]["step"].fill_(n)

    @property
    def runs_kernels(self) -> bool:
        """Whether the parameters are on the card, so that a step is
        :meth:`clip` and then :meth:`step`, the two kernels; on the CPU it
        is torch's :meth:`step` over gradients already divided and
        clipped."""
        return self._on_cuda()

    def _on_cuda(self) -> bool:
        if self._tables is not None:
            return True
        types = {p.device.type for g in self.param_groups for p in g["params"]}
        if "cuda" not in types:
            return False
        if types != {"cuda"}:
            raise ValueError(f"parameters on {sorted(types)}: the update "
                             f"kernels take tensors on one CUDA device")
        return True

    def _kernel_tables(self) -> kernels.Tables:
        """The device tables, built at the first kernel step and after the
        state or the groups change: each parameter's state (torch's zeros
        where it has none) and each group's step count, which must be one
        for all its parameters."""
        if self._tables is not None:
            return self._tables
        params, groups, steps = [], [], []
        for gi, group in enumerate(self.param_groups):
            for flag in ("amsgrad", "maximize", "capturable",
                         "differentiable"):
                if group.get(flag):
                    raise ValueError(f"group {gi}: {flag} is not in the "
                                     f"update kernel")
            seen = set()
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0, dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                seen.add(float(st["step"]))
                params.append(p)
                groups.append(gi)
            if len(seen) > 1:
                raise ValueError(f"group {gi}: parameters at steps "
                                 f"{sorted(seen)}; the update kernel counts "
                                 f"one step a group")
            steps.append(int(seen.pop()) if seen else 0)
        order = sorted(range(len(params)),
                       key=lambda i: id(params[i]) not in self._split)
        self._order = [params[i] for i in order]
        self._tables = kernels.Tables(
            self._order, [self.state[p]["exp_avg"] for p in self._order],
            [self.state[p]["exp_avg_sq"] for p in self._order],
            [groups[i] for i in order],
            n_split=sum(id(p) in self._split for p in params))
        self._steps = steps
        return self._tables

    @torch.no_grad()
    def clip(self, count: torch.Tensor, max_norm: Optional[float],
             group=None) -> Optional[torch.Tensor]:
        """CUDA parameters: declare their gradients the step's sums over
        ``count`` tokens (a float32 scalar on the card, clamped to 1), to be
        divided by it and, with ``max_norm``, clipped by optax's rule in the
        next :meth:`step`. With ``max_norm`` this launches the norm kernel;
        ``group``, under tensor parallelism: the model group, over which the
        split parameters' partial sums are all-reduced. Returns the norm of
        the divided gradient, a 0-d tensor that the next step fills (None
        without ``max_norm``)."""
        if not self._on_cuda():
            raise ValueError("clip() is the kernel path's; on the CPU divide "
                             "the gradients and clip them "
                             "(clip_by_global_norm) before step()")
        tables = self._kernel_tables()
        norm = None
        if max_norm is not None:
            partials = kernels.global_norm_partials(
                tables, tables.gradient_pointers(
                    [p.grad for p in self._order]))
            if group is not None and tables.split_chunks:
                dist.all_reduce(partials[:tables.split_chunks],
                                op=dist.ReduceOp.SUM, group=group)
            norm = torch.empty((), device=tables.device)
        self._pending = (count, max_norm, norm)
        return norm

    @torch.no_grad()
    def step(self, closure=None):
        if not self._on_cuda():
            return super().step(closure)
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        if self._pending is None:
            raise ValueError("step() of CUDA parameters follows clip(), "
                             "which declares the gradients' token count "
                             "and clip")
        tables = self._kernel_tables()
        grads = tables.gradient_pointers([p.grad for p in self._order])
        count, max_norm, norm = self._pending
        self._pending = None
        scalars = []
        for i, group in enumerate(self.param_groups):
            self._steps[i] += 1
            scalars.append(kernels.group_scalars(
                float(group["lr"]), group["betas"], group["eps"],
                group["weight_decay"], self._steps[i]))
        kernels.adamw_update(tables, grads, count, max_norm, scalars, norm)
        # The kernel writes through raw pointers: bump the versions an
        # in-place op would, so that caches keyed on them (the block kernels'
        # packs, BertLayer.kernel_params) and autograd see the write.
        torch.autograd.graph.increment_version(
            tables.params + tables.moments[0] + tables.moments[1])
        return loss


def make_optimizer(model: nn.Module, learning_rate: float = 5e-5,
                   weight_decay: float = 0.0, adam_epsilon: float = 1e-8,
                   split: Iterable = ()) -> AdamW:
    """AdamW (b1 0.9, b2 0.999) over two groups: decayed and not decayed.
    ``split``: the tensor-parallel slices among the parameters."""
    params = dict(model.named_parameters())
    mask = decay_mask(params.items())
    groups = [
        {"params": [params[n] for n, d in mask if d],
         "weight_decay": weight_decay},
        {"params": [params[n] for n, d in mask if not d],
         "weight_decay": 0.0},
    ]
    return AdamW(groups, lr=learning_rate, betas=(0.9, 0.999),
                 eps=adam_epsilon, split=split)


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
