"""The training step's update as two multi-tensor CUDA kernels.

``csrc/adamw.cu`` (see the notes there for the design and the bound):

* :func:`global_norm_partials` — one launch over every gradient: each
  chunk's sum of squares;
* :func:`adamw_update` — one launch that sums those partials in a fixed
  order, reads the token count on the device, divides and clips each
  gradient as it reads it, and applies ``torch.optim.AdamW``'s update to
  every parameter and both moments in place.

They replace no TPU kernel: the JAX package leaves its optax chain to XLA.
Their plain version is the trainer's CPU path, the division, the port's
``training/optim.clip_by_global_norm`` and ``torch.optim.AdamW``;
``training/optim.AdamW`` launches the kernels on CUDA parameters.

The parameters' and moments' pointers, sizes and groups live in a device
table (:class:`Tables`), built once per optimizer in the order the kernels
walk (a tensor-parallel optimizer's split parameters first); the
gradients' pointers, new every step, go by value into each launch, at most
``MAX_TENSORS`` a launch. Only float32 contiguous tensors on one card are
taken: the wrappers raise on anything else.

Counters (plain integers): ``global_norm_partials.launches`` and
``adamw_update.launches`` count launches; ``adamw_update.tensors`` and
``adamw_update.elements`` are the last update's tensors and elements.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# Elements of a chunk (a multiple of 4, so an aligned tensor's chunks are
# 16-byte aligned), the gradients of one launch and the parameter groups,
# as csrc/adamw.cu has them.
CHUNK = 1 << 15
MAX_TENSORS = 448
MAX_GROUPS = 8

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from realise_tpu_torch.ops.kernels._build import load

        lib = load("adamw")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rt_adamw_norm.argtypes = [p, i, i, p, p, i, i, i, p, p]
        lib.rt_adamw_update.argtypes = [p, i, i, p, p, i, i, i, p, i, p, f, i,
                                        ctypes.POINTER(f), i, p, p]
        for fn in (lib.rt_adamw_norm, lib.rt_adamw_update,
                   lib.rt_adamw_max_tensors, lib.rt_adamw_max_groups):
            fn.restype = i
        if (lib.rt_adamw_max_tensors(), lib.rt_adamw_max_groups()) != (
                MAX_TENSORS, MAX_GROUPS):
            raise RuntimeError("csrc/adamw.cu and ops/kernels/adamw.py "
                               "disagree on the launch limits")
        _LIB = lib
    return _LIB


def chunk_table(numels: Sequence[int], chunk: int = CHUNK
                ) -> Tuple[np.ndarray, List[Tuple[int, int, int, int]]]:
    """The kernels' work over tensors of ``numels`` elements, in order:
    (C, 2) int64 rows (tensor index, first element) of every chunk, and
    the launch slices (first tensor, tensors, first chunk, end chunk) of at
    most ``MAX_TENSORS`` tensors each."""
    counts = [-(-n // chunk) for n in numels]
    rows = np.zeros((sum(counts), 2), np.int64)
    rows[:, 0] = np.repeat(np.arange(len(numels)), counts)
    starts = np.cumsum([0] + counts)
    rows[:, 1] = (np.arange(len(rows))
                  - np.repeat(starts[:-1], counts)) * chunk
    slices = [(t, min(MAX_TENSORS, len(numels) - t), int(starts[t]),
               int(starts[min(t + MAX_TENSORS, len(numels))]))
              for t in range(0, len(numels), MAX_TENSORS)]
    return rows, slices


def _check(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}; the update kernels take "
                         f"tensors on one CUDA device, {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: dtype {t.dtype}; the update kernels take "
                         f"float32")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


class Tables:
    """The device tables of the kernels over ``params`` and their moments,
    in the order given (the split parameters first, ``n_split`` of them):
    one row (parameter, first moment and second moment pointers, elements,
    group) per tensor, one (tensor, first element) per chunk, and the
    scratch of the chunks' partial sums. The tables hold raw pointers: build
    them again when a tensor is replaced."""

    def __init__(self, params: Sequence[torch.Tensor],
                 exp_avgs: Sequence[torch.Tensor],
                 exp_avg_sqs: Sequence[torch.Tensor], groups: Sequence[int],
                 n_split: int = 0):
        if not params:
            raise ValueError("no parameters")
        device = params[0].device
        if device.type != "cuda":
            raise ValueError(f"the update kernels run on CUDA tensors, got "
                             f"{device}")
        for i, (p, m, v) in enumerate(zip(params, exp_avgs, exp_avg_sqs)):
            for name, t in ((f"parameter {i}", p), (f"exp_avg {i}", m),
                            (f"exp_avg_sq {i}", v)):
                _check(name, t, device)
                if t.shape != p.shape:
                    raise ValueError(f"{name}: shape {tuple(t.shape)}, its "
                                     f"parameter's {tuple(p.shape)}")
        if max(groups) >= MAX_GROUPS:
            raise ValueError(f"{max(groups) + 1} parameter groups; the update "
                             f"kernel takes at most {MAX_GROUPS}")
        self.device = device
        self.params = list(params)
        self.moments = (list(exp_avgs), list(exp_avg_sqs))  # kept alive
        self.numels = [p.numel() for p in params]
        self.elements = sum(self.numels)
        rows = torch.tensor([[p.data_ptr(), m.data_ptr(), v.data_ptr(), n, g]
                             for p, m, v, n, g in zip(
                                 params, exp_avgs, exp_avg_sqs, self.numels,
                                 groups)], dtype=torch.int64)
        chunks, self.slices = chunk_table(self.numels)
        self.tensors = rows.to(device)
        self.chunks = torch.from_numpy(chunks).to(device)
        self.n_chunks = len(chunks)
        self.split_chunks = int(sum(-(-n // CHUNK)
                                    for n in self.numels[:n_split]))
        self.partials = torch.zeros(max(self.n_chunks, 1), dtype=torch.float32,
                                    device=device)
        self.n_groups = max(groups) + 1

    def gradient_pointers(self, grads: Sequence[Optional[torch.Tensor]]):
        """The gradients' pointers (a ctypes array), each checked: float32,
        contiguous, on the tables' device, its parameter's shape."""
        index = self.device.index
        ptrs = []
        for i, (g, p) in enumerate(zip(grads, self.params)):
            if g is None:
                raise ValueError(f"parameter {i} has no gradient; the update "
                                 f"kernel steps every parameter")
            if (g.dtype != torch.float32 or not g.is_cuda
                    or g.get_device() != index or not g.is_contiguous()
                    or g.shape != p.shape):
                _check(f"gradient {i}", g, self.device)
                raise ValueError(f"gradient {i}: shape {tuple(g.shape)}, its "
                                 f"parameter's {tuple(p.shape)}")
            ptrs.append(g.data_ptr())
        return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def global_norm_partials(tables: Tables, grads) -> torch.Tensor:
    """Each chunk's sum of the squares of ``grads`` (their pointers,
    :meth:`Tables.gradient_pointers`) into ``tables.partials``, which it
    returns (the split parameters' chunks first)."""
    lib, stream = _lib(), _stream(tables.device)
    for first, n, c0, c1 in tables.slices:
        err = lib.rt_adamw_norm(
            ctypes.addressof(grads) + first * ctypes.sizeof(ctypes.c_void_p),
            first, n, tables.tensors.data_ptr(), tables.chunks.data_ptr(),
            c0, c1, CHUNK, tables.partials.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"rt_adamw_norm launch failed: CUDA error "
                               f"{err}")
        global_norm_partials.launches += 1
    return tables.partials


def group_scalars(lr: float, betas: Tuple[float, float], eps: float,
                  weight_decay: float, step: int) -> Tuple[float, ...]:
    """One group's scalars of the update kernel at step ``step`` (from 1),
    in double precision as ``torch.optim.AdamW`` forms them: 1 - lr·wd,
    1 - beta1, beta2, 1 - beta2, -lr / (1 - beta1^t), sqrt(1 - beta2^t),
    eps."""
    beta1, beta2 = betas
    return (1 - lr * weight_decay, 1 - beta1, beta2, 1 - beta2,
            (lr / (1 - beta1 ** step)) * -1, (1 - beta2 ** step) ** 0.5, eps)


def adamw_update(tables: Tables, grads, count: Optional[torch.Tensor],
                 max_norm: Optional[float],
                 scalars: Sequence[Tuple[float, ...]],
                 norm_out: Optional[torch.Tensor] = None) -> None:
    """AdamW over every tensor of ``tables`` with ``grads`` (their
    pointers) divided by ``count`` (a float32 scalar on the device, clamped
    to 1; None: 1) and, with ``max_norm``, clipped by the norm of
    :func:`global_norm_partials`' sums, which must have run over the same
    gradients (the norm is written to ``norm_out``). ``scalars``: each
    group's :func:`group_scalars`."""
    if count is not None:
        _check("count", count, tables.device)
        if count.numel() != 1:
            raise ValueError(f"count: {count.numel()} elements, not one")
    if norm_out is not None:
        _check("norm_out", norm_out, tables.device)
    if len(scalars) != tables.n_groups:
        raise ValueError(f"{len(scalars)} groups' scalars for "
                         f"{tables.n_groups} groups")
    fields = (ctypes.c_float * (7 * len(scalars)))(
        *[s[f] for f in range(7) for s in scalars])
    lib, stream = _lib(), _stream(tables.device)
    for first, n, c0, c1 in tables.slices:
        err = lib.rt_adamw_update(
            ctypes.addressof(grads) + first * ctypes.sizeof(ctypes.c_void_p),
            first, n, tables.tensors.data_ptr(), tables.chunks.data_ptr(),
            c0, c1, CHUNK, tables.partials.data_ptr(), tables.n_chunks,
            None if count is None else count.data_ptr(),
            float("inf") if max_norm is None else max_norm,
            int(max_norm is not None), fields, len(scalars),
            None if norm_out is None else norm_out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"rt_adamw_update launch failed: CUDA error "
                               f"{err}")
        adamw_update.launches += 1
    adamw_update.tensors = len(tables.numels)
    adamw_update.elements = tables.elements


global_norm_partials.launches = 0
adamw_update.launches = 0
adamw_update.tensors = 0
adamw_update.elements = 0
