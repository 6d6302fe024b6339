"""The CharResNet's training-mode BatchNorm as CUDA kernels.

``csrc/batch_norm.cu`` (see the notes there for the design and the bound):

* :func:`bn_train_fwd` — one or two BatchNorms in one call: the batch
  statistics in float64 (weighted by row, or not), rounded to float32, the
  running statistics moved in place and ``num_batches_tracked`` counted,
  then ``relu(bn(x))`` or, on a block's tail, ``relu(bn(x) + bn2(x2))``;
* :func:`bn_train_bwd` — its gradient: dx (and dx2) in x's dtype, dweight
  and dbias float32 of each.

They replace no TPU kernel: the JAX package writes the BatchNorm in jnp
(``realise_tpu/ops/resnet.py``) and XLA fuses it. Their plain versions are
the eager functions of ``realise_tpu_torch/ops/resnet.py``
(``batch_norm_train``, ``_BatchNormTrain``) followed by ``torch.relu`` and
the add, as ``BasicBlock`` runs them: :func:`batch_norm_relu_plain` and
:func:`batch_norm_add_relu_plain`. The model's entry points,
:func:`batch_norm_relu` and :func:`batch_norm_add_relu`, take them for CPU
tensors and launch the kernels for CUDA tensors, raising on what the
kernels do not take: x other than 4-D contiguous float32 or bfloat16,
row weights other than (rows,) contiguous float32, BatchNorm tensors other
than float32 (C,), no rows, tensors on another device.

The kernels keep the plain version's rounding points (the statistics in
float64 rounded to float32, each float32 operation of the apply and of dx
rounded apart), so the outputs are the plain version's bits wherever the
statistics are; the sums run in other orders (fixed ones: two calls give
equal bits).

Counters (plain integers): ``bn_train_fwd.launches`` and
``bn_train_bwd.launches`` count the BatchNorm layers the kernels ran
(two a call on a block's tail): 15 each a training step of the
``resnet`` CharResNet, 12 of ``resnet1``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from realise_tpu_torch.ops.kernels._build import load

        lib = load("batch_norm")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rt_bn_fwd.argtypes = ([i, i, i, ll, i, i, p, p, p]
                                  + [p] * 12 + [p, ll, p, p])
        lib.rt_bn_bwd.argtypes = ([i, i, i, ll, i, i, p, p, p, p]
                                  + [p] * 4 + [p, ll] + [p] * 7)
        lib.rt_bn_scratch.argtypes = [i, i, i, i, ll, i, i]
        lib.rt_bn_fwd.restype = lib.rt_bn_bwd.restype = i
        lib.rt_bn_scratch.restype = ll
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def _scratch(backward: int, nbn: int, dtype: int, unit: int, rows: int,
             c: int, hw: int) -> int:
    n = _lib().rt_bn_scratch(backward, nbn, dtype, unit, rows, c, hw)
    if n < 0:
        raise ValueError(f"the BatchNorm kernels take no call of {rows} rows "
                         f"of {c} channels x {hw} positions")
    return n


def _unit(tensors: Sequence[Optional[torch.Tensor]], c: int, hw: int) -> int:
    """Elements a thread loads at once: a 16-byte vector where every
    tensor is 16-byte aligned, every row holds whole vectors and a vector
    one channel or whole channels; else 1."""
    vec = 16 // tensors[0].element_size()
    if ((c * hw) % vec == 0 and (hw % vec == 0 or vec % hw == 0)
            and all(t is None or t.data_ptr() % 16 == 0 for t in tensors)):
        return vec
    return 1


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(name: str, t: torch.Tensor, device: torch.device, dtypes,
           shape) -> None:
    if (t.device == device and t.dtype in dtypes and t.shape == shape
            and t.is_contiguous()):
        return
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}; the BatchNorm kernels take "
                         f"tensors on x's device, {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype}; the BatchNorm kernels "
                         f"take {', '.join(str(d) for d in dtypes)}")
    if t.shape != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, not {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_inputs(xs: Sequence[torch.Tensor],
                  weights: Optional[torch.Tensor]) -> Tuple[int, int, int]:
    x = xs[0]
    if x.dim() != 4:
        raise ValueError(f"x: {x.dim()}-D; the BatchNorm kernels take "
                         f"(rows, C, H, W)")
    rows, c, h, w = x.shape
    if rows < 1:
        raise ValueError("x: no rows; the batch statistics need one")
    for i, t in enumerate(xs):
        _check(f"x{i}", t, x.device, tuple(_DTYPES), x.shape)
    if weights is not None:
        _check("weights", weights, x.device, (torch.float32,), (rows,))
    return rows, c, h * w


def _check_bn(bn: nn.BatchNorm2d, device, c: int) -> None:
    for name in ("weight", "bias", "running_mean", "running_var"):
        t = getattr(bn, name)
        if t is None:
            raise ValueError(f"BatchNorm {name}: None; the kernels take an "
                             f"affine BatchNorm with running statistics")
        _check(f"BatchNorm {name}", t, device, (torch.float32,), (c,))
    _check("BatchNorm num_batches_tracked", bn.num_batches_tracked, device,
           (torch.int64,), ())


def bn_train_fwd(xs: Sequence[torch.Tensor], bns: Sequence[nn.BatchNorm2d],
                 weights: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """(y, coefs): y = relu(bn(x)) of the one (rows, C, H, W) CUDA tensor
    of ``xs``, or relu(bn(x) + bn2(x2)) of two, in x's dtype, each
    BatchNorm's statistics those of its batch (row n counting
    ``weights[n]`` times when given), its running statistics moved and
    ``num_batches_tracked`` counted. coefs: each BatchNorm's (2C + 1)
    float64 tensor, read by :func:`bn_train_bwd`: float32 mean, var, inv,
    shift (C each, ``.view(torch.float32)``), then float64 n."""
    rows, c, hw = _check_inputs(xs, weights)
    dev = xs[0].device
    for bn in bns:
        _check_bn(bn, dev, c)
    nbn = len(xs)
    if len(bns) != nbn or nbn not in (1, 2):
        raise ValueError(f"{nbn} inputs and {len(bns)} BatchNorms; the "
                         f"kernels take one of each or two of each")
    y = torch.empty_like(xs[0])
    coefs = tuple(torch.empty(2 * c + 1, dtype=torch.float64, device=dev)
                  for _ in xs)
    dtype = _DTYPES[xs[0].dtype]
    unit = _unit(list(xs) + [y], c, hw)
    scratch = torch.empty(_scratch(0, nbn, dtype, unit, rows, c, hw),
                          dtype=torch.float64, device=dev)
    sets = []
    for j in range(2):
        if j < nbn:
            bn = bns[j]
            sets += [bn.weight, bn.bias, bn.running_mean, bn.running_var,
                     bn.num_batches_tracked, coefs[j]]
        else:
            sets += [None] * 6
    err = _lib().rt_bn_fwd(
        nbn, dtype, unit, rows, c, hw, xs[0].data_ptr(),
        _ptr(xs[1]) if nbn == 2 else None, _ptr(weights),
        *(_ptr(t) for t in sets), scratch.data_ptr(), scratch.numel(),
        y.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"rt_bn_fwd launch failed: CUDA error {err}")
    bn_train_fwd.launches += nbn
    return y, coefs


def bn_train_bwd(dy: torch.Tensor, xs: Sequence[torch.Tensor],
                 gammas: Sequence[torch.Tensor], coefs: Sequence[torch.Tensor],
                 weights: Optional[torch.Tensor]):
    """(dxs, dgammas, dbetas) of :func:`bn_train_fwd`'s y under its
    gradient ``dy``: the ReLU's mask recomputed from ``xs`` with the
    forward's ``coefs``; dx in x's dtype, dweight and dbias float32 (C,)."""
    rows, c, hw = _check_inputs(xs, weights)
    dev = xs[0].device
    _check("dy", dy, dev, (xs[0].dtype,), xs[0].shape)
    nbn = len(xs)
    dxs = tuple(torch.empty_like(x) for x in xs)
    dgammas = tuple(torch.empty(c, dtype=torch.float32, device=dev)
                    for _ in xs)
    dbetas = tuple(torch.empty(c, dtype=torch.float32, device=dev)
                   for _ in xs)
    dtype = _DTYPES[xs[0].dtype]
    unit = _unit([dy] + list(xs) + list(dxs), c, hw)
    scratch = torch.empty(_scratch(1, nbn, dtype, unit, rows, c, hw),
                          dtype=torch.float64, device=dev)

    def second(ts):
        return _ptr(ts[1]) if nbn == 2 else None

    err = _lib().rt_bn_bwd(
        nbn, dtype, unit, rows, c, hw, dy.data_ptr(), xs[0].data_ptr(),
        second(xs), _ptr(weights), gammas[0].data_ptr(),
        coefs[0].data_ptr(), second(gammas), second(coefs),
        scratch.data_ptr(), scratch.numel(), dgammas[0].data_ptr(),
        dbetas[0].data_ptr(), second(dgammas), second(dbetas),
        dxs[0].data_ptr(), second(dxs), _stream(dev))
    if err != 0:
        raise RuntimeError(f"rt_bn_bwd launch failed: CUDA error {err}")
    bn_train_bwd.launches += nbn
    return dxs, dgammas, dbetas


bn_train_fwd.launches = 0
bn_train_bwd.launches = 0


class _BatchNormReluTrain(torch.autograd.Function):
    """relu(bn(x)) or relu(bn(x) + bn2(x2)) through the kernels; the
    running statistics move in the forward, as ``batch_norm_train``'s do.
    Keeps x (and x2) and the statistics: the ReLU's mask is recomputed."""

    @staticmethod
    def forward(ctx, bns, weights, x, weight, bias, x2=None, weight2=None,
                bias2=None):
        xs = (x,) if x2 is None else (x, x2)
        y, coefs = bn_train_fwd(xs, bns, weights)
        ctx.nbn = len(xs)
        ctx.save_for_backward(weights, x, x2, weight, weight2, *coefs)
        return y

    @staticmethod
    def backward(ctx, dy):
        weights, x, x2, weight, weight2, *coefs = ctx.saved_tensors
        two = ctx.nbn == 2
        dxs, dgammas, dbetas = bn_train_bwd(
            dy.contiguous(), (x, x2) if two else (x,),
            (weight, weight2) if two else (weight,), coefs, weights)
        second = (dxs[1], dgammas[1], dbetas[1]) if two else (None,) * 3
        return (None, None, dxs[0], dgammas[0], dbetas[0]) + second


def batch_norm_relu_plain(bn: nn.BatchNorm2d, x: torch.Tensor,
                          weights: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """``BasicBlock``'s first BatchNorm and ReLU in eager ops."""
    from realise_tpu_torch.ops.resnet import batch_norm_train

    return torch.relu(batch_norm_train(bn, x, weights))


def batch_norm_add_relu_plain(bn: nn.BatchNorm2d, x: torch.Tensor,
                              bn2: nn.BatchNorm2d, x2: torch.Tensor,
                              weights: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """``BasicBlock``'s tail in eager ops: the residual branch's BatchNorm,
    then the shortcut's, their sum and the ReLU."""
    from realise_tpu_torch.ops.resnet import batch_norm_train

    h = batch_norm_train(bn, x, weights)
    return torch.relu(h + batch_norm_train(bn2, x2, weights))


def batch_norm_relu(bn: nn.BatchNorm2d, x: torch.Tensor,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training-mode relu(bn(x)) (``weights``: the rows' multiplicities in
    the statistics, or None): the kernels for a CUDA x, the plain version
    for a CPU one."""
    if not x.is_cuda:
        return batch_norm_relu_plain(bn, x, weights)
    return _BatchNormReluTrain.apply((bn,), weights, x, bn.weight, bn.bias)


def batch_norm_add_relu(bn: nn.BatchNorm2d, x: torch.Tensor,
                        bn2: nn.BatchNorm2d, x2: torch.Tensor,
                        weights: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Training-mode relu(bn(x) + bn2(x2)), a block's tail: the kernels for
    CUDA tensors, the plain version for CPU ones."""
    if not x.is_cuda:
        return batch_norm_add_relu_plain(bn, x, bn2, x2, weights)
    return _BatchNormReluTrain.apply((bn, bn2), weights, x, bn.weight,
                                     bn.bias, x2, bn2.weight, bn2.bias)
