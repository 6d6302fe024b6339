"""The tied head's masked cross-entropy as two CUDA kernels.

``csrc/masked_ce.cu`` (see the notes there for the design and the bound):

* :func:`masked_ce_fwd` — one read of the (rows, V) logits: each row's
  log-partition ``logz`` and gold logit, float32;
* :func:`masked_ce_bwd` — one more read of the logits and one write of
  ``dlogits`` in their dtype, and with a bias its gradient, the float32
  column sum of the rounded ``dlogits`` (a row of partial sums for every
  ``ROW_CHUNK`` rows, then a small launch that sums them in order).

They replace no TPU kernel: the JAX package writes the loss as a hand VJP in
jnp (``realise_tpu/models/realise.py``, ``masked_cross_entropy_sum``) and
XLA fuses it. Their plain versions, :func:`masked_ce_fwd_plain` and
:func:`masked_ce_bwd_plain`, are that VJP's arithmetic in float32 tensor
ops; the wrappers take them for CPU tensors and launch the kernels for CUDA
tensors, raising on what the kernels do not take: logits other than 2-D
contiguous float32 or bfloat16, a bias other than (V,) contiguous float32,
labels other than (rows,) int64, tensors on another device. A label
outside [0, V) is not checked on the host (that would wait for the card):
the forward reads NaN as its gold logit.

The biased logit is ``round(logit + round(bias))``, rounded to the logits'
dtype at both points (:func:`biased32`), or the logit itself without a
bias; every row is computed, whatever its mask.

Counters (plain integers): ``masked_ce_fwd.launches`` and
``masked_ce_bwd.launches`` count calls of the kernels (the backward's
column sum, launched with it when there is a bias, counts with it).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Rows of a backward CTA, as csrc/masked_ce.cu has them: with a bias, each
# chunk of ROW_CHUNK rows leaves one float32 row of column sums.
ROW_CHUNK = 256
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from realise_tpu_torch.ops.kernels._build import load

        lib = load("masked_ce")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rt_masked_ce_fwd.argtypes = [p, i, p, p, ll, i, p, p, p]
        lib.rt_masked_ce_bwd.argtypes = [p, i, p, p, p, p, p, ll, i, p, p, ll,
                                         p, p]
        lib.rt_masked_ce_row_chunk.argtypes = []
        for fn in (lib.rt_masked_ce_fwd, lib.rt_masked_ce_bwd,
                   lib.rt_masked_ce_row_chunk):
            fn.restype = i
        if lib.rt_masked_ce_row_chunk() != ROW_CHUNK:
            raise RuntimeError("csrc/masked_ce.cu and ops/kernels/masked_ce.py "
                               "disagree on the backward's row chunk")
        _LIB = lib
    return _LIB


def biased32(logits: torch.Tensor,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
    """float32 view of ``logits + bias`` with the JAX VJP's rounding: the
    bias cast to the logits' dtype, added in float32, the sum rounded back
    to that dtype; the logits as they are without a bias."""
    if bias is None:
        return logits.float()
    b32 = bias.to(logits.dtype).float()
    return (logits.float() + b32).to(logits.dtype).float()


def masked_ce_fwd_plain(logits: torch.Tensor, bias: Optional[torch.Tensor],
                        labels: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logz, gold logit) of each row, float32."""
    l32 = biased32(logits, bias)
    logz = torch.logsumexp(l32, dim=-1)
    gold = l32.gather(-1, labels[:, None])[:, 0]
    return logz, gold


def masked_ce_bwd_plain(logits: torch.Tensor, bias: Optional[torch.Tensor],
                        labels: torch.Tensor, m: torch.Tensor,
                        logz: torch.Tensor, dsum: torch.Tensor
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dlogits in the logits' dtype, dbias float32 or None) of the loss
    sum Σ m·(logz - gold) scaled by ``dsum``."""
    p = torch.exp(biased32(logits, bias) - logz[:, None])
    p[torch.arange(p.shape[0], device=p.device), labels] -= 1.0
    dlogits = (p * (dsum * m)[:, None]).to(logits.dtype)
    dbias = None if bias is None else dlogits.float().sum(0)
    return dlogits, dbias


def _check(name: str, t: torch.Tensor, device: torch.device,
           dtypes, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}; the CE kernels take tensors "
                         f"on the logits' device, {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype}; the CE kernels take "
                         f"{', '.join(str(d) for d in dtypes)}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, not {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_inputs(logits, bias, labels) -> Tuple[int, int]:
    if logits.dim() != 2:
        raise ValueError(f"logits: {logits.dim()}-D; the CE kernels take "
                         f"(rows, V)")
    rows, v = logits.shape
    if v < 1:
        raise ValueError("logits: no columns")
    _check("logits", logits, logits.device, tuple(_DTYPES), (rows, v))
    if bias is not None:
        _check("bias", bias, logits.device, (torch.float32,), (v,))
    _check("labels", labels, logits.device, (torch.int64,), (rows,))
    return rows, v


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def masked_ce_fwd(logits: torch.Tensor, bias: Optional[torch.Tensor],
                  labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logz, gold logit) of each row of the (rows, V) unbiased ``logits``
    with the (V,) float32 ``bias`` folded in (None: the logits are the
    biased ones), float32 (rows,); ``labels`` (rows,) int64."""
    if not logits.is_cuda:
        return masked_ce_fwd_plain(logits, bias, labels)
    rows, v = _check_inputs(logits, bias, labels)
    logz = torch.empty(rows, dtype=torch.float32, device=logits.device)
    gold = torch.empty_like(logz)
    err = _lib().rt_masked_ce_fwd(
        logits.data_ptr(), _DTYPES[logits.dtype], _ptr(bias),
        labels.data_ptr(), rows, v, logz.data_ptr(), gold.data_ptr(),
        _stream(logits.device))
    if err != 0:
        raise RuntimeError(f"rt_masked_ce_fwd launch failed: CUDA error {err}")
    masked_ce_fwd.launches += 1
    return logz, gold


def masked_ce_bwd(logits: torch.Tensor, bias: Optional[torch.Tensor],
                  labels: torch.Tensor, m: torch.Tensor, logz: torch.Tensor,
                  dsum: torch.Tensor
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dlogits, dbias) of :func:`masked_ce_fwd`'s loss sum Σ m·(logz -
    gold) under the cotangent ``dsum`` (one float32): ``m`` the (rows,)
    float32 mask, ``logz`` the forward's. dbias is None without a bias."""
    if not logits.is_cuda:
        return masked_ce_bwd_plain(logits, bias, labels, m, logz, dsum)
    rows, v = _check_inputs(logits, bias, labels)
    dev = logits.device
    _check("mask", m, dev, (torch.float32,), (rows,))
    _check("logz", logz, dev, (torch.float32,), (rows,))
    dsum = dsum.reshape(1)
    _check("dsum", dsum, dev, (torch.float32,), (1,))
    dlogits = torch.empty_like(logits)
    partials = dbias = None
    chunks = -(-rows // ROW_CHUNK)
    if bias is not None:
        partials = torch.empty((chunks, v), dtype=torch.float32, device=dev)
        dbias = torch.empty(v, dtype=torch.float32, device=dev)
    err = _lib().rt_masked_ce_bwd(
        logits.data_ptr(), _DTYPES[logits.dtype], _ptr(bias),
        labels.data_ptr(), m.data_ptr(), logz.data_ptr(), dsum.data_ptr(),
        rows, v, dlogits.data_ptr(), _ptr(partials), chunks, _ptr(dbias),
        _stream(dev))
    if err != 0:
        raise RuntimeError(f"rt_masked_ce_bwd launch failed: CUDA error {err}")
    masked_ce_bwd.launches += 1
    return dlogits, dbias


masked_ce_fwd.launches = 0
masked_ce_bwd.launches = 0
