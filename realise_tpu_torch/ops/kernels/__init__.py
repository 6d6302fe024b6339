"""Hand-written Hopper kernels of the port.

* :mod:`bert_block` — the forward attention and FFN sub-block kernels of the
  deterministic serving path (counterparts of
  ``realise_tpu/ops/pallas/bert_block.py``), CUDA C++ in
  ``csrc/bert_block.cu``.
* :mod:`bert_block_train` — the training step's attention and FFN sub-blocks
  with dropout, forward and backward (counterparts of
  ``realise_tpu/ops/pallas/bert_block_train.py``), CUDA C++ in
  ``csrc/bert_block_train.cu``.
* :mod:`adamw` — the training step's update (division, clip, AdamW) in two
  multi-tensor launches, ``csrc/adamw.cu``; no TPU counterpart.
* :mod:`masked_ce` — the head's masked cross-entropy, forward and backward,
  ``csrc/masked_ce.cu``; no TPU counterpart (XLA fuses the JAX VJP).
* :mod:`batch_norm` — the CharResNet's training-mode BatchNorm with its
  ReLU and the block tail's add, forward and backward,
  ``csrc/batch_norm.cu``; no TPU counterpart (XLA fuses the jnp BatchNorm).

The two block sources share ``csrc/bert_block_common.cuh`` (the tensor-core
and float32 GEMMs, the attention cores, LayerNorm rows, the dropout hash).

Each kernel has a plain PyTorch version in the same module. A wrapper takes
the plain version for a CPU tensor only; for a CUDA tensor it launches its
kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

# What the attention core of csrc/bert_block.cu holds: one warp keeps a
# query row's scores in 4 registers per lane (S <= 128) and its context in
# 2 (head_dim <= 64).
ATTN_MAX_SEQ = 128
ATTN_MAX_HEAD_DIM = 64
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def kernels_unviable_reason(cfg, dtype: torch.dtype,
                            device: Optional[torch.device] = None) -> Optional[str]:
    """Why this config cannot run the fused block kernels (None = it can).

    The twin of ``realise_tpu.ops.pallas.pallas_unviable_reason``, for the
    serving and the training kernels alike. ``device``
    defaults to CUDA; on the CPU only the function checks apply, since the
    wrappers take their plain versions there."""
    if cfg.hidden_act != "gelu":
        return (f"hidden_act {cfg.hidden_act!r} is not supported by the fused "
                f"FFN kernel (it hardcodes erf-gelu)")
    if cfg.hidden_size % cfg.num_attention_heads:
        return "hidden_size must divide evenly into attention heads"
    if cfg.head_dim > ATTN_MAX_HEAD_DIM:
        return (f"head_dim {cfg.head_dim} exceeds the attention kernel's "
                f"{ATTN_MAX_HEAD_DIM}")
    if cfg.max_seq_length > ATTN_MAX_SEQ:
        return (f"max_seq_length {cfg.max_seq_length} exceeds the attention "
                f"kernel's {ATTN_MAX_SEQ}")
    if dtype not in KERNEL_DTYPES:
        return f"dtype {dtype} is not one of the kernels' {KERNEL_DTYPES}"
    device = torch.device("cuda" if device is None else device)
    if device.type == "cpu":
        return None
    if device.type != "cuda":
        return f"the kernels run on CUDA, not on {device}"
    if not torch.cuda.is_available():
        return "CUDA is not available"
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        return (f"the kernels are built for sm_90a (Hopper); this device has "
                f"compute capability {cap[0]}.{cap[1]}")
    return None
