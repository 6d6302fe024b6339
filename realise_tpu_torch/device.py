"""Device selection shared by the port's entry points.

An entry point runs on CUDA unless its caller names another device; with no
CUDA device and no explicit choice it raises instead of carrying on on the
CPU. In a process group on CUDA (one process per card, torchrun) "CUDA" is
the rank's own card, ``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.distributed as dist

from realise_tpu_torch.parallel.distributed import local_rank


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → ``cuda`` (raises without a CUDA device); else ``device``.
    ``cuda`` without an index is ``cuda:LOCAL_RANK`` when a process group is
    formed, so no rank falls back to ``cuda:0``.

    On CUDA it also pins float32 to full precision: matmuls default to
    non-TF32 already, but cuDNN convolutions (the glyph-table build) default
    to TF32, which keeps about three decimal digits.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None and dist.is_initialized():
            dev = torch.device("cuda", local_rank())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
