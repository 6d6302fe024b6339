"""Device selection shared by the port's entry points.

An entry point runs on CUDA unless its caller names another device; with no
CUDA device and no explicit choice it raises instead of carrying on on the
CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → ``cuda`` (raises without a CUDA device); else ``device``.

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
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
