"""The port's checkpoint format: ``saved_ckpt-{step}/`` with ``config.json``
(the RealiseConfig, the same JSON the JAX package writes) and ``model.pt``
(the model's state dict, loaded with ``weights_only=True``).

Orbax is JAX-only, so reading a JAX checkpoint directory takes the JAX
package's ``load_checkpoint``, then ``models.convert.state_dict_from_jax``,
then :func:`save_checkpoint` here. Optimizer state, ``retain_top_k`` and
``training_args.json`` belong to the training slice and are not ported yet.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Mapping, Tuple

import torch

from realise_tpu_torch.config import RealiseConfig

CKPT_PREFIX = "saved_ckpt-"
MODEL_FILE = "model.pt"


def save_checkpoint(directory: str, step: int,
                    state_dict: Mapping[str, torch.Tensor],
                    cfg: RealiseConfig) -> str:
    """Write ``{directory}/saved_ckpt-{step}``; returns the checkpoint dir."""
    ckpt_dir = os.path.join(os.path.abspath(directory), f"{CKPT_PREFIX}{step}")
    os.makedirs(ckpt_dir, exist_ok=True)
    cfg.save(ckpt_dir)
    tmp = os.path.join(ckpt_dir, MODEL_FILE + ".tmp")
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
    os.replace(tmp, os.path.join(ckpt_dir, MODEL_FILE))
    return ckpt_dir


def load_checkpoint(ckpt_dir: str, map_location="cpu") -> Dict[str, torch.Tensor]:
    """The state dict of a checkpoint dir."""
    return torch.load(os.path.join(ckpt_dir, MODEL_FILE),
                      map_location=map_location, weights_only=True)


def load_config(ckpt_dir: str) -> RealiseConfig:
    return RealiseConfig.load(ckpt_dir)


def list_checkpoints(directory: str) -> List[Tuple[int, str]]:
    """[(step, path)] of saved_ckpt-* dirs, sorted by step."""
    out = []
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        m = re.fullmatch(re.escape(CKPT_PREFIX) + r"(\d+)", name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)
