"""The port's checkpoint format and its retention (the port of
``realise_tpu.training.checkpoint``).

A checkpoint directory ``saved_ckpt-{step}/`` holds:

* ``config.json`` — the RealiseConfig (the same JSON the JAX package writes);
* ``model.pt`` — the model's state dict, loaded with ``weights_only=True``;
* ``trainer.pt`` (training checkpoints) — the optimizer's ``state_dict()``,
  the step and the dropout generator's state (``Trainer.state_dict``): what
  ``--resume`` needs to continue the run it came from;
* ``training_args.json`` (training checkpoints) — the run's arguments.

``Corrector`` and ``cli/test`` read ``config.json`` and ``model.pt`` only, so
a checkpoint with or without the trainer's files serves and scores alike.
A pretraining stage's checkpoint has the same files: :func:`load_config`
and ``models.realise.build_model`` give back its ``RealisePretrain``.
The whole directory is written as ``saved_ckpt-{step}.tmp/`` and then
renamed into place, so a crash mid-save leaves no ``saved_ckpt-{step}``
without its ``trainer.pt``: ``--resume`` then continues from the last
complete checkpoint (:func:`list_checkpoints` ignores the ``.tmp`` name).

Orbax is JAX-only, so reading a JAX checkpoint directory takes the JAX
package's ``load_checkpoint``, then ``models.convert.state_dict_from_jax``,
then :func:`save_checkpoint` here.

The "score every checkpoint, keep the top k" workflow (run.py:473-505,
train.sh:17-19) is :func:`retain_top_k`.

In a process group (data parallelism: every rank holds the same weights
and optimizer state) only rank 0 writes a checkpoint, and every rank waits
at a barrier after the write, so a rank that loads it next finds it
complete (``realise_tpu/training/checkpoint.py:47-80``). Every rank loads.
Under tensor parallelism the caller passes the full, unsplit tensors
(``Trainer.model_state_dict`` and ``Trainer.state_dict`` gather them over
the model group, every rank of it taking part, before rank 0 writes), so a
checkpoint is the same whatever mesh wrote it; a split model slices what
it loads (``parallel/tensor.shard_module``).
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.parallel.distributed import barrier, is_main_process

CKPT_PREFIX = "saved_ckpt-"
MODEL_FILE = "model.pt"
TRAINER_FILE = "trainer.pt"
ARGS_FILE = "training_args.json"


def save_checkpoint(directory: str, step: int,
                    model_state: Mapping[str, torch.Tensor],
                    cfg: RealiseConfig,
                    trainer_state: Optional[Mapping[str, Any]] = None,
                    training_args: Optional[Mapping[str, Any]] = None) -> str:
    """Write ``{directory}/saved_ckpt-{step}``; returns the checkpoint dir.
    ``trainer_state`` (``Trainer.state_dict()``) goes to ``trainer.pt``,
    ``training_args`` (``vars(args)``) to ``training_args.json``.

    Every file goes into ``saved_ckpt-{step}.tmp/``, which is renamed to
    ``saved_ckpt-{step}`` once all are written. A checkpoint of the same
    step already there (the final save after a ``--save_steps`` one) is
    renamed aside first and deleted after. In a process group only rank 0
    writes; every rank returns after the barrier that follows the write."""
    ckpt_dir = os.path.join(os.path.abspath(directory), f"{CKPT_PREFIX}{step}")
    if is_main_process():
        _write_checkpoint(ckpt_dir, model_state, cfg, trainer_state,
                          training_args)
    barrier()
    return ckpt_dir


def _write_checkpoint(ckpt_dir, model_state, cfg, trainer_state,
                      training_args) -> None:
    tmp_dir, old_dir = ckpt_dir + ".tmp", ckpt_dir + ".old"
    shutil.rmtree(tmp_dir, ignore_errors=True)
    os.makedirs(tmp_dir)
    with open(os.path.join(tmp_dir, "config.json"), "w", encoding="utf-8") as f:
        f.write(cfg.to_json())
    torch.save({k: v.detach().cpu() for k, v in model_state.items()},
               os.path.join(tmp_dir, MODEL_FILE))
    if trainer_state is not None:
        torch.save(trainer_state, os.path.join(tmp_dir, TRAINER_FILE))
    if training_args is not None:
        with open(os.path.join(tmp_dir, ARGS_FILE), "w", encoding="utf-8") as f:
            json.dump(training_args, f, indent=2, sort_keys=True, default=str)
    if os.path.exists(ckpt_dir):
        shutil.rmtree(old_dir, ignore_errors=True)
        os.replace(ckpt_dir, old_dir)
    os.replace(tmp_dir, ckpt_dir)
    shutil.rmtree(old_dir, ignore_errors=True)


def load_checkpoint(ckpt_dir: str, map_location="cpu") -> Dict[str, torch.Tensor]:
    """The state dict of a checkpoint dir."""
    return torch.load(os.path.join(ckpt_dir, MODEL_FILE),
                      map_location=map_location, weights_only=True)


def load_trainer_state(ckpt_dir: str) -> Dict[str, Any]:
    """The ``Trainer.state_dict()`` saved with a checkpoint; raises naming
    the file when the checkpoint has none (a serving checkpoint, or one
    written before optimizer state was saved)."""
    path = os.path.join(ckpt_dir, TRAINER_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{path} not found: {ckpt_dir} holds no optimizer state to "
            f"resume from")
    return torch.load(path, map_location="cpu", weights_only=True)


def load_config(ckpt_dir: str) -> RealiseConfig:
    return RealiseConfig.load(ckpt_dir)


def load_training_args(ckpt_dir: str) -> Dict[str, Any]:
    with open(os.path.join(ckpt_dir, ARGS_FILE), encoding="utf-8") as f:
        return json.load(f)


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


def retain_top_k(scored: List[Tuple[str, float]], k: int, reverse: bool = True,
                 delete: bool = True) -> List[str]:
    """Keep the k best checkpoint dirs by score; optionally delete the rest
    (run.py:473-505). Returns the kept dirs, best first. NaN scores (a
    diverged checkpoint's dev metric) rank worst, so a NaN never displaces
    a good checkpoint. Ties keep their input order (a stable sort)."""

    def key(t):
        s = t[1]
        if isinstance(s, float) and math.isnan(s):
            return float("-inf") if reverse else float("inf")
        return s

    ranked = sorted(scored, key=key, reverse=reverse)
    keep = [d for d, _ in ranked[:k]]
    if delete:
        for d, _ in ranked[k:]:
            shutil.rmtree(d, ignore_errors=True)
    return keep
