"""The mesh of a run: its axes parsed and checked against the process group
(the port's counterpart of ``realise_tpu.parallel.mesh``).

The JAX package builds a ``jax.sharding.Mesh`` over its devices and lets
GSPMD shard by annotation. The port runs one process per card, so a mesh
here shards nothing: it names how the ranks of the process group divide
the work, and :func:`make_mesh` refuses a mesh the group cannot hold.

* ``data`` — data parallelism: each rank trains on its contiguous slice of
  the global batch and the Trainer all-reduces the step's sums
  (``training/trainer.py``).
* ``model`` — tensor parallelism, only at size 1. The JAX package's
  ``param_shardings`` and ``_TP_RULES`` (Megatron column and row splits of
  q/k/v, Wo, W1 and W2) come with it in ROADMAP queue A item 6b.

``data`` comes first, as the JAX package requires of multi-process meshes
(``realise_tpu/parallel/distributed.py:143-148``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from realise_tpu_torch.parallel.distributed import process_count

AXES = ("data", "model")


@dataclass(frozen=True)
class Mesh:
    """The axis sizes of a run, in order (``data`` first)."""
    axes: Dict[str, int]

    @property
    def size(self) -> int:
        n = 1
        for v in self.axes.values():
            n *= v
        return n

    @property
    def data(self) -> int:
        return self.axes.get("data", 1)

    def __str__(self) -> str:
        return ",".join(f"{k}={v}" for k, v in self.axes.items())


def make_mesh(axes: Optional[Dict[str, int]] = None,
              world_size: Optional[int] = None) -> Mesh:
    """A checked mesh; default every rank on ``data``. ``world_size``
    defaults to the process group's (1 without one).

    Raises unless the axes are ``data`` (first) and optionally ``model``,
    each at least 1, ``model`` at most 1 (item 6b), and their product is
    the world size."""
    if world_size is None:
        world_size = process_count()
    if axes is None:
        axes = {"data": world_size}
    axes = dict(axes)
    unknown = [k for k in axes if k not in AXES]
    if unknown:
        raise ValueError(f"mesh axes {unknown} unknown: the axes are "
                         f"{list(AXES)}")
    if "data" not in axes or next(iter(axes)) != "data":
        raise ValueError(f"mesh {axes}: the data axis must come first "
                         f"(e.g. data={world_size})")
    bad = {k: v for k, v in axes.items() if int(v) < 1}
    if bad:
        raise ValueError(f"mesh axes must be at least 1, got {bad}")
    if axes.get("model", 1) > 1:
        raise ValueError(
            f"mesh {axes}: a model axis larger than 1 is tensor parallelism, "
            f"not ported yet (ROADMAP queue A item 6b); use data={world_size}")
    mesh = Mesh(axes)
    if mesh.size != world_size:
        raise ValueError(
            f"mesh {mesh} needs {mesh.size} processes, the process group has "
            f"{world_size}: launch with `torchrun --nproc_per_node "
            f"{mesh.size} ... --distributed`, or pass --mesh data={world_size}")
    return mesh
