"""The mesh of a run: its axes parsed and checked against the process group,
and the tensor-parallel split of the weights (the port's counterpart of
``realise_tpu.parallel.mesh``).

The JAX package builds a ``jax.sharding.Mesh`` over its devices and lets
GSPMD shard by annotation. The port runs one process per card, so a mesh
here names how the ranks of the process group divide the work, and
:func:`make_mesh` refuses a mesh the group or the model cannot hold.

* ``data`` — data parallelism: each data rank trains on its contiguous
  slice of the global batch and the Trainer all-reduces the step's sums
  over the data group (``training/trainer.py``).
* ``model`` — tensor parallelism: Megatron's column and row splits of
  every encoder layer (:func:`param_shardings`, the JAX package's
  ``_TP_RULES``), run by ``parallel/tensor.py``.

``data`` comes first, as the JAX package requires of multi-process meshes
(``realise_tpu/parallel/distributed.py:143-148``), and rank ``r`` sits at
data index ``r // model`` and model index ``r % model``: the row-major
``(data, model)`` order of the JAX mesh's devices.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

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

    @property
    def model(self) -> int:
        return self.axes.get("model", 1)

    def data_index(self, rank: int) -> int:
        return rank // self.model

    def model_index(self, rank: int) -> int:
        return rank % self.model

    def __str__(self) -> str:
        return ",".join(f"{k}={v}" for k, v in self.axes.items())


def check_model_axis(model: int, cfg) -> None:
    """Raise unless ``model`` divides the attention heads and the FFN's
    intermediate units of every encoder stack (one config serves the
    semantic BERT, the pho BERT and the output block). GSPMD would pad an
    uneven split; the port does not."""
    heads, inter = cfg.num_attention_heads, cfg.intermediate_size
    if model > 1 and (heads % model or inter % model):
        raise ValueError(
            f"a model axis of {model} must divide num_attention_heads "
            f"({heads}) and intermediate_size ({inter}) of "
            f"{cfg.model_type!r}: each model rank holds whole heads and an "
            f"equal share of the FFN's units")


def make_mesh(axes: Optional[Dict[str, int]] = None,
              world_size: Optional[int] = None, cfg=None) -> Mesh:
    """A checked mesh; default every rank on ``data``. ``world_size``
    defaults to the process group's (1 without one).

    Raises unless the axes are ``data`` (first) and optionally ``model``,
    each at least 1, ``model`` divides the heads and the intermediate size
    of ``cfg`` (when given; checked before the world size), and their
    product is the world size."""
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
    mesh = Mesh(axes)
    if cfg is not None:
        check_model_axis(mesh.model, cfg)
    if mesh.size != world_size:
        raise ValueError(
            f"mesh {mesh} needs {mesh.size} processes, the process group has "
            f"{world_size}: launch with `torchrun --nproc_per_node "
            f"{mesh.size} ... --distributed`, or pass --mesh data={world_size}")
    return mesh


# The JAX package's _TP_RULES (realise_tpu/parallel/mesh.py:62-76) on the
# port's torch names, where nn.Linear.weight is (out, in): a column split of
# the JAX (in, out) kernel is a split of dim 0 here, a row split one of dim
# 1. The FFN's output pattern needs ``layer.N.`` right before ``output`` so
# that it cannot catch ``attention.output.dense``. Every other parameter is
# replicated: embeddings, LayerNorms, biases of the row-parallel products,
# the GRU, the CharResNet, the gate, ``integrate`` and every head.
_TP_RULES: Tuple[Tuple[str, int], ...] = (
    (r"(^|\.)attention\.self\.(query|key|value)\.(weight|bias)$", 0),
    (r"(^|\.)attention\.output\.dense\.weight$", 1),
    (r"(^|\.)intermediate\.dense\.(weight|bias)$", 0),
    (r"(^|\.)layer\.\d+\.output\.dense\.weight$", 1),
)


def param_shardings(named_parameters: Iterable[Tuple[str, object]],
                    mesh: Mesh) -> Dict[str, Optional[int]]:
    """{name: the dim split over the ``model`` axis, or None (replicated)}
    for every named parameter; all None unless the mesh's ``model`` axis
    is above 1 (the JAX ``param_shardings``, which shards nothing then)."""
    out = {}
    for name, _ in named_parameters:
        dim = None
        if mesh.model > 1:
            for pattern, d in _TP_RULES:
                if re.search(pattern, name):
                    dim = d
                    break
        out[name] = dim
    return out
