"""Process group bootstrap, rank gating and per-rank batch slicing (the port's
own copy of ``realise_tpu.parallel.distributed`` on ``torch.distributed``).

The reference launches one process per GPU and forms an NCCL process group
(reference: src/run.py:400-404, train.sh:5). So does the port: ``torchrun
--nproc_per_node N`` starts one process per card, and :func:`initialize`
forms the group from torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``). Every rank holds the whole model
and iterates the same global batch order; each featurizes only its
contiguous :func:`local_slice` of every global batch. Slicing per batch,
not per dataset, drops no example (the reference's strided shard drops the
tail, run.py:128-137) and keeps the shuffle global.

With no process group every helper is the identity (rank 0 of 1, main
process), so one-card runs take exactly the path they took before.

The JAX module's ``_check_contiguous_rows`` and ``make_global_batch`` have
no counterpart: they assemble JAX global arrays from per-process shards,
and here each rank's batch stays its own (the Trainer all-reduces the
step's sums instead, and :func:`gather_rows` brings rows back in rank
order).
"""

from __future__ import annotations

import atexit
import logging
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

logger = logging.getLogger("realise_tpu_torch")

_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK")


def launched_by_torchrun() -> bool:
    """True when torchrun's (or a compatible launcher's) variables are set."""
    return all(k in os.environ for k in _ENV + ("MASTER_ADDR", "MASTER_PORT"))


def local_rank() -> int:
    """``LOCAL_RANK`` (the card of this process on its host); 0 without."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device: Optional[str] = None) -> bool:
    """Form the default process group; returns True when it was formed here
    (False when one already exists).

    ``coordinator_address``: ``host:port`` (a TCP store) or an
    ``init_method`` URL (``tcp://``, ``file://``); default torchrun's
    ``MASTER_ADDR``/``MASTER_PORT`` (``env://``). ``num_processes`` and
    ``process_id`` default to ``WORLD_SIZE`` and ``RANK``. ``backend``: NCCL
    for a run on CUDA, gloo when ``device`` is ``"cpu"``; a CUDA run never
    gets gloo unless the caller names it (two ranks sharing one card, which
    NCCL refuses). On CUDA the process takes card ``LOCAL_RANK`` before the
    group forms. A group that fails to form raises: no rank carries on
    alone. The group is destroyed at exit (:func:`shutdown`)."""
    if dist.is_initialized():
        return False
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if coordinator_address is None:
        if not launched_by_torchrun():
            raise RuntimeError(
                "a process group needs torchrun's environment (MASTER_ADDR, "
                "MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK): launch with "
                "`torchrun --nproc_per_node N -m realise_tpu_torch.cli.train "
                "--distributed ...`")
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a distributed run on CUDA needs a CUDA device; pass "
                "--device cpu for a gloo group on the CPU")
        index = local_rank()
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {index} but only {torch.cuda.device_count()} "
                f"CUDA device(s) on this host")
        torch.cuda.set_device(index)
    if backend is None:
        backend = "gloo" if on_cpu else "nccl"
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    atexit.register(shutdown)
    logger.info("process group formed: rank %d of %d, backend %s%s",
                dist.get_rank(), dist.get_world_size(), backend,
                "" if on_cpu else f", cuda:{torch.cuda.current_device()}")
    return True


def _env_int(name: str) -> int:
    if name not in os.environ:
        raise RuntimeError(f"{name} is not set: launch with torchrun, or "
                           f"pass it to initialize()")
    return int(os.environ[name])


def shutdown() -> None:
    """Destroy the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank-0 gating for checkpoints and result files (the reference's
    ``local_rank in [-1, 0]``, run.py:214,223,455)."""
    return process_index() == 0


def barrier() -> None:
    """Wait for every rank; nothing without a process group."""
    if dist.is_initialized():
        dist.barrier()


def pad_to_multiple(indices: Sequence, multiple: int) -> List:
    """Pad a list by repeating its last entry until every rank gets an
    equal share, instead of the reference's strided shard that drops the
    tail ``len % world_size`` examples (run.py:134-137)."""
    out = list(indices)
    if multiple > 1 and out:
        while len(out) % multiple:
            out.append(out[-1])
    return out


def local_slice(items: Sequence, index: Optional[int] = None,
                count: Optional[int] = None) -> List:
    """This rank's contiguous share of one global batch:
    ``concat(local_slice(b, p, P) for p in range(P)) == pad_to_multiple(b,
    P)``, in order, so global row ``p * share + i`` is rank ``p``'s row
    ``i`` (:func:`gather_rows` puts them back there)."""
    if count is None:
        count = process_count()
    if index is None:
        index = process_index()
    if count == 1:
        return list(items)
    padded = pad_to_multiple(list(items), count)
    share = len(padded) // count
    return padded[index * share:(index + 1) * share]


def gather_rows(rows: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``rows`` (equal shapes on every rank) stacked along dim 0
    in rank order, on every rank: the ``process_allgather(..., tiled=True)``
    of the JAX Trainer's eval (trainer.py:586-591). Taken as an all-reduce
    SUM into a zeroed buffer of the global rows, which NCCL and gloo both
    run on CUDA and CPU tensors; each row is one rank's value plus zeros, so
    integers and finite floats come back exact. ``rows`` unchanged without a
    group."""
    if group is None and not dist.is_initialized():
        return rows
    world = dist.get_world_size(group)
    if world == 1:
        return rows
    rank = dist.get_rank(group)
    n = rows.shape[0]
    out = torch.zeros((world * n,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                      device=rows.device)
    out[rank * n:(rank + 1) * n] = rows
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out
