"""CUDA-event milliseconds per step of the Trainer's ``all-reduce`` span
(the fixed-order buckets of the step's sums over NCCL), on the slowest
rank of the traced data-parallel window."""


def read(obs):
    if not obs.get("dp") or obs.get("allreduce_ms") is None:
        return None
    return obs["allreduce_ms"]
