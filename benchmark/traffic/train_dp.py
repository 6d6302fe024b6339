"""Data-parallel fine-tuning on one host: ``train_stream``'s pipeline on
``params["data"]`` ranks, one card each, over NCCL (``--mesh data=N`` of
``cli/train``).

The harness's process is rank 0; it starts ranks 1..N-1 as processes of
this module with torchrun's variables (``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), which the port's
``parallel/distributed.initialize`` reads, and waits for every one to end.
As torchrun does, every rank gets one intra-op thread unless
``OMP_NUM_THREADS`` says otherwise, so the ranks' host ops do not each take
every core.
Each rank iterates the same global batches of ``params["batch"]`` rows and
featurizes its contiguous slice; the Trainer all-reduces the step's sums.
The ranks agree on each step over a gloo group on the host, so all run
the same steps; ``train_sent_per_s`` takes the real sentences of every
global batch started in the window over the window of the slowest rank.
Rank 0 alone runs the reference: the ranks' slices, each with its own
dropout draws and BatchNorm statistics, summed, as the all-reduce sums them.

    python3 -m benchmark.traffic.train_dp RANK PORT WORKLOAD SEED SECONDS TRACE [JSON]

(JSON: the benchmark's own tests' overrides, the same in every rank: the
device type, the configuration's and the mix's overrides, a fault.)
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from typing import Dict

RANK_TIMEOUT_S = 120
# torchrun's default for a worker when the environment sets none.
THREADS = os.environ.get("OMP_NUM_THREADS", "1")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def join_group(r, rank: int, port: int):
    """Form the NCCL group (and the host's gloo group) as rank ``rank``."""
    import torch
    import torch.distributed as dist

    from realise_tpu_torch.parallel.distributed import initialize

    world = r.params["data"]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    on_cpu = r.device is not None and r.device.type == "cpu"
    initialize(device="cpu" if on_cpu else None)
    r.rank, r.world = rank, world
    r.device = torch.device("cpu") if on_cpu else torch.device("cuda", rank)
    r.host_group = dist.new_group(backend="gloo")


def run(r) -> Dict:
    from benchmark.traffic import train_stream

    port = free_port()
    root = r.root
    extra = json.dumps({"device": r.device.type, "fault": r.fault,
                        **r.overrides})
    procs = [subprocess.Popen(
        [sys.executable, "-m", "benchmark.traffic.train_dp", str(k),
         str(port), r.name, str(r.seed), str(r.seconds), str(int(r.trace)),
         extra], cwd=root,
        env=dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS=THREADS))
        for k in range(1, r.params["data"])]
    import torch

    from realise_tpu_torch.parallel.distributed import shutdown

    threads = torch.get_num_threads()
    torch.set_num_threads(int(THREADS))
    try:
        join_group(r, 0, port)
        return train_stream.run(r)
    finally:
        torch.set_num_threads(threads)
        # NCCL's teardown waits for every rank's: rank 0 ends its groups
        # with the others, and only then waits for their processes.
        shutdown()
        for p in procs:
            try:
                p.wait(timeout=RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        bad = [p.returncode for p in procs if p.returncode]
        if bad:
            raise RuntimeError(f"a rank exited with {bad}")


def rank_main(argv) -> int:
    rank, port, name, seed, seconds, trace = argv[:6]
    from benchmark import run as bench_run

    bench_run.setup_environment()
    from benchmark.traffic import train_stream

    extra = json.loads(argv[6])
    import torch

    r = bench_run.load_run(name, int(seed), float(seconds), int(trace),
                           torch.device(extra["device"]), extra["config"],
                           extra["params"])
    r.fault = extra["fault"]
    join_group(r, int(rank), int(port))
    train_stream.run(r)
    from realise_tpu_torch.parallel.distributed import shutdown

    shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1:]))
