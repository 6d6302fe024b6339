"""Phases 15d and 16e of chip_smoke.py alone: torchrun of ``cli/train
--distributed --mesh data=N --length_buckets 32,64,128`` at 64 rows a card
over N = 1, 2 and 4 cards of one host (up to the count), each rank's loss
trace, step time and all-reduce time, and the sentences/s at each N (15d);
then, with two or more cards, of ``--mesh data=N/2,model=2`` (tensor
parallelism, 4 steps) at 64 rows a data rank for N = 2 and 4: each run's
loss trace, step time, the model group's reduces' CUDA-event ms and its
sentences/s beside the data-only run on the same cards (16e). NCCL's
transport lines of each run are printed.

    python3 tools/dp_scaling.py     # from the repository root, 2+ cards
"""
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from realise_tpu_torch.config import config_for  # noqa: E402
from realise_tpu_torch.ops.kernels._build import build  # noqa: E402

card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True, check=True).stdout.strip().splitlines()
print(sys.version, torch.__version__, torch.version.cuda,
      torch.cuda.device_count(), card, flush=True)
t = time.perf_counter()
build(["bert_block", "bert_block_train"])
cs.log(f"build {time.perf_counter() - t:.1f} s")
count = torch.cuda.device_count()
os.environ.update(NCCL_DEBUG="INFO", NCCL_DEBUG_SUBSYS="INIT,GRAPH")
run = cs.run_processes


def run_processes(cmds, label, **kw):
    outs = run(cmds, label, **kw)
    for out in outs:
        lines = [ln for ln in out.splitlines() if "via" in ln or "NCCL version" in ln
                 or "Connected all" in ln]
        print("\n".join(lines[:12]), flush=True)
    return outs


cs.run_processes = run_processes
with tempfile.TemporaryDirectory() as root:
    flags = cs.dp_corpus(root, 4096, 64)
    t = time.perf_counter()
    rates = cs.dp_scaling(card[0], root, flags,
                          cs.encoder_layers(config_for(cs.ARCH3)),
                          [n for n in (1, 2, 4) if n <= count])
    cs.log(f"phase 15d {time.perf_counter() - t:.1f} s")
    if count >= 2:
        t = time.perf_counter()
        cs.tp_scaling(card[0], root, flags,
                      [n for n in (2, 4) if n <= count], rates)
        cs.log(f"phase 16e {time.perf_counter() - t:.1f} s")
