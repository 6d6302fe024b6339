"""Read the numbers that decide ``correct``, to set their limits: the
program's over many seeds, the control's (the reference computed in fp8 in
the program's place) and a planted fault's over a few. One process, one
JSON line a seed; the limits are then set from these readings by hand, in
the workload file, and the readings recorded in PERF.md.

    python3 benchmark/calibrate.py --workload arch3.train.b256 \\
        --seeds 11,12,13 --control 2 [--fault half_batch] [--seconds 0]

A training cell's readings need no window (``--seconds 0``: set-up, the
three compared steps, the reference); a serving cell's a short one at its
own load.
"""

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import run  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=0,
                   help="read the control on the first N seeds")
    p.add_argument("--fault", default=None)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--params", default="{}",
                   help="JSON overrides of the traffic mix's parameters")
    args = p.parse_args(argv)
    run.setup_environment()
    import importlib

    import torch

    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        r = run.load_run(args.workload, seed, args.seconds, False,
                         torch.device("cuda", 0),
                         param_overrides=json.loads(args.params))
        runner = importlib.import_module("benchmark.traffic." + r.cell["runner"])
        r.fault, r.control = args.fault, k < args.control
        t = time.perf_counter()
        out = runner.run(r)
        print(json.dumps({
            "seed": seed, "fault": args.fault, "correct": out["correct"],
            "numbers": out["numbers"], "control": out.get("control"),
            "seconds": time.perf_counter() - t}), flush=True)
        del out, r
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
