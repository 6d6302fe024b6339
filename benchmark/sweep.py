"""Find the serving knee once: the open-loop mix at each of several rates,
one set-up, ``--seconds`` each; prints one JSON line a rate and the highest
rate that held (every request answered, no growing backlog).

    python3 benchmark/sweep.py --workload arch3.serve.open --seed 7 \\
        --seconds 20 --rates 60,90,120,150,180,210,240
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import run  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    run.setup_environment()
    import torch

    from benchmark.traffic import serve_open

    r = run.load_run(args.workload, args.seed, args.seconds, False,
                     torch.device("cuda", 0))
    rows = serve_open.sweep(r, [float(x) for x in args.rates.split(",")],
                            args.seconds)
    held = [row["rate"] for row in rows if row["holds"]]
    print(json.dumps({"rows": rows, "knee": max(held) if held else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
