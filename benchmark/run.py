"""Run one cell of the benchmark once and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``: its configuration's
file holds the model, its traffic mix ``benchmark/traffic/<traffic>.json``
names the traffic runner (``benchmark/traffic/<runner>.py``) and holds its
parameters, and ``benchmark/workloads/<cell>.json`` the limits of the numbers
that decide ``correct``. With ``--trace 0`` the result's metrics are
the cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, each
read by ``benchmark/metrics/<metric>.py``. The numbers that decide
``correct`` go to standard error as its last lines and into the result under
``checks``. Without a CUDA card (or with fewer than the cell asks for) the
run prints no result and exits with 2; if the process loaded JAX or the JAX
package, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# Build and kernel caches at fixed paths inside the checkout: only a cell's
# first run there builds (the port's nvcc and g++ libraries go to
# build/realise_tpu_torch/ on their own).
CACHE_DIRS = {"TRITON_CACHE_DIR": "build/triton",
              "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "CUDA_CACHE_PATH": "build/cuda_cache"}


class Run:
    """What a traffic runner is given."""

    def __init__(self, name, seed, seconds, trace, entry, cell, cfg, device,
                 chips):
        self.name, self.seed, self.seconds, self.trace = name, seed, seconds, trace
        self.entry, self.cell, self.cfg = entry, cell, cfg
        self.params = cell["params"]  # the traffic mix's
        self.device, self.chips = device, chips
        self.root, self.bench_dir, self.t_start = ROOT, BENCH_DIR, T_START
        # A fault planted under the timed path, for the benchmark's own
        # tests and calibration only: "half_batch", "unchanged_state",
        # "no_exchange" and "dropped_rank" (data parallel), "altered_token"
        # (serving).
        self.fault = None
        # Calibration: also read the control (the reference in fp8 in the
        # program's place) against the reference.
        self.control = False
        # Data parallelism: this process's rank, the ranks, and a gloo
        # group over them for the host's own agreements.
        self.rank, self.world, self.host_group = 0, 1, None


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(*parts):
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return json.load(f)


def cell_metrics(bench, section, name):
    return [m for m in bench[section]
            if name in m.get("workloads", [name])]


def read_per_layer(metric, obs):
    path = os.path.join(BENCH_DIR, "metrics", metric["name"] + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric["name"].replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(obs)


def setup_environment():
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = os.path.join(ROOT, rel)
    os.environ["USE_FLAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def load_run(workload, seed, seconds, trace, device=None,
             config_overrides=None, param_overrides=None):
    """The Run of one cell from BENCHMARK.json and the cell's files; None
    when there is no such cell. A cell kept out of BENCHMARK.json runs from
    its file's ``left_out`` entry and metrics (the benchmark's own tests and
    calibration)."""
    bench = load_json(ROOT, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    path = os.path.join(BENCH_DIR, "workloads", workload + ".json")
    if not os.path.isfile(path):
        return None
    cell = load_json(path)
    if entry is None:
        # A cell kept out of BENCHMARK.json carries its entry and metrics.
        if "left_out" not in cell:
            return None
        entry = cell["left_out"]["entry"]
        for section in ("end_to_end", "per_layer"):
            bench[section] = bench[section] + cell["left_out"][section]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = dict(load_json(ROOT, cfg_entry["file"]), **(config_overrides or {}))
    mix = load_json(BENCH_DIR, "traffic", entry["traffic"] + ".json")
    cell["runner"] = mix["runner"]
    cell["params"] = dict(mix["params"], **(param_overrides or {}))
    r = Run(workload, seed, seconds, bool(trace), entry, cell, cfg, device,
            entry["chips"])
    r.bench = bench
    r.overrides = {"config": config_overrides or {},
                   "params": param_overrides or {}}
    return r


def main(argv=None, device=None, config_overrides=None, param_overrides=None,
         fault=None):
    """``device``, ``config_overrides``, ``param_overrides`` and ``fault``
    are for the benchmark's own tests: a CPU device skips the look for a
    card."""
    args = parse(argv)
    setup_environment()
    from benchmark.harness import forbidden_loaded, log

    r = load_run(args.workload, args.seed, args.seconds, args.trace, device,
                 config_overrides, param_overrides)
    if r is None:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    import torch

    if r.device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < r.chips):
            log(f"{args.workload} needs {r.chips} CUDA card(s); "
                f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
                f"device_count() {torch.cuda.device_count()}")
            return 2
        r.device = torch.device("cuda", 0)
    r.fault = fault
    runner = importlib.import_module("benchmark.traffic." + r.cell["runner"])
    out = runner.run(r)

    bad = forbidden_loaded()
    if bad:
        log(f"the process loaded {bad}: the benchmark measures the port alone")
        return 3
    bench, device = r.bench, r.device
    metrics = {}
    if args.trace:
        for m in cell_metrics(bench, "per_layer", args.workload):
            value = read_per_layer(m, out["observations"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, "end_to_end", args.workload):
            metrics[m["name"]] = {"value": out["end_to_end"][m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": out["kind"], "count": r.chips,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if args.trace:
        summary = out["trace"]
        dev["busy_s"], dev["window_s"] = summary.busy_s, summary.window_s
        result["breakdown"] = summary.breakdown()
    result["checks"] = out["checks"]
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
