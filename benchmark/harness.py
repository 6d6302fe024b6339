"""What every traffic runner shares: the profiler trace and its reduction,
the card's identity and the checks on what the process loaded. (The
program's spans are recorded by its own ``utils/profiler.SpanRecorder``.)

Trace: ``Trace`` profiles the host and the card (``torch.profiler``) over
one window, writes the Chrome trace to a temporary file and reduces it:
device time by kernel name, the union of device activity inside the window
(busy seconds), and the longest idle gaps labelled by the host operation
that ran at their middle.
"""

from __future__ import annotations

import contextlib
import gc
import glob
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "orbax", "realise_tpu",
                     "chip_smoke")
WINDOW_MARK = "bench.window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def settle() -> None:
    """End of set-up: collect, then move every object alive now (the
    benchmark's inputs, schedules and records among them) out of the
    collector's reach, so that the collections the window runs scan what
    the window allocates and not the benchmark's own data."""
    gc.collect()
    gc.freeze()


def forbidden_loaded() -> List[str]:
    """The forbidden top-level modules in ``sys.modules``, compared whole
    (``realise_tpu_torch`` is not ``realise_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def card_kind(device) -> str:
    """The card's name, and nvidia-smi's power limit and clocks on standard
    error (the published peaks hold at the full 700 W)."""
    import torch

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"not read: {e}"
    log(f"nvidia-smi (index, name, power limit, SM clock, max SM clock, "
        f"temperature): {out}")
    return torch.cuda.get_device_name(device)


def kernel_groups(bench_dir: str) -> Dict[str, List[str]]:
    """{group: [CUDA function names]} from ``kernels/<group>/<kernel>.json``."""
    groups: Dict[str, List[str]] = {}
    for path in sorted(glob.glob(os.path.join(bench_dir, "kernels", "*",
                                              "*.json"))):
        with open(path) as f:
            spec = json.load(f)
        group = os.path.basename(os.path.dirname(path))
        groups.setdefault(group, []).extend(spec["functions"])
    return groups


def function_name(kernel: str) -> str:
    """The bare function name of a demangled kernel name
    ("void (anonymous namespace)::gemm_sm90<6, true>(CUtensorMap_st, ...)"
    -> "gemm_sm90")."""
    name = kernel.replace("(anonymous namespace)::", "")
    cut = min([i for i in (name.find("<"), name.find("(")) if i >= 0],
              default=len(name))
    head = name[:cut].split()
    return head[-1].rsplit("::", 1)[-1] if head else name


def short_name(kernel: str, limit: int = 160) -> str:
    """A kernel's name without its parameter list, at most ``limit`` chars."""
    name = kernel.replace("(anonymous namespace)::", "")
    depth = 0
    for i, c in enumerate(name):
        depth += (c == "<") - (c == ">")
        if c == "(" and depth == 0 and i > 0 and name[i - 1] != " ":
            name = name[:i]
            break
    return name[:limit]


def _union(intervals: np.ndarray) -> np.ndarray:
    """Disjoint sorted [start, end) rows covering the given rows."""
    if not len(intervals):
        return intervals
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


class TraceSummary:
    def __init__(self, window_s: float, busy_s: float,
                 kernel_s: Dict[str, float], idle_gaps: List[Tuple[str, float]]):
        self.window_s = window_s
        self.busy_s = busy_s
        self.kernel_s = kernel_s  # device seconds by kernel name
        self.idle_gaps = idle_gaps

    def group_seconds(self, functions: List[str]) -> float:
        wanted = set(functions)
        return sum(s for name, s in self.kernel_s.items()
                   if function_name(name) in wanted)

    def breakdown(self) -> Dict:
        by_name: Dict[str, float] = {}
        for name, sec in self.kernel_s.items():
            key = short_name(name)
            by_name[key] = by_name.get(key, 0.0) + sec
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps[:10]]}


def reduce_trace(path: str, labelled_gaps: int = 400) -> TraceSummary:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window = None
    dev, host, host_names = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATEGORIES:
            dev.append((ts, ts + dur, e.get("name", "")))
        elif cat in HOST_CATEGORIES:
            if e.get("name") == WINDOW_MARK and cat == "user_annotation":
                window = (ts, ts + dur)
                continue
            host.append((ts, ts + dur))
            host_names.append(e.get("name", ""))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_MARK!r} range")
    if not dev:
        raise RuntimeError("the trace holds no device activity")
    w0, w1 = window
    kernel_s: Dict[str, float] = {}
    rows = []
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            kernel_s[name] = kernel_s.get(name, 0.0) + (e - s) * 1e-6
            rows.append((s, e))
    busy = _union(np.asarray(rows, dtype=np.float64).reshape(-1, 2))
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) * 1e-6 if len(busy) else 0.0
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    order = np.argsort(gaps[:, 0] - gaps[:, 1])[:labelled_gaps]
    h = np.asarray(host, dtype=np.float64).reshape(-1, 2)
    spans = h[:, 1] - h[:, 0]
    labels: Dict[str, float] = {}
    for g in gaps[order]:
        mid = 0.5 * (g[0] + g[1])
        inside = np.nonzero((h[:, 0] <= mid) & (h[:, 1] >= mid))[0]
        label = ("no host op" if not len(inside)
                 else host_names[inside[np.argmin(spans[inside])]])
        labels[label] = labels.get(label, 0.0) + (g[1] - g[0]) * 1e-6
    idle = sorted(labels.items(), key=lambda kv: -kv[1])
    return TraceSummary((w1 - w0) * 1e-6, busy_s, kernel_s, idle)


class Trace:
    """Profile the host and the card inside ``with``; the body's work runs
    inside a ``bench.window`` range that ends after a device sync.
    ``summary`` holds the reduction afterwards."""

    def __init__(self, device):
        self.device = device
        self.summary: Optional[TraceSummary] = None

    @contextlib.contextmanager
    def window(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize(self.device)
        with tempfile.TemporaryDirectory() as tmp:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function(WINDOW_MARK):
                    yield
                    torch.cuda.synchronize(self.device)
            t = time.perf_counter()
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            size = os.path.getsize(path)
            self.summary = reduce_trace(path)
            log(f"trace: {size / 2 ** 20:.1f} MiB, reduced in "
                f"{time.perf_counter() - t:.1f} s")
