"""Step timing and profiler traces (the port's counterpart of
``realise_tpu.utils.profiler``).

* :class:`StepTimer`: host-clock timing of each step with a warm-up window
  and percentiles; ``Trainer.fit`` reports its summary as ``dispatch``.
* :func:`trace`: a ``torch.profiler`` trace of the enclosed work, written
  into a directory as a Chrome trace file (``*.pt.trace.json``) that
  Perfetto and TensorBoard's profiler plugin read; ``cli/train
  --trace_dir`` wraps its first ``--trace_steps`` steps in it.
* :class:`SpanRecorder`: the named phases of a step (the model's
  ``span`` hook, default :func:`no_span`), each timed by a CUDA event pair
  and the host clock and marked in any profiler trace.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Dict, Iterator, List, Optional

import torch


def no_span(name: str):
    """The default span hook (``Realise.span``): brackets nothing."""
    return contextlib.nullcontext()


class SpanRecorder:
    """Named spans of the program's phases: install :meth:`span` as the
    model's hook (``model.span = recorder.span``), read :meth:`totals`.

    Each span opens a ``torch.profiler.record_function`` range, so it shows
    in any profiler trace on the trace's clock, around the kernels it
    launched; notes the host clock; and, on a CUDA device, records a CUDA
    event pair on the current stream. A span's device time is the card's
    time from the first event to the second: the work the span queued, and
    for a phase that runs on the host alone the time the card stalled on
    it (about 0 where queued work hid it). Spans nest. The encoder's
    backward spans run on the autograd engine's thread: each span is one
    ``list.append``, which the interpreter lock keeps whole."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self._records: List[tuple] = []  # (name, host ns, start, end)

    @contextlib.contextmanager
    def span(self, name: str):
        start = end = None
        with torch.profiler.record_function(name):
            if self.device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter_ns()
            try:
                yield
            finally:
                host_ns = time.perf_counter_ns() - t0
                if end is not None:
                    end.record()
                self._records.append((name, host_ns, start, end))

    def totals(self) -> Dict[str, Dict[str, float]]:
        """{name: {'count', 'device_ms', 'host_ms'}} summed over the spans
        recorded so far; waits for the card once. On the CPU there is no
        ``device_ms``."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        out: Dict[str, Dict[str, float]] = {}
        for name, host_ns, start, end in list(self._records):
            t = out.setdefault(name, dict(count=0, host_ms=0.0,
                                          **({"device_ms": 0.0} if cuda
                                             else {})))
            t["count"] += 1
            t["host_ms"] += host_ns * 1e-6
            if cuda:
                t["device_ms"] += start.elapsed_time(end)
        return out


@contextlib.contextmanager
def trace(log_dir: str, device) -> Iterator[str]:
    """Trace the enclosed work: ``with trace('/tmp/trace', device): step()``.

    Records the host's activity, and the card's (CUPTI: every kernel
    launched, by its CUDA function name) when ``device`` is CUDA; the queue
    is drained before the trace stops, so the last step's kernels are in
    it. The file is written when the block ends, also when it raises. On
    CUDA there is no host-only fallback: a profiler that cannot record CUDA
    activity raises before the block runs, and a trace that holds no CUDA
    activity raises after it is written."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, supported_activities

    device = torch.device(device)
    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError(
                "torch.profiler cannot record CUDA activity in this build "
                "(no CUPTI); a trace of the host alone would miss the card")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                                 f"{time.time_ns()}.pt.trace.json")
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        prof.stop()
        prof.export_chrome_trace(path)
    if cuda and not any(e.device_type == DeviceType.CUDA
                        for e in prof.events()):
        raise RuntimeError(f"the profiler trace {path} holds no CUDA activity")


class StepTimer:
    """Host-clock timing of each step, with the first ``warmup`` steps left
    out of the summary and percentiles (the JAX package's ``StepTimer``,
    the same keys and values)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._all: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._all.append(time.perf_counter() - self._t0)
        self._t0 = None

    @property
    def times(self) -> List[float]:
        """The steps after the warm-up window, or every step when no more
        than ``warmup`` ran."""
        return self._all[self.warmup:] if len(self._all) > self.warmup else self._all

    def summary(self) -> Dict[str, float]:
        """{steps, mean_s, p50_s, p95_s, steps_per_sec, includes_warmup}
        over :attr:`times`; 0 steps and NaN times when no step ran."""
        import numpy as np

        ts = np.asarray(self.times, dtype=float)
        if ts.size == 0:
            nan = float("nan")
            return {"steps": 0, "mean_s": nan, "p50_s": nan, "p95_s": nan,
                    "steps_per_sec": 0.0, "includes_warmup": len(self._all) > 0}
        return {
            "steps": int(ts.size),
            "mean_s": float(ts.mean()),
            "p50_s": float(np.percentile(ts, 50)),
            "p95_s": float(np.percentile(ts, 95)),
            "steps_per_sec": float(1.0 / ts.mean()) if ts.mean() > 0 else 0.0,
            "includes_warmup": len(self._all) <= self.warmup,
        }
