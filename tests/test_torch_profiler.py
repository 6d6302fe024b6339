"""The port's ``utils/profiler`` against the JAX package's: ``StepTimer``'s
summary on the same recorded times, and ``trace`` on the CPU."""

import glob
import json
import math

import pytest
import torch

from realise_tpu.utils.profiler import StepTimer as JaxStepTimer
from realise_tpu_torch.utils.profiler import StepTimer, trace


@pytest.mark.parametrize("times", [[], [0.25], [0.25, 0.5],
                                   [0.3, 0.1, 0.2, 0.5, 0.4, 0.05, 0.9]])
@pytest.mark.parametrize("warmup", [0, 2])
def test_step_timer_summary_matches_jax(times, warmup):
    """The same keys and values (equal floats: the same numpy reductions
    over the same list), NaN times and 0 steps when no step ran."""
    ours, theirs = StepTimer(warmup=warmup), JaxStepTimer(warmup=warmup)
    ours._all, theirs._all = list(times), list(times)
    got, want = ours.summary(), theirs.summary()
    assert set(got) == set(want) == {"steps", "mean_s", "p50_s", "p95_s",
                                     "steps_per_sec", "includes_warmup"}
    for k, v in want.items():
        assert (math.isnan(got[k]) and math.isnan(v)) or got[k] == v, k
    assert ours.times == theirs.times


def test_step_timer_times_each_step():
    timer = StepTimer(warmup=1)
    for _ in range(3):
        with timer:
            torch.ones(4).sum()
    s = timer.summary()
    assert s["steps"] == 2 and not s["includes_warmup"] and s["p95_s"] > 0


def test_trace_writes_a_chrome_trace_of_the_cpu(tmp_path):
    x = torch.randn(16, 16)
    with trace(str(tmp_path / "t"), "cpu") as log_dir:
        torch.mm(x, x)
    assert log_dir == str(tmp_path / "t")
    (path,) = glob.glob(str(tmp_path / "t" / "*.pt.trace.json"))
    with open(path) as f:
        assert "aten::mm" in {e.get("name") for e in json.load(f)["traceEvents"]}


def test_trace_on_cuda_needs_the_profilers_cuda_activity(tmp_path, monkeypatch):
    """No host-only fallback: without CUPTI a CUDA trace raises before the
    traced work runs."""
    import torch.profiler

    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {torch.profiler.ProfilerActivity.CPU})
    ran = []
    with pytest.raises(RuntimeError, match="CUDA activity"):
        with trace(str(tmp_path / "t"), "cuda"):
            ran.append(1)
    assert ran == [] and glob.glob(str(tmp_path / "t" / "*")) == []
