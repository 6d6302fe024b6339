"""A tiny run of every cell through run.py on the CPU, the per-layer
readers on observations of a run's shape, and the trace reduction on a
synthetic Chrome trace."""

import json
import os

import pytest

from conftest import ROOT, SERVE_PARAMS, TRAIN_PARAMS, run_cell

from benchmark import harness


def bench():
    """BENCHMARK.json with the metrics of the cells kept out of it."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    for name in os.listdir(os.path.join(ROOT, "benchmark", "workloads")):
        with open(os.path.join(ROOT, "benchmark", "workloads", name)) as f:
            out = json.load(f).get("left_out")
        if out:
            b["workloads"].append(out["entry"])
            for section in ("end_to_end", "per_layer"):
                b[section] += out[section]
    return b


@pytest.mark.parametrize("workload,params,seconds", [
    ("arch3.train.b256", TRAIN_PARAMS, "1"),
    ("bert.train.b256", TRAIN_PARAMS, "1"),
    ("bert.train.b32", TRAIN_PARAMS, "1"),
    ("arch3.serve.open", SERVE_PARAMS, "2"),
])
def test_cell_runs_tiny(capsys, one_thread, workload, params, seconds):
    rc, res = run_cell(capsys, workload, params, seconds=seconds)
    assert rc == 0 and res["correct"], res
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in bench()["end_to_end"]
            if workload in m.get("workloads", [workload])}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"


def test_no_result_without_a_card(capsys):
    import torch

    from benchmark import run

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "bert.train.b32", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def synthetic_trace(path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": harness.WINDOW_MARK,
           "ts": 0.0, "dur": 1000.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 100.0,
           "dur": 50.0},
          {"ph": "X", "cat": "cpu_op", "name": "train_step", "ts": 0.0,
           "dur": 600.0},
          {"ph": "X", "cat": "kernel", "name": "void gemm_sm90<0, bf16>(int)",
           "ts": 10.0, "dur": 100.0},
          {"ph": "X", "cat": "kernel", "name": "attention_fwd_core_tc",
           "ts": 50.0, "dur": 100.0},
          {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 300.0,
           "dur": 200.0}]
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


def test_trace_reduction(tmp_path):
    path = str(tmp_path / "t.json")
    synthetic_trace(path)
    s = harness.reduce_trace(path)
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(340e-6)  # [10, 150) and [300, 500)
    assert s.group_seconds(["gemm_sm90", "attention_fwd_core_tc"]) == (
        pytest.approx(200e-6))
    assert harness.function_name("void ns::gemm_sm90<1>(CUtensorMap)") == (
        "gemm_sm90")
    gaps = dict(s.idle_gaps)
    assert gaps["train_step"] == pytest.approx((10 + 150) * 1e-6)
    assert gaps["no host op"] == pytest.approx(500e-6)
    b = s.breakdown()
    assert b["device_ops"][0][0] == "elementwise"


def test_readers(tmp_path):
    from benchmark import run

    path = str(tmp_path / "t.json")
    synthetic_trace(path)
    trace = harness.reduce_trace(path)
    with open(os.path.join(ROOT, "benchmark", "configs", "arch3.json")) as f:
        cfg = json.load(f)
    train = {"cfg": cfg, "trace": trace, "steps": 2, "train": True,
             "step_shapes": [(4, 8), (4, 8)], "sentence_tokens": [5, 6],
             "span_ms": {"clip+adamw": 2.0, "glyph": 1.0, "gru": 0.5},
             "input_wait_ms": 0.25, "window_s": 1e-3}
    serve = {"cfg": cfg, "trace": trace, "serve": True, "requests": 3,
             "sentences": 4, "device_steps": 2, "featurize_ms": 0.5,
             "step_shapes": [(1, 8)], "sentence_tokens": [5, 6, 7, 8]}
    dp = dict(train, train=False, dp=True, ranks=4, allreduce_ms=3.0)
    kinds = {"train_sent_per_s": train, "train_dp_sent_per_s": dp}
    for m in bench()["per_layer"]:
        obs = kinds.get(m["moves"], serve)
        value = run.read_per_layer(m, obs)
        assert value is not None and value > 0, m["name"]
        for other in (train, serve, dp):
            if other is not obs:
                assert run.read_per_layer(m, other) is None, m["name"]
    assert run.read_per_layer({"name": "train.streams_ms"}, train) == 1.5
