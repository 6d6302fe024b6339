"""A tiny run of every cell through run.py on the CPU, the closed loop's
rate against the load generator's own record, the load generator against a
stub server, the per-layer readers on observations of a run's shape, and
the trace reduction on a synthetic Chrome trace."""

import json
import os
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from conftest import (CLOSED_PARAMS, DP_PARAMS, ROOT, SERVE_PARAMS,
                      TRAIN_PARAMS, run_cell, tiny_config)

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
    ("arch3.serve.closed8", CLOSED_PARAMS, "2"),
    ("arch3.train.dp4", DP_PARAMS, "1"),
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


RUNNER_KIND = {"train_stream": "train", "train_dp": "dp",
               "serve_open": "serve", "serve_closed": "serve"}


def cell_kind(b, cell):
    """train, dp or serve: what the cell's traffic runner observes."""
    entry = next(w for w in b["workloads"] if w["name"] == cell)
    with open(os.path.join(ROOT, "benchmark", "traffic",
                           entry["traffic"] + ".json")) as f:
        return RUNNER_KIND[json.load(f)["runner"]]


def test_readers(tmp_path):
    from benchmark import run

    path = str(tmp_path / "t.json")
    synthetic_trace(path)
    trace = harness.reduce_trace(path)
    with open(os.path.join(ROOT, "benchmark", "configs", "arch3.json")) as f:
        cfg = json.load(f)
    spans = {"input": 0.25, "prep": 3.0, "upload": 1.5,
             "encoder.attn_bwd": 20.0, "encoder.ffn_bwd": 12.0,
             "backward": 40.0, "clip+adamw": 2.0, "glyph": 1.0, "gru": 0.5,
             "all-reduce": 3.0}
    train = {"cfg": cfg, "trace": trace, "steps": 2, "train": True,
             "step_shapes": [(4, 8), (4, 8)], "sentence_tokens": [5, 6],
             "span_ms": spans, "window_s": 1e-3}
    serve = {"cfg": cfg, "trace": trace, "serve": True, "requests": 3,
             "sentences": 4, "device_steps": 2, "featurize_ms": 0.5,
             "step_shapes": [(1, 8)], "sentence_tokens": [5, 6, 7, 8]}
    dp = dict(train, train=False, dp=True, ranks=4, allreduce_ms=3.0)
    kinds = {"train": train, "dp": dp, "serve": serve}
    b = bench()
    read = set()
    for m in b["per_layer"]:
        found = {cell_kind(b, w) for w in m["workloads"]}
        assert len(found) == 1, m["name"]
        kind = found.pop()
        value = run.read_per_layer(m, kinds[kind])
        assert value is not None and value > 0, m["name"]
        for other, obs in kinds.items():
            if other != kind:
                assert run.read_per_layer(m, obs) is None, (m["name"], other)
        read.add((kind, m["moves"]))
    assert {("train", "train_sent_per_s"), ("dp", "train_sent_per_s"),
            ("serve", "serve_sent_per_s")} <= read
    assert run.read_per_layer({"name": "train.streams_ms"}, train) == 1.5


def test_closed_loop_rate_is_the_sentences_answered_over_the_window(
        capsys, one_thread, monkeypatch):
    """serve_sent_per_s against the load generator's own record of the
    window: the sentences of every request it saw answered with a 200."""
    import torch

    from benchmark import run
    from benchmark.traffic import serve_closed

    record = {}
    real = serve_closed.closed_loop

    def closed_loop(port, bodies, p, seconds, tmp, tag):
        res = real(port, bodies, p, seconds, tmp, tag)
        if tag == "window":
            record["bodies"], record["res"] = bodies, res
        return res

    monkeypatch.setattr(serve_closed, "closed_loop", closed_loop)
    r = run.load_run("arch3.serve.closed8", 3000000001, 2.0, 0,
                     torch.device("cpu"), tiny_config(), CLOSED_PARAMS)
    out = serve_closed.run(r)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    res = record["res"]
    answered = [row for row in res["results"] if row[1] == 200]
    assert answered and len(answered) == len(res["results"])
    sentences = sum(len(json.loads(record["bodies"][row[0]])["sentences"])
                    for row in answered)
    assert out["end_to_end"]["serve_sent_per_s"] == pytest.approx(
        sentences / res["window_s"])
    assert out["attempted"] == len(res["results"])
    # Every client waited for its answer: no more than 4 in flight at once.
    events = sorted([(row[3], 1) for row in res["results"]]
                    + [(row[3] + row[2], -1) for row in res["results"]])
    flight = peak = 0
    for _, step in events:
        flight += step
        peak = max(peak, flight)
    assert peak <= CLOSED_PARAMS["clients"]


class SlowHandler(BaseHTTPRequestHandler):
    """Answers each POST after 20 ms with the sentences it was sent."""

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        time.sleep(0.02)
        data = json.dumps({"results": json.loads(body)["sentences"]}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):
        pass


def test_loadgen_closed_loop_against_a_stub(tmp_path):
    server = ThreadingHTTPServer(("127.0.0.1", 0), SlowHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        bodies = [json.dumps({"sentences": ["a"] * (1 + i % 3)})
                  for i in range(5)]
        sched, res = tmp_path / "s.json", tmp_path / "r.json"
        sched.write_text(json.dumps({
            "port": server.server_address[1], "clients": 3, "seconds": 0.5,
            "timeout": 10.0, "requests": bodies}))
        subprocess.run([sys.executable, os.path.join(
            ROOT, "benchmark", "loadgen.py"), str(sched), str(res)],
            check=True, timeout=60)
        out = json.loads(res.read_text())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    rows = out["results"]
    # 3 clients, about 20 ms a request, 0.5 s: some tens of requests, the
    # list taken again from its start, each sent after the last one's answer.
    assert 15 <= len(rows) <= 3 * 0.5 / 0.02 + 3
    assert all(row[1] == 200 for row in rows)
    assert sorted(row[0] for row in rows) == sorted(
        k % 5 for k in range(len(rows)))
    assert all(json.loads(row[4])["results"] ==
               json.loads(bodies[row[0]])["sentences"] for row in rows)
    assert all(row[3] < 0.5 for row in rows)
    last = max(row[3] + row[2] for row in rows)
    assert last <= out["window_s"] < last + 0.05
