"""The reader of ``train.head_ce_ms`` on observations of a traced training
run's shape: the ``head+ce`` span's CUDA-event ms a step, and nothing where
a run has no such span, no step, or is a serving run."""

import pytest

from conftest import ROOT  # noqa: F401 (puts the checkout on sys.path)

from benchmark import run

NAME = "train.head_ce_ms"
SPANS = {"semantic": 20.0, "fusion+output": 1.0, "head+ce": 7.5,
         "head+ce.bwd": 0.6, "backward": 40.0, "clip+adamw": 2.0}


def observation(span_ms, steps=2):
    return {"train": True, "steps": steps, "span_ms": dict(span_ms),
            "window_s": 1.0}


def read(obs):
    return run.read_per_layer({"name": NAME}, obs)


def test_reader_reads_the_head_and_loss_forward_alone():
    assert read(observation(SPANS)) == pytest.approx(7.5)


@pytest.mark.parametrize("obs", [
    observation({k: v for k, v in SPANS.items() if k != "head+ce"}),
    observation(SPANS, steps=0),
    {"serve": True, "requests": 3},
], ids=["no_span", "no_steps", "serving"])
def test_reader_reads_nothing_without_its_span(obs):
    assert read(obs) is None


def test_metric_is_listed_for_both_training_cells():
    import json
    import os

    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    entry = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert entry == [{"name": NAME, "unit": "ms", "better": "lower",
                      "source": "program_span", "layer": "model step",
                      "moves": "train_sent_per_s",
                      "workloads": ["arch3.train.b256", "bert.train.b256"]}]
