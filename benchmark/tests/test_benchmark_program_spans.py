"""The readers of the program's own step spans (``input``, ``prep`` and
``upload``, the encoder's backward spans) on observations of a traced
training run's shape, with and without those spans: a program that
records none of them, as one before these spans, reads nothing."""

import pytest

from conftest import ROOT  # noqa: F401 (puts the checkout on sys.path)

from benchmark import run

SPANS = {"input": 0.25, "prep": 3.0, "upload": 1.5,
         "encoder.attn_bwd": 20.0, "encoder.ffn_bwd": 12.0,
         "backward": 40.0, "clip+adamw": 2.0, "glyph": 1.0, "gru": 0.5}
OLD_SPANS = {"backward": 40.0, "clip+adamw": 2.0, "glyph": 1.0, "gru": 0.5}


def observation(span_ms, steps=2):
    return {"train": True, "steps": steps, "span_ms": dict(span_ms),
            "window_s": 1.0}


def read(name, obs):
    return run.read_per_layer({"name": name}, obs)


@pytest.mark.parametrize("name,want", [
    ("train.input_stall_ms", 0.25),
    ("train.step_prep_ms", 4.5),
    ("train.encoder_bwd_ms", 32.0),
])
def test_reader_sums_its_spans(name, want):
    assert read(name, observation(SPANS)) == pytest.approx(want)


@pytest.mark.parametrize("name", ["train.input_stall_ms",
                                  "train.step_prep_ms",
                                  "train.encoder_bwd_ms"])
@pytest.mark.parametrize("obs", [
    observation(OLD_SPANS),  # a program without these spans
    observation(SPANS, steps=0),  # a window without a step
    {"serve": True, "requests": 3},  # a serving run
], ids=["no_spans", "no_steps", "serving"])
def test_reader_reads_nothing_without_its_spans(name, obs):
    assert read(name, obs) is None


@pytest.mark.parametrize("name,span,want", [
    ("train.step_prep_ms", "upload", 3.0),
    ("train.step_prep_ms", "prep", 1.5),
    ("train.encoder_bwd_ms", "encoder.ffn_bwd", 20.0),
    ("train.encoder_bwd_ms", "encoder.attn_bwd", 12.0),
])
def test_reader_of_two_spans_reads_the_one_recorded(name, span, want):
    obs = observation({k: v for k, v in SPANS.items() if k != span})
    assert read(name, obs) == pytest.approx(want)
