"""A configuration brings its own port fields and its own reference: the
port's config is read whole from the file, and the class a file names under
``reference_class`` is the one that decides ``correct``."""

import json
import os

import pytest

from conftest import ROOT, SERVE_PARAMS, TRAIN_PARAMS, run_cell

from benchmark.reference import reference_class
from benchmark.traffic.train_stream import program_config

LEANING = "benchmark.tests.leaning_reference:LeaningHead"
# The fixed keys the port's config was once built from, before the file was
# read whole: for today's files both give the same config.
TUPLE_KEYS = ("vocab_size", "hidden_size", "num_hidden_layers",
              "num_attention_heads", "intermediate_size", "hidden_act",
              "hidden_dropout_prob", "attention_probs_dropout_prob",
              "max_position_embeddings", "type_vocab_size", "layer_norm_eps",
              "pho_encoder", "pho_num_layers", "res_encoder", "num_fonts",
              "use_traditional_font", "fusion", "out_num_layers",
              "zero_out_positions", "head", "max_seq_length", "pho2_max_len",
              "glyph_size", "dtype", "param_dtype")


def config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["arch3", "bert"])
def test_program_config_is_the_tuples(name):
    from realise_tpu_torch.config import config_for

    cfg = config(name)
    assert program_config(cfg) == config_for(
        cfg["preset"], **{k: cfg[k] for k in TUPLE_KEYS})


def test_a_field_the_file_sets_reaches_the_port():
    cfg = dict(config("arch3"), initializer_range=0.05,
               reference_class=LEANING)
    assert program_config(cfg).initializer_range == 0.05


def test_reference_class_is_looked_up():
    from benchmark.reference.model import Reference

    assert reference_class(config("arch3")) is Reference
    leaning = reference_class({"reference_class": LEANING})
    assert leaning.__name__ == "LeaningHead" and leaning is not Reference
    assert issubclass(leaning, Reference)
    for spec in ("os:path", "benchmark.reference.model"):
        with pytest.raises(ValueError):
            reference_class({"reference_class": spec})


@pytest.mark.parametrize("cls,correct", [(LEANING, False), (None, True)])
@pytest.mark.parametrize("workload,params,seconds", [
    ("arch3.train.b256", TRAIN_PARAMS, "1"),
    ("arch3.serve.open", SERVE_PARAMS, "2")])
def test_reference_class_decides_correct(capsys, one_thread, workload, params,
                                         seconds, cls, correct):
    extra = {} if cls is None else {"reference_class": cls}
    rc, res = run_cell(capsys, workload, params, seconds=seconds, **extra)
    assert rc == 0 and res["correct"] is correct, res["checks"]
    assert res["failed"] == 0
