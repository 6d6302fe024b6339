"""The control at a size a test run holds: the reference computed in fp8 put
in the program's place is not correct under each cell's limits (on the
card, ``calibrate.py --control`` reads it at the cells' own sizes)."""

import json
import os

import numpy as np
import pytest
import torch

from conftest import ROOT, tiny_config

from benchmark import inputs
from benchmark.reference import compare, reference_class, text


def setup(config, width=64):
    from realise_tpu_torch.models.realise import Realise

    from benchmark.traffic.train_stream import program_config

    with open(os.path.join(ROOT, "benchmark", "configs", config)) as f:
        cfg = dict(json.load(f), **tiny_config(
            hidden_size=width, intermediate_size=4 * width,
            num_attention_heads=width // 64))
    table = text.read_pinyin_table(text.pinyin_table_path(ROOT))
    vocab = text.synthetic_vocab(table, cfg["vocab_size"],
                                 cfg["assumed"]["vocab_cjk_chars"])
    cjk = text.cjk_ids(vocab, table)
    with torch.device("meta"):
        shapes = {k: (tuple(v.shape), v.dtype) for k, v in
                  Realise(program_config(cfg)).state_dict().items()}
    weights = inputs.make_weights(shapes, cjk, 123456789012, "cpu", 0.3)
    pho = text.pho2_ids(vocab, table, cfg["pho2_max_len"])
    return cfg, vocab, cjk, weights, pho


def limits(cell):
    with open(os.path.join(ROOT, "benchmark", "workloads",
                           cell + ".json")) as f:
        return json.load(f)["limits"]


@pytest.mark.parametrize("cell,config", [("arch3.train.b256", "arch3.json"),
                                         ("bert.train.b256", "bert.json"),
                                         ("bert.train.b32", "bert.json")])
def test_training_control_is_not_correct(one_thread, cell, config):
    cfg, vocab, cjk, weights, pho = setup(config, width=128)
    sent = inputs.Sentences(vocab, cjk, dict(
        shape_seed=1, length_mean=12, length_sigma=0.5, length_min=4,
        length_max=30, zipf_exponent=1.0))
    pool = inputs.training_pool(sent, 5, 12, 0.05, vocab.index("[CLS]"),
                                vocab.index("[SEP]"))
    batches = [[inputs.pad_rows(pool[i * 4:(i + 1) * 4], 32, 4, "cpu")]
               for i in range(3)]
    want = compare.reference_steps(cfg, weights, pho, batches, 77)
    got = compare.reference_steps(cfg, weights, pho, batches, 77,
                                  precision="fp8")
    numbers = compare.train_numbers(got, want)
    assert not compare.judge(numbers, limits(cell))["ok"], numbers


def test_serving_control_is_not_correct(one_thread):
    # The published width (the logits' spread grows with it), few layers.
    cfg, vocab, cjk, weights, pho = setup("arch3.json", width=768)
    cls = reference_class(cfg)
    ref = cls(cfg, weights, *pho)
    control = cls(cfg, weights, *pho, precision="fp8")
    rng = np.random.default_rng(3)
    src = torch.as_tensor(rng.choice(cjk, (16, 60)))
    src[:, 0], src[:, -1] = vocab.index("[CLS]"), vocab.index("[SEP]")
    masks = torch.ones_like(src)
    gap = compare.control_gap(ref, control, src, masks)
    for cell in ("arch3.serve.open", "arch3.serve.closed8"):
        verdict = compare.judge({"served_gap": gap, "step_gap": gap},
                                limits(cell))
        assert not verdict["ok"], (cell, gap)
