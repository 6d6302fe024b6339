"""roofline.py against hand counts of one encoder layer and one sentence."""

import json
import os

from conftest import ROOT

from benchmark import roofline


def arch3():
    with open(os.path.join(ROOT, "benchmark", "configs", "arch3.json")) as f:
        return json.load(f)


def test_one_layer_by_hand():
    cfg = arch3()
    h, i = 768, 3072
    # b=2 sequences of s=4: q, k, v, out (4 H^2) and W1, W2 (2 H I) per
    # token, 2 FLOPs a multiply-add; q.k^T and p.v 2 s^2 H each per sequence.
    tokens, b, s = 8, 2, 4
    want = 2 * tokens * (4 * h * h + 2 * h * i) + 2 * (2 * s * s * h * 2)
    assert roofline.layer_forward_flops(tokens, b * s * s, cfg) == want
    least, bound = roofline.layer_least_seconds(b, s, cfg, train=False)
    nbytes = 2 * 2 * tokens * h + 2 * (4 * h * h + 2 * h * i)
    assert bound == "bytes"
    assert abs(least - nbytes / 3.35e12) < 1e-18
    # A large block is bound by operations, and training is 3x the FLOPs.
    t_fwd, b_fwd = roofline.layer_least_seconds(256, 128, cfg, train=False)
    t_train, b_train = roofline.layer_least_seconds(256, 128, cfg, train=True)
    assert b_fwd == b_train == "operations"
    assert abs(t_train / t_fwd - 3.0) < 1e-12


def test_model_forward_of_one_sentence():
    cfg = arch3()
    n, h, v = 10, 768, 21128
    layers = 12 + 4 + 3
    per_layer = 2 * n * (4 * h * h + 2 * h * 3072) + 4 * h * n * n
    gate = 2 * 4 * h * 3 * n
    want = layers * per_layer + 2 * h * v * n + gate
    assert roofline.model_forward_flops([n], cfg) == want
    assert roofline.encoder_layers(cfg) == layers
    bert = dict(cfg, pho_encoder="none", res_encoder="none",
                fusion="baseline", out_num_layers=0)
    assert roofline.model_forward_flops([n], bert) == (
        12 * per_layer + 2 * h * v * n)
