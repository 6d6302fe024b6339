"""The reference against the port's CPU path at a tiny size: its dropout
masks bit for bit, its vocabulary and pinyin ids, and in float32 the first
three training steps and the served logits within float32 rounding."""

import pytest
import torch

from conftest import (CLOSED_PARAMS, DP_PARAMS, ROOT, SERVE_PARAMS,
                      TRAIN_PARAMS, run_cell)

from benchmark.reference import dropout as D
from benchmark.reference import text


def test_masks_are_the_ports():
    from realise_tpu_torch.ops.kernels import bert_block_train as K
    from realise_tpu_torch.ops.layers import dropout

    x = torch.ones(3, 5, 256)
    key = (0x12345678, 0x9ABCDEF0)
    assert torch.equal(dropout(x, 0.1, key),
                       x * D.flat_mask(x.shape, key, 0.1, "cpu"))
    for cols in (256, 96):
        assert torch.equal(
            K.block_keep_mask(1234567, K.SITE_FFN_OUT, 3, 7, cols, 0.9, "cpu"),
            D.hidden_mask(1234567, D.SITE_FFN_OUT, 3, 7, cols, 0.1, "cpu"))
    assert torch.equal(K.probs_keep_mask(99, 2, 3, 16, 0.9, "cpu"),
                       D.probs_mask(99, 2, 3, 16, 0.1, "cpu"))


def test_draws_are_the_trainers():
    from realise_tpu_torch.ops.bert import layer_seed
    from realise_tpu_torch.ops.layers import dropout_generator, random_key

    for stream in (0, 3):
        gen = dropout_generator(2 ** 40 + 7, stream)
        draws = D.Draws(2 ** 40 + 7, stream)
        for _ in range(3):
            assert random_key(gen) == draws.key()
            assert layer_seed(gen) == draws.layer_seed()


def test_vocab_and_pinyin_are_the_ports():
    from realise_tpu_torch.text.pinyin import Pinyin2Convertor
    from realise_tpu_torch.text.vocab import build_synthetic_vocab

    table = text.read_pinyin_table(text.pinyin_table_path(ROOT))
    vocab = text.synthetic_vocab(table, 21128, 7606)
    assert vocab == build_synthetic_vocab(21128, 7606)
    ids, lens = text.pho2_ids(vocab[:3000], table, 8)
    want_ids, want_lens = Pinyin2Convertor(8).convert(vocab[:3000])
    assert (ids == want_ids).all() and (lens == want_lens).all()
    assert len(text.cjk_ids(vocab, table)) == 7606


@pytest.mark.parametrize("workload,params", [
    ("arch3.train.b256", TRAIN_PARAMS), ("bert.train.b256", TRAIN_PARAMS),
    ("bert.train.b32", TRAIN_PARAMS),
    ("arch3.train.dp4", DP_PARAMS)])
def test_float32_training_steps_agree(capsys, one_thread, workload, params):
    rc, res = run_cell(capsys, workload, params)
    assert rc == 0 and res["correct"] and res["attempted"] > 0
    # A float32 program sits far inside limits set for bf16.
    for name, c in res["checks"].items():
        assert c["value"] < c["limit"] / 10, (name, c)


@pytest.mark.parametrize("workload,params", [
    ("arch3.serve.open", SERVE_PARAMS), ("arch3.serve.closed8", CLOSED_PARAMS)])
def test_float32_serving_agrees(capsys, one_thread, workload, params):
    rc, res = run_cell(capsys, workload, params, seconds="2")
    assert rc == 0 and res["correct"] and res["failed"] == 0
    for name, c in res["checks"].items():
        assert c["value"] < c["limit"] / 10, (name, c)
