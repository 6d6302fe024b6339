"""Length-bucketed training in the port against the JAX package:
``bucketed_batch_iterator``, ``synthetic_confusion_dataset``, and
``cli/train --length_buckets`` (the same featurized batches and loss trace
as the JAX CLI), with ``--trace_dir`` and ``--resume`` each equal to a
straight run bit for bit."""

import dataclasses
import glob
import json
import os
import pickle
import random
import threading

import jax
import numpy as np
import pytest
import torch

from realise_tpu.cli import common as jcommon
from realise_tpu.cli import train as jtrain
from realise_tpu.data.dataset import bucketed_batch_iterator as jax_bucketed
from realise_tpu.data.dataset import synthetic_confusion_dataset as jax_confusion
from realise_tpu.data.features import Featurizer as JaxFeaturizer
from realise_tpu.models.realise import init_realise
from realise_tpu.text.tokenizer import WordPieceTokenizer as JaxTokenizer
from realise_tpu.training import checkpoint as jckpt
from realise_tpu.training.trainer import Trainer as JaxTrainer
from realise_tpu_torch.cli import train as ttrain
from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.data import dataset as tdata
from realise_tpu_torch.models.convert import state_dict_from_jax
from realise_tpu_torch.text.tokenizer import WordPieceTokenizer
from realise_tpu_torch.text.vocab import build_synthetic_vocab, vocab_to_dict
from realise_tpu_torch.training import checkpoint as tckpt
from realise_tpu_torch.training.trainer import Trainer
from torch_port_fixtures import live_glyph_features, one_intra_op_thread

BUCKETS = "8,16"
BATCH = 8
N_TRAIN = 40


@pytest.fixture(autouse=True)
def _one_thread():
    with one_intra_op_thread():
        yield


def _examples(seed, n=60):
    """Examples of 3 to 30 ids (some past the largest bucket below), with
    an id to tell them apart."""
    r = random.Random(seed)
    return [{"id": i, "src_idx": [0] * r.randint(3, 30)} for i in range(n)]


@pytest.mark.parametrize("seed", [0, 7, 17])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("pad_final", [False, True])
def test_bucketed_batch_iterator_matches_jax(seed, shuffle, pad_final):
    """The same (bucket, example ids) batches in the same order, examples
    past the largest bucket in the largest, short batches padded by
    repetition only with ``pad_final``."""
    data = _examples(seed)
    kw = dict(buckets=(16, 8, 24), shuffle=shuffle, seed=seed,
              pad_final=pad_final)
    ours = [(b, [ex["id"] for ex in batch])
            for b, batch in tdata.bucketed_batch_iterator(data, 8, **kw)]
    theirs = [(b, [ex["id"] for ex in batch])
              for b, batch in jax_bucketed(data, 8, **kw)]
    assert ours == theirs
    assert any(len(data[i]["src_idx"]) > 24 for b, ids in ours if b == 24
               for i in ids)
    assert all(len(ids) == 8 for _, ids in ours) == pad_final


def test_synthetic_confusion_dataset_matches_jax():
    vocab = build_synthetic_vocab(size=400, cjk_chars=300)
    for seed in (1, 2):
        ours = tdata.synthetic_confusion_dataset(
            WordPieceTokenizer(vocab_to_dict(vocab)), num_examples=50,
            seed=seed)
        theirs = jax_confusion(JaxTokenizer(vocab_to_dict(vocab)),
                               num_examples=50, seed=seed)
        assert ours == theirs
        assert any(ex["src"] != ex["tgt"] for ex in ours)


# ------------------------------------------------------- cli/train, buckets
@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """A vocab.txt of 400 tokens and a train.pkl of 40 examples of 4-12
    chars (6-14 ids with [CLS]/[SEP]): both buckets of 8,16 are used, and
    an epoch at batch 8 is ceil(n_8/8) + ceil(n_16/8) batches."""
    d = tmp_path_factory.mktemp("data")
    vocab = build_synthetic_vocab(size=400, cjk_chars=300)
    (d / "vocab.txt").write_text("\n".join(vocab) + "\n", encoding="utf-8")
    train = tdata.synthetic_dataset(WordPieceTokenizer(vocab_to_dict(vocab)),
                                    num_examples=N_TRAIN, seed=3)
    with open(d / "train.pkl", "wb") as f:
        pickle.dump(train, f)
    return str(d), train


def _epoch_batches(train):
    return len(list(jax_bucketed(train, BATCH, buckets=(8, 16),
                                 pad_final=False)))


def _cli(data, out, *extra):
    return ["--data_dir", data, "--train_file", "train.pkl", "--tiny",
            "--per_device_train_batch_size", str(BATCH), "--length_buckets",
            BUCKETS, "--logging_steps", "1", "--save_steps", "1000",
            "--output_dir", str(out), *extra]


def _no_dropout(monkeypatch, module):
    build = module.build_config

    def build_config(args, vocab_size):
        return dataclasses.replace(build(args, vocab_size),
                                   hidden_dropout_prob=0.0,
                                   attention_probs_dropout_prob=0.0)

    monkeypatch.setattr(module, "build_config", build_config)


def _record(monkeypatch, cls):
    """Each train_step's host batch (numpy) and loss."""
    rec = []
    step = cls.train_step

    def train_step(self, batch):
        loss = step(self, batch)
        rec.append(({k: np.asarray(v) for k, v in batch.items()}, float(loss)))
        return loss

    monkeypatch.setattr(cls, "train_step", train_step)
    return rec


def _same_init(data, root):
    """One tiny arch3 init (the CLIs' config, dropout 0) as a JAX and as a
    port checkpoint: (JAX dir, port dir)."""
    args = jtrain.build_parser().parse_args(_cli(data, root))
    tok = jcommon.build_tokenizer(args)
    cfg = dataclasses.replace(jcommon.build_config(args, len(tok)),
                              hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    params, state = init_realise(
        jax.random.PRNGKey(0), cfg, glyphs=jcommon.build_glyphs(args, tok, cfg),
        pho_tables=JaxFeaturizer(tok, cfg).pho2_tables())
    params = live_glyph_features(jax.tree.map(np.asarray, params))
    state = jax.tree.map(np.asarray, state)
    jdir, tdir = os.path.join(root, "jax_init"), os.path.join(root, "port_init")
    jckpt.save_checkpoint(jdir, 0, params, state, cfg=cfg)
    pcfg = RealiseConfig.from_dict(cfg.to_dict())
    tckpt.save_checkpoint(tdir, 0, state_dict_from_jax(params, state, pcfg), pcfg)
    return jckpt.list_checkpoints(jdir)[-1][1], tckpt.list_checkpoints(tdir)[-1][1]


def test_cli_buckets_match_the_jax_cli(data_dir, tmp_path, monkeypatch):
    """Four bucketed steps (fewer than the JAX CLI's epoch count, so both
    read the same stream) from the same weights at dropout 0: the same
    featurized batches, array for array, at both bucket lengths, and loss
    traces within 1e-5 (float32; the two differ in summation order only)."""
    data, train = data_dir
    steps = 4
    assert steps < -(-N_TRAIN // BATCH)
    jinit, tinit = _same_init(data, str(tmp_path))
    _no_dropout(monkeypatch, jtrain)
    _no_dropout(monkeypatch, ttrain)
    theirs = _record(monkeypatch, JaxTrainer)
    ours = _record(monkeypatch, Trainer)
    assert jtrain.main(_cli(data, tmp_path / "jax", "--max_steps", str(steps),
                            "--init_ckpt", jinit)) == 0
    assert ttrain.main(_cli(data, tmp_path / "port", "--max_steps", str(steps),
                            "--init_ckpt", tinit, "--device", "cpu")) == 0
    assert len(ours) == len(theirs) == steps
    lengths = set()
    for (got, _), (want, _) in zip(ours, theirs):
        keys = set(got) & set(want)
        assert {"src_idx", "tgt_idx", "masks", "loss_masks", "pho_idx",
                "pho_lens"} <= keys
        for k in keys:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        lengths.add(got["src_idx"].shape[1])
    assert lengths == {8, 16}
    np.testing.assert_allclose([loss for _, loss in ours],
                               [loss for _, loss in theirs], atol=1e-5)


def _prefetch_workers():
    return [t for t in threading.enumerate()
            if t.name == "threaded_prefetch" and t.is_alive()]


def test_cli_trace_run_equals_an_untraced_run(data_dir, tmp_path, monkeypatch):
    """--trace_dir --trace_steps 2 of a 5-step bucketed run at dropout 0.1:
    the loss trace and the final weights are the untraced run's bits, the
    trace file is written and names the traced steps' operators, and no
    prefetch worker outlives either run."""
    data, _ = data_dir
    rec = _record(monkeypatch, Trainer)
    runs = {}
    for name, extra in (("plain", []),
                        ("traced", ["--trace_dir", str(tmp_path / "trace"),
                                    "--trace_steps", "2"])):
        del rec[:]
        assert ttrain.main(_cli(data, tmp_path / name, "--max_steps", "5",
                                "--device", "cpu", *extra)) == 0
        assert _prefetch_workers() == []
        runs[name] = ([loss for _, loss in rec],
                      tckpt.load_checkpoint(str(tmp_path / name / "saved_ckpt-5")))
    assert runs["traced"][0] == runs["plain"][0] and len(runs["plain"][0]) == 5
    want = runs["plain"][1]
    assert all(torch.equal(v, want[k]) for k, v in runs["traced"][1].items())
    (path,) = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::addmm" in names or "aten::mm" in names


def test_cli_bucketed_epochs_and_resume(data_dir, tmp_path):
    """An epoch under --length_buckets is the bucketed iterator's batches,
    sum(ceil(n_b / batch)) (6 here; ceil(N / batch) = 5 would end each epoch
    a batch early); --num_train_epochs 1.5 trains 9 steps. 4 steps, then
    --resume across the epoch boundary to step 9, equal the straight run bit
    for bit at dropout 0.1: weights, optimizer state, step, generator."""
    data, train = data_dir
    assert _epoch_batches(train) == 6 != -(-N_TRAIN // BATCH)
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    epochs = ["--num_train_epochs", "1.5", "--device", "cpu"]
    assert ttrain.main(_cli(data, straight, *epochs)) == 0
    assert [s for s, _ in tckpt.list_checkpoints(str(straight))] == [9]
    assert ttrain.main(_cli(data, resumed, "--max_steps", "4", "--device",
                            "cpu")) == 0
    assert ttrain.main(_cli(data, resumed, "--resume", *epochs)) == 0
    got, want = (str(d / "saved_ckpt-9") for d in (resumed, straight))
    a, b = tckpt.load_checkpoint(got), tckpt.load_checkpoint(want)
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    sa, sb = tckpt.load_trainer_state(got), tckpt.load_trainer_state(want)
    assert sa["step"] == sb["step"] == 9
    assert torch.equal(sa["generator"], sb["generator"])
    for pa, pb in zip(sa["optimizer"]["state"].values(),
                      sb["optimizer"]["state"].values()):
        assert all(torch.equal(pa[k], pb[k]) for k in pa)
