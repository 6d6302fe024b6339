"""The port's host side and serving surface against the JAX package's:
tokenizer, pinyin tables, featurization, the Corrector and cli/correct."""

import io
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from realise_tpu.config import config_for
from realise_tpu.data.features import Featurizer as JFeaturizer
from realise_tpu.text.tokenizer import WordPieceTokenizer as JTokenizer
from realise_tpu.text.vocab import build_synthetic_vocab as j_vocab
from realise_tpu.text.vocab import vocab_to_dict
from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.data.features import Featurizer as TFeaturizer
from realise_tpu_torch.data.features import to_device
from realise_tpu_torch.text.tokenizer import WordPieceTokenizer as TTokenizer
from realise_tpu_torch.text.vocab import build_synthetic_vocab as t_vocab
from torch_port_fixtures import live_glyph_features, live_glyph_rows

SENTENCES = ["我爱北经。", "天气很好", "你好吗？", "好", "再见了 朋友",
             "我爱Ω北京", "hello world好", "這是一個測試"]
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def tokenizers(small_vocab_list):
    vocab = vocab_to_dict(small_vocab_list)
    return JTokenizer(vocab), TTokenizer(vocab)


def test_synthetic_vocab_matches():
    assert t_vocab() == j_vocab()
    assert t_vocab(size=21128, cjk_chars=7606) == j_vocab(size=21128,
                                                         cjk_chars=7606)


def test_tokenizer_matches(tokenizers):
    jt, tt = tokenizers
    for s in SENTENCES + ["Héllo, WORLD!", "a\tb\u0000c", "[CLS] 好 [SEP]"]:
        assert tt.tokenize(s) == jt.tokenize(s)
        assert tt.tokenize_with_spans(s) == jt.tokenize_with_spans(s)
        assert tt.encode(s) == jt.encode(s)


def test_pho2_tables_and_featurize_raw_match(tokenizers):
    jt, tt = tokenizers
    cfg = config_for("bert-pho2-res-arch3", vocab_size=len(jt),
                     max_seq_length=16)
    jf = JFeaturizer(jt, cfg)
    tf = TFeaturizer(tt, RealiseConfig.from_dict(cfg.to_dict()))
    for a, b in zip(tf.pho2_tables(), jf.pho2_tables()):
        np.testing.assert_array_equal(a, b)
    for seq_len in (None, 8):
        got = tf.featurize_raw(SENTENCES, seq_len=seq_len)
        want = jf.featurize_raw(SENTENCES, seq_len=seq_len)
        for k in ("src_idx", "masks", "loss_masks", "pho_idx", "pho_lens",
                  "lengths"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["tokens_size"] == want["tokens_size"]
        assert set(tf.device_batch(got)) == set(jf.device_batch(want))
    tensors = to_device(tf.device_batch(got), "cpu")
    assert all(t.dtype == torch.int64 for t in tensors.values())


@pytest.fixture(scope="module")
def ckpts(small_vocab_list, tmp_path_factory):
    """A tiny arch3 checkpoint written by the JAX package, and the same
    weights converted into the port's format, plus the vocab file."""
    from realise_tpu.models.realise import init_realise
    from realise_tpu.training.checkpoint import load_checkpoint, save_checkpoint
    from realise_tpu_torch.models.convert import state_dict_from_jax
    from realise_tpu_torch.models.realise import Realise
    from realise_tpu_torch.training.checkpoint import save_checkpoint as t_save

    root = tmp_path_factory.mktemp("torch_serving")
    vocab_path = str(root / "vocab.txt")
    with open(vocab_path, "w", encoding="utf-8") as f:
        f.write("\n".join(small_vocab_list) + "\n")
    cfg = config_for("bert-pho2-res-arch3", vocab_size=len(small_vocab_list),
                     hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                     intermediate_size=32, pho_num_layers=1, out_num_layers=1,
                     max_seq_length=16, max_position_embeddings=32,
                     num_fonts=1)
    rng = np.random.RandomState(0)
    glyphs = (rng.rand(cfg.vocab_size, 1, 32, 32) > 0.5).astype(np.float32)
    params, state = init_realise(jax.random.PRNGKey(0), cfg, glyphs=glyphs)
    # Spread the logits so a top-2 tie within LOGIT_TOL is rare.
    params = live_glyph_features(jax.tree.map(
        lambda x: np.asarray(x) + rng.normal(0, 0.2, np.shape(x)).astype(np.float32),
        params))
    jdir = str(root / "jax")
    save_checkpoint(jdir, 0, params, state, cfg=cfg)
    restored = load_checkpoint(os.path.join(jdir, "saved_ckpt-0"))
    pcfg = RealiseConfig.from_dict(cfg.to_dict())
    tdir = str(root / "port")
    sd = state_dict_from_jax(restored["params"], restored["state"], pcfg)
    t_save(tdir, 0, sd, pcfg)
    model = Realise(pcfg)
    model.load_state_dict(sd)
    assert live_glyph_rows(model) == cfg.vocab_size
    return jdir, tdir, vocab_path


@pytest.fixture(scope="module")
def correctors(ckpts):
    from realise_tpu.serving import Corrector as JCorrector
    from realise_tpu_torch.serving import Corrector as TCorrector

    jdir, tdir, vocab_path = ckpts
    return (JCorrector(jdir, vocab_path=vocab_path, batch_size=4),
            TCorrector(tdir, vocab_path=vocab_path, batch_size=4, device="cpu"))


def test_corrector_matches_jax(correctors):
    """Logits first; then the strings, at every position whose top-2 logit
    margin exceeds the logit tolerance (nearer ties may legitimately flip)."""
    from realise_tpu.models.realise import (apply_realise,
                                            precompute_inference_tables)

    jc, tc = correctors
    host = jc.featurizer.featurize_raw(SENTENCES, seq_len=16)
    arrays = jc.featurizer.device_batch(host)
    idx, lens = jc.featurizer.pho2_tables()
    tables = precompute_inference_tables(jc.params, jc.state, jc.cfg, idx, lens)
    want = np.asarray(apply_realise(jc.params, jc.state, arrays, jc.cfg,
                                    inference_tables=tables)["logits"])
    got = tc.logits(arrays).float().numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL)

    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * LOGIT_TOL
    valid = arrays["masks"].astype(bool)
    np.testing.assert_array_equal(got.argmax(-1)[clear & valid],
                                  want.argmax(-1)[clear & valid])
    j_out, t_out = jc.correct(SENTENCES), tc.correct(SENTENCES)
    compared = 0
    for i, (a, b) in enumerate(zip(t_out, j_out)):
        if (clear | ~valid)[i].all():
            assert a == b, SENTENCES[i]
            compared += 1
    assert compared >= len(SENTENCES) // 2
    assert [len(s) for s in t_out] == [len(s) for s in SENTENCES]


def test_corrector_batch_padding_stable(correctors):
    _, tc = correctors
    single = tc.correct(["我爱北京。"])
    batch = tc.correct(["我爱北京。", "你好吗", "天气很好"])
    assert batch[0] == single[0]
    assert tc._bucket_for(["好好"]) == 16  # max_seq_length 16


def test_corrector_kernel_route_on_cpu(ckpts, correctors):
    """use_kernels=True on the CPU runs the plain kernel versions (the Pallas
    numerics); in f32 they agree with the plain sub-blocks."""
    from realise_tpu_torch.serving import Corrector

    _, tdir, vocab_path = ckpts
    _, plain = correctors
    kern = Corrector(tdir, vocab_path=vocab_path, batch_size=4, device="cpu",
                     use_kernels=True)
    arrays = plain.featurizer.device_batch(
        plain.featurizer.featurize_raw(SENTENCES[:4]))
    np.testing.assert_allclose(kern.logits(arrays).numpy(),
                               plain.logits(arrays).numpy(), atol=LOGIT_TOL)


def test_corrector_edits():
    from realise_tpu_torch.serving import Corrector

    assert Corrector.edits("我爱北经。", "我爱北京。") == [(4, "经", "京")]
    assert Corrector.edits("天气", "天气") == []


def test_cli_correct_stdin(ckpts, monkeypatch, capsys):
    from realise_tpu_torch.cli import correct

    _, tdir, vocab_path = ckpts
    monkeypatch.setattr("sys.stdin", io.StringIO("我爱北经。\n\n天气很好\n"))
    rc = correct.main(["--ckpt_dir", tdir, "--vocab_path", vocab_path,
                       "--device", "cpu", "--show_edits"])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    assert [len(ln.split("\t")[0]) for ln in lines] == [5, 4]


def test_entry_point_without_device_raises(ckpts):
    """No CUDA and no explicit device: the Corrector refuses to carry on on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from realise_tpu_torch.serving import Corrector

    _, tdir, vocab_path = ckpts
    with pytest.raises(RuntimeError, match="CUDA"):
        Corrector(tdir, vocab_path=vocab_path)


def test_unviable_kernel_config_raises(ckpts, tmp_path):
    """A config the fused kernels cannot compute raises with the reason when
    kernels are asked for, and serves on the plain path when they are not."""
    from realise_tpu_torch.serving import Corrector

    _, tdir, vocab_path = ckpts
    ckpt = str(tmp_path / "saved_ckpt-0")
    shutil.copytree(os.path.join(tdir, "saved_ckpt-0"), ckpt)
    with open(os.path.join(ckpt, "config.json")) as f:
        cfg = json.load(f)
    cfg["hidden_act"] = "relu"
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(cfg, f)
    with pytest.raises(ValueError, match="gelu"):
        Corrector(str(tmp_path), vocab_path=vocab_path, device="cpu",
                  use_kernels=True)
    c = Corrector(str(tmp_path), vocab_path=vocab_path, device="cpu",
                  use_kernels=False, fast_path=False)
    assert len(c.correct(["好"])[0]) == 1
