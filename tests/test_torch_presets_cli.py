"""The presets through the port's host side and entry points, against the
JAX package's: the pho1 pinyin scheme and featurization, the Corrector of
a pho1 preset, cli/test of a merged preset, cli/show_gate of arch3 and of
the --with_pho no ablation (every config through the CLIs is
tests/test_torch_presets_entry_points.py's).

Checkpoints are written by the JAX package with every parameter random from
a numpy seed and converted with state_dict_from_jax. Logits within 1e-4 in
float32; the scores equal, the average loss within 1e-5 relative; the gate
TSV's text equal but for the gates, each within 2e-4 (printed to 4 decimals:
a 1e-4 difference may round either way).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from realise_tpu.config import config_for
from realise_tpu.data.features import Featurizer as JFeaturizer
from realise_tpu.text.pinyin import Pinyin1Convertor as JPinyin1
from realise_tpu.text.tokenizer import WordPieceTokenizer as JTokenizer
from realise_tpu.text.vocab import build_synthetic_vocab, vocab_to_dict
from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.data.features import Featurizer as TFeaturizer
from realise_tpu_torch.data.features import make_example
from realise_tpu_torch.text.pinyin import Pinyin1Convertor as TPinyin1
from realise_tpu_torch.text.pinyin import pho1_convertor
from realise_tpu_torch.text.tokenizer import WordPieceTokenizer as TTokenizer
from torch_port_fixtures import live_glyph_features

SENTENCES = ["我爱北经。", "天气很好", "你好吗？", "嗯，好", "再见了 朋友",
             "我爱Ω北京", "hello world好", "這是一個測試"]
LOGIT_TOL, GATE_TOL = 1e-4, 2e-4
SMALL = dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
             intermediate_size=32, pho_num_layers=1, out_num_layers=1,
             max_seq_length=32, max_position_embeddings=32)


def test_pinyin1_matches_jax():
    """The 65-symbol scheme and its triples over the synthetic vocab (with
    嗯's special case) equal the JAX package's."""
    vocab = build_synthetic_vocab() + ["嗯", "女", "绿", "儿", "[UNK]", "ab"]
    ours, theirs = TPinyin1(), JPinyin1()
    assert ours.vocab_list == theirs.vocab_list
    assert ours.get_pho_size() == pho1_convertor.get_pho_size() == 65
    assert ours.convert(vocab) == theirs.convert(vocab)
    assert ours.get_pinyin("嗯") == ("[NULL]", "en", "2")


def test_pho1_featurization_matches_jax(small_vocab_list):
    """pho1_table, and pho1_idx in featurize / featurize_raw (a table gather
    on src_idx; no pho2 features) equal the JAX Featurizer's."""
    vocab = vocab_to_dict(small_vocab_list)
    cfg = config_for("bert-pho1-res", vocab_size=len(small_vocab_list),
                     max_seq_length=16)
    jf = JFeaturizer(JTokenizer(vocab), cfg)
    tf = TFeaturizer(TTokenizer(vocab), RealiseConfig.from_dict(cfg.to_dict()))
    np.testing.assert_array_equal(tf.pho1_table(), jf.pho1_table())
    got, want = tf.featurize_raw(SENTENCES), jf.featurize_raw(SENTENCES)
    np.testing.assert_array_equal(got["pho1_idx"], want["pho1_idx"])
    assert set(tf.device_batch(got)) == set(jf.device_batch(want)) == {
        "src_idx", "masks", "loss_masks", "pho1_idx"}
    examples = [make_example(str(i), t, t, tf.tokenizer)
                for i, t in enumerate(SENTENCES)]
    np.testing.assert_array_equal(tf.featurize(examples)["pho1_idx"],
                                  got["pho1_idx"])


def _write_ckpts(root, model_type, vocab_list, spread=0.2, **overrides):
    """A JAX checkpoint of ``model_type`` at SMALL widths with random
    weights, and the port's of the same weights. → (jax dir, port dir)."""
    from realise_tpu.models.realise import init_realise
    from realise_tpu.training.checkpoint import load_checkpoint, save_checkpoint
    from realise_tpu_torch.models.convert import state_dict_from_jax
    from realise_tpu_torch.training.checkpoint import save_checkpoint as t_save

    cfg = config_for(model_type, vocab_size=len(vocab_list),
                     **dict(SMALL, **overrides))
    rng = np.random.RandomState(0)
    glyphs = (rng.rand(cfg.vocab_size, cfg.num_fonts, 32, 32) > 0.5).astype(
        np.float32) if cfg.with_res else None
    params, state = init_realise(jax.random.PRNGKey(0), cfg, glyphs=glyphs)
    # Spread the logits so a top-2 tie within the tolerance is rare.
    params = live_glyph_features(jax.tree.map(
        lambda x: np.asarray(x)
        + rng.normal(0, spread, np.shape(x)).astype(np.float32), params))
    jdir, tdir = str(root / "jax"), str(root / "port")
    save_checkpoint(jdir, 0, params, state, cfg=cfg)
    restored = load_checkpoint(os.path.join(jdir, "saved_ckpt-0"))
    pcfg = RealiseConfig.from_dict(cfg.to_dict())
    t_save(tdir, 0, state_dict_from_jax(restored["params"], restored["state"],
                                        pcfg), pcfg)
    return jdir, tdir


@pytest.fixture(scope="module")
def vocab_file(small_vocab_list, tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(small_vocab_list) + "\n", encoding="utf-8")
    return str(path)


def test_corrector_pho1_res_matches_jax(small_vocab_list, vocab_file, tmp_path):
    """The Corrector of a bert-pho1-res checkpoint (pho1 lookups, the glyph
    features added to them raw, integrate): logits within 1e-4 of the JAX
    Corrector's forward, and the same corrections wherever every position's
    top-2 margin exceeds twice that."""
    from realise_tpu.models.realise import (apply_realise,
                                            precompute_inference_tables)
    from realise_tpu.serving import Corrector as JCorrector
    from realise_tpu_torch.serving import Corrector as TCorrector

    jdir, tdir = _write_ckpts(tmp_path, "bert-pho1-res", small_vocab_list)
    jc = JCorrector(jdir, vocab_path=vocab_file, batch_size=4)
    tc = TCorrector(tdir, vocab_path=vocab_file, batch_size=4, device="cpu")
    assert set(tc.tables) == {"res"}
    host = jc.featurizer.featurize_raw(SENTENCES, seq_len=16)
    arrays = jc.featurizer.device_batch(host)
    assert "pho1_idx" in arrays
    tables = precompute_inference_tables(jc.params, jc.state, jc.cfg)
    want = np.asarray(apply_realise(jc.params, jc.state, arrays, jc.cfg,
                                    inference_tables=tables)["logits"])
    got = tc.logits(arrays).float().numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * LOGIT_TOL
    valid = arrays["masks"].astype(bool)
    j_out, t_out = jc.correct(SENTENCES), tc.correct(SENTENCES)
    compared = 0
    for i, (a, b) in enumerate(zip(t_out, j_out)):
        if (clear | ~valid)[i].all():
            assert a == b, SENTENCES[i]
            compared += 1
    assert compared >= len(SENTENCES) // 2
    assert [len(s) for s in t_out] == [len(s) for s in SENTENCES]


def test_cli_test_merged_preset_matches_jax(small_vocab_list, vocab_file,
                                            tmp_path):
    """cli/test of a bert-pho2-res checkpoint scores the synthetic test set
    as the JAX package's evaluate_model scores it on the same weights: the
    same metrics and prediction files, the average loss within 1e-5."""
    from realise_tpu.cli.common import evaluate_model as j_evaluate
    from realise_tpu.data.dataset import synthetic_dataset as j_synthetic
    from realise_tpu.training.checkpoint import load_checkpoint, load_config
    from realise_tpu.training.trainer import Trainer as JTrainer
    from realise_tpu_torch.cli import test as ttest

    jdir, tdir = _write_ckpts(tmp_path, "bert-pho2-res", small_vocab_list,
                              spread=0.5)
    out = tmp_path / "out"
    assert ttest.main(["--ckpt_dir", tdir, "--vocab_path", vocab_file,
                       "--synthetic", "--device", "cpu",
                       "--output_dir", str(out)]) == 0
    ours = json.loads((out / "test_results.json").read_text())
    ck = os.path.join(jdir, "saved_ckpt-0")
    restored = load_checkpoint(ck)
    jt = JTrainer(load_config(ck), jax.tree.map(jnp.asarray, restored["params"]),
                  jax.tree.map(jnp.asarray, restored["state"]))
    jtok = JTokenizer(vocab_to_dict(small_vocab_list))
    data = j_synthetic(jtok, num_examples=64, seed=99)
    theirs = j_evaluate(jt, data, JFeaturizer(jtok, jt.cfg), jtok,
                        str(tmp_path / "j"), prefix="sighan15")
    assert set(ours) == set(theirs)
    for k in ours:
        if k == "avg_loss":
            np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-5)
        else:
            assert ours[k] == theirs[k], k
    for name in ("preds.txt", "labels.txt"):
        assert ((out / "sighan15" / name).read_bytes()
                == (tmp_path / "j" / "sighan15" / name).read_bytes()), name


def _read_tsv(path):
    lines = open(path, encoding="utf-8").read().splitlines()
    head = lines[0].split("\t")
    rows = [ln.split("\t") for ln in lines[1:]]
    return head, [r[:3] for r in rows], np.asarray(
        [[float(x) for x in r[3:]] for r in rows])


@pytest.mark.parametrize("overrides,columns", [
    ({}, ["g_sem", "g_pho", "g_res"]),
    ({"pho_encoder": "none"}, ["g_sem", "g_res"]),
])
def test_show_gate_matches_jax(small_vocab_list, vocab_file, tmp_path,
                               overrides, columns):
    """cli/show_gate of arch3 and of the --with_pho no ablation writes the
    JAX CLI's TSV: the same columns, ids, positions and chars, each gate
    within 2e-4."""
    from realise_tpu.cli import show_gate as j_show_gate
    from realise_tpu_torch.cli import show_gate as t_show_gate

    jdir, tdir = _write_ckpts(tmp_path, "bert-pho2-res-arch3", small_vocab_list,
                              **overrides)
    common = ["--vocab_path", vocab_file, "--synthetic", "--batch_size", "8"]
    assert j_show_gate.main(["--ckpt_dir", jdir, "--output",
                             str(tmp_path / "j.tsv"), "--platform", "cpu"]
                            + common) == 0
    assert t_show_gate.main(["--ckpt_dir", tdir, "--output",
                             str(tmp_path / "t.tsv"), "--device", "cpu"]
                            + common) == 0
    jhead, jrows, jgates = _read_tsv(tmp_path / "j.tsv")
    thead, trows, tgates = _read_tsv(tmp_path / "t.tsv")
    assert thead == jhead == ["id", "pos", "char"] + columns
    assert trows == jrows and len(trows) > 100
    np.testing.assert_allclose(tgates, jgates, atol=GATE_TOL)


def test_show_gate_refuses_a_model_without_gates(small_vocab_list, vocab_file,
                                                 tmp_path):
    from realise_tpu_torch.cli import show_gate as t_show_gate

    _, tdir = _write_ckpts(tmp_path, "bert-pho2-res-arch2", small_vocab_list)
    with pytest.raises(SystemExit, match="no gate fusion"):
        t_show_gate.main(["--ckpt_dir", tdir, "--vocab_path", vocab_file,
                          "--synthetic", "--device", "cpu"])


@pytest.mark.parametrize("model_type", ["bert-pho2-res", "bert-pho1",
                                        "bert-pho2-res-arch3-mlm"])
def test_reference_names_of_the_zoo(model_type, tmp_path):
    """A reference pytorch_model.bin of a merged preset names its pho BERT
    pho_res_model.* (src/models.py:265,404) and an MLM preset saves the
    decoder's bias twice (cls.predictions.bias and .decoder.bias): the
    port's reader maps both to the model's own keys, and the JAX importer
    reads the same file to the same arrays."""
    import torch

    from realise_tpu.models.torch_import import (import_realise_state_dict,
                                                 normalize_state_dict)
    from realise_tpu_torch.models.realise import Realise
    from realise_tpu_torch.models.torch_import import import_checkpoint_dir

    cfg = RealiseConfig.from_dict(config_for(
        model_type, vocab_size=40, **dict(SMALL, num_fonts=1)).to_dict())
    want = Realise(cfg, generator=torch.Generator().manual_seed(3)).state_dict()
    ref = {}
    for k, v in want.items():
        if cfg.fusion == "merged" and k.startswith("pho_model."):
            k = "pho_res_model." + k[len("pho_model."):]
        ref["module." + k] = v
    if cfg.head == "mlm":
        ref["module.cls.predictions.decoder.bias"] = want["cls.predictions.bias"]
    torch.save(ref, tmp_path / "pytorch_model.bin")
    got = import_checkpoint_dir(str(tmp_path), cfg)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    jcfg = config_for(model_type, vocab_size=40, **dict(SMALL, num_fonts=1))
    sd = {k: v.numpy() for k, v in ref.items()}
    theirs, _ = import_realise_state_dict(normalize_state_dict(sd), jcfg)
    ours, _ = import_realise_state_dict(
        {k: v.numpy() for k, v in got.items()}, jcfg)
    jax.tree.map(np.testing.assert_array_equal, ours, theirs)
