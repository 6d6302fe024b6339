"""The port's eval and scoring path against the JAX package's.

The SIGHAN scorer (``metric_core``), the year-13 filter (``remove_de``), the
paired bootstrap (``sig_test``), the gold labels and the prediction files on
seeded label files and datasets; ``evaluate_model`` on carried weights
(files and metrics equal to the JAX package's); the ``cli/train --do_eval
--do_predict`` and ``cli/test`` entry points end to end on the CPU.
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realise_tpu.cli.common import evaluate_model as jax_evaluate_model
from realise_tpu.config import config_for
from realise_tpu.data.dataset import dataset_labels as jax_dataset_labels
from realise_tpu.data.features import Featurizer as JaxFeaturizer
from realise_tpu.eval import metric_core as jcore
from realise_tpu.eval.metric import Metric as JaxMetric
from realise_tpu.eval.remove_de import remove_de as jax_remove_de
from realise_tpu.eval.sig_test import paired_bootstrap as jax_bootstrap
from realise_tpu.models.realise import init_realise
from realise_tpu.text.tokenizer import WordPieceTokenizer as JaxTokenizer
from realise_tpu.training.trainer import Trainer as JaxTrainer
from realise_tpu_torch.cli import common as tcommon
from realise_tpu_torch.cli import test as ttest
from realise_tpu_torch.cli import train as ttrain
from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.data.dataset import dataset_labels, synthetic_dataset
from realise_tpu_torch.data.features import Featurizer
from realise_tpu_torch.eval import metric_core as tcore
from realise_tpu_torch.eval.metric import Metric
from realise_tpu_torch.eval.remove_de import remove_de
from realise_tpu_torch.eval.sig_test import paired_bootstrap
from realise_tpu_torch.models import realise as trealise
from realise_tpu_torch.models.convert import state_dict_from_jax
from realise_tpu_torch.text.tokenizer import WordPieceTokenizer
from realise_tpu_torch.text.vocab import build_synthetic_vocab, vocab_to_dict
from realise_tpu_torch.training.checkpoint import list_checkpoints
from realise_tpu_torch.training.trainer import Trainer

CHARS = "的地得我你他她天气很好北京经济上海"


def _label_lines(seed, n=40, like=None):
    """Seeded SIGHAN label lines (``id, 0`` or ``id, pos, char, ...``),
    地/得 among the chars; ``like``: reuse those lines' ids and keep about
    half of their edits (a system's predictions)."""
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(n):
        sid = f"A2-{i:04d}-1"
        if like is not None:
            base = jcore.parse_label_line(like[i])[1]
            edits = [e for e in base if rng.rand() < 0.6]
            if rng.rand() < 0.3:
                edits.append((int(rng.randint(1, 30)), CHARS[rng.randint(len(CHARS))]))
        else:
            k = rng.choice([0, 0, 1, 2, 3])
            pos = sorted(rng.choice(np.arange(1, 30), k, replace=False))
            edits = [(int(p), CHARS[rng.randint(len(CHARS))]) for p in pos]
        lines.append(jcore.format_label_line(sid, sorted(set(edits))))
    return lines


def _write(path, lines):
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(path)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metric_core_matches_jax(tmp_path, seed):
    gold = _label_lines(seed)
    pred = _label_lines(seed + 10, like=gold)
    g, p = _write(tmp_path / "g", gold), _write(tmp_path / "p", pred)
    assert tcore.metric_file(p, g) == jcore.metric_file(p, g)
    for line in gold + pred + ["A1-1,2,俊", "x, 0"]:
        assert tcore.parse_label_line(line) == jcore.parse_label_line(line)
    items = tcore.read_label_file(g)
    assert [tcore.format_label_line(*it) for it in items] == [
        jcore.format_label_line(*it) for it in items]


@pytest.mark.parametrize("seed", [0, 1])
def test_remove_de_matches_jax(tmp_path, seed):
    """The filtered file is the JAX filter's byte for byte; the port also
    counts the edits it dropped."""
    lines = _label_lines(seed)
    src = _write(tmp_path / "in", lines)
    dropped = remove_de(src, str(tmp_path / "ours"))
    jax_remove_de(src, str(tmp_path / "theirs"))
    assert (tmp_path / "ours").read_bytes() == (tmp_path / "theirs").read_bytes()
    want = sum(c in ("地", "得") for ln in lines
               for _, c in jcore.parse_label_line(ln)[1])
    assert dropped == want > 0


def test_sig_test_matches_jax():
    gold = [jcore.parse_label_line(x) for x in _label_lines(3, n=60)]
    sys1 = [jcore.parse_label_line(x) for x in _label_lines(4, n=60, like=[
        jcore.format_label_line(*g) for g in gold])]
    sys2 = [jcore.parse_label_line(x) for x in _label_lines(5, n=60, like=[
        jcore.format_label_line(*g) for g in gold])]
    for key in ("sent-detect-f1", "sent-correct-f1"):
        assert paired_bootstrap(sys1, sys2, gold, key, num_samples=300,
                                seed=7) == jax_bootstrap(
            sys1, sys2, gold, key, num_samples=300, seed=7)


@pytest.fixture(scope="module")
def small_vocab():
    return build_synthetic_vocab(size=400, cjk_chars=300)


def test_dataset_labels_and_prediction_files_match_jax(small_vocab, tmp_path):
    """Gold lines from src/tgt, and the prediction text and label files of
    Metric.metric (with and without remove_de), on a seeded dataset with
    seeded predictions."""
    tok = WordPieceTokenizer(vocab_to_dict(small_vocab))
    jtok = JaxTokenizer(vocab_to_dict(small_vocab))
    data = synthetic_dataset(tok, num_examples=30, seed=4)
    assert dataset_labels(data) == jax_dataset_labels(data)
    rng = np.random.RandomState(5)
    cfg = config_for("bert-pho2-res-arch3", vocab_size=len(small_vocab))
    host = Featurizer(tok, RealiseConfig.from_dict(cfg.to_dict())).featurize(data)
    host["pred_idx"] = np.where(rng.rand(*host["src_idx"].shape) < 0.2,
                                rng.randint(0, len(small_vocab),
                                            host["src_idx"].shape),
                                host["src_idx"])
    gold = _write(tmp_path / "gold", dataset_labels(data))
    for rd in (False, True):
        ours = Metric(tok).metric([host], str(tmp_path / f"o{rd}.txt"),
                                  str(tmp_path / f"o{rd}.lbl"), gold, rd)
        theirs = JaxMetric(jtok).metric([host], str(tmp_path / f"j{rd}.txt"),
                                        str(tmp_path / f"j{rd}.lbl"), gold, rd)
        assert ours == theirs
        for ext in ("txt", "lbl"):
            assert ((tmp_path / f"o{rd}.{ext}").read_bytes()
                    == (tmp_path / f"j{rd}.{ext}").read_bytes())


@pytest.mark.parametrize("year13", [False, True])
def test_evaluate_model_matches_jax(small_vocab, tmp_path, caplog, year13):
    """evaluate_model of the port's Trainer (kernels' plain versions on the
    CPU) and of the JAX Trainer (interpret-mode Pallas) over the same
    carried weights, 70 sentences in batches of 32 (a short last batch):
    the same prediction and label files and the same metrics, the average
    loss within 1e-5. ``year13``: remove_de on both sides of a provided
    label file, the count of dropped edits logged."""
    cfg = config_for("bert-pho2-res-arch3", vocab_size=len(small_vocab),
                     hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                     intermediate_size=32, pho_num_layers=1, out_num_layers=1,
                     max_seq_length=32, max_position_embeddings=32, num_fonts=1)
    pcfg = RealiseConfig.from_dict(cfg.to_dict())
    rng = np.random.RandomState(0)
    glyphs = (rng.rand(len(small_vocab), 1, 32, 32) > 0.5).astype(np.float32)
    params, state = init_realise(jax.random.PRNGKey(0), cfg, glyphs=glyphs)
    params = jax.tree.map(
        lambda x: np.asarray(x) + rng.normal(0, 0.5, np.shape(x)).astype(np.float32),
        params)
    state = jax.tree.map(np.asarray, state)
    tok = WordPieceTokenizer(vocab_to_dict(small_vocab))
    jtok = JaxTokenizer(vocab_to_dict(small_vocab))
    data = synthetic_dataset(tok, num_examples=70, seed=11)
    label, dropped = None, 0
    if year13:
        given = [ln.replace(", 0", ", 3, 地") if i % 3 == 0 else ln
                 for i, ln in enumerate(jax_dataset_labels(data))]
        label = _write(tmp_path / "given.lbl", given)
        dropped = sum(c in ("地", "得") for ln in given
                      for _, c in jcore.parse_label_line(ln)[1])
        assert dropped > 0
    model = trealise.Realise(pcfg)
    model.load_state_dict(state_dict_from_jax(params, state, pcfg))
    ours_t = Trainer(pcfg, model, use_kernels=True, device="cpu")
    jt = JaxTrainer(cfg, jax.tree.map(jnp.asarray, params),
                    jax.tree.map(jnp.asarray, state), use_pallas=True)
    with caplog.at_level(logging.INFO, logger="realise_tpu_torch"):
        ours = tcommon.evaluate_model(ours_t, data, Featurizer(tok, pcfg), tok,
                                      str(tmp_path / "o"), prefix="dev",
                                      label_path=label, should_remove_de=year13)
    theirs = jax_evaluate_model(jt, data, JaxFeaturizer(jtok, cfg), jtok,
                                str(tmp_path / "j"), prefix="dev",
                                label_path=label, should_remove_de=year13)
    assert set(ours) == set(theirs)
    for k in ours:
        if k == "avg_loss":
            np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-5)
        else:
            assert ours[k] == theirs[k], k
    files = sorted(os.listdir(tmp_path / "j" / "dev"))
    assert sorted(os.listdir(tmp_path / "o" / "dev")) == files
    for name in files:
        assert ((tmp_path / "o" / "dev" / name).read_bytes()
                == (tmp_path / "j" / "dev" / name).read_bytes()), name
    logged = [r.getMessage() for r in caplog.records
              if "remove_de dropped" in r.getMessage()]
    assert logged == ([f"remove_de dropped {dropped} 地/得 edits from the label file "
                       f"{label} (scored as "
                       f"{tmp_path / 'o' / 'dev' / 'gold.remove_de.lbl.tsv'})"]
                      if year13 else [])


def test_cli_train_eval_predict_then_test(tmp_path):
    """cli/train --do_train --do_eval --do_predict on the CPU scores every
    saved checkpoint on dev and predicts with the best; cli/test scores the
    latest checkpoint (year 13: with remove_de)."""
    out = tmp_path / "out"
    assert ttrain.main(["--synthetic", "--tiny", "--max_steps", "2",
                        "--save_steps", "1", "--do_train", "--do_eval",
                        "--do_predict", "--device", "cpu", "--output_dir",
                        str(out), "--per_device_train_batch_size", "4",
                        "--no_prefetch"]) == 0
    assert [s for s, _ in list_checkpoints(str(out))] == [1, 2]
    dev = json.loads((out / "dev_results.json").read_text())
    assert set(dev) == {"1", "2"}
    for res in dev.values():
        assert all(np.isfinite(v) for v in res.values())
        assert {"sent-detect-f1", "sent-correct-f1", "avg_loss"} <= set(res)
    pred = json.loads((out / "predict_results.json").read_text())
    assert set(pred) == set(dev["1"])
    for d in ("eval-1", "eval-2", "predict"):
        assert {"preds.txt", "labels.txt", "gold.lbl.tsv"} <= set(
            os.listdir(out / d))
    assert ttest.main(["--ckpt_dir", str(out), "--synthetic", "--device",
                       "cpu", "--testset_year", "13"]) == 0
    res = json.loads((out / "test_output" / "test_results.json").read_text())
    assert set(res) == set(pred) and all(np.isfinite(v) for v in res.values())
    assert "gold.remove_de.lbl.tsv" in os.listdir(
        out / "test_output" / "sighan13")


def test_cli_test_device_and_checkpoint_rules(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="no checkpoints"):
        ttest.main(["--ckpt_dir", str(tmp_path), "--synthetic", "--device",
                    "cpu"])
    with pytest.raises(SystemExit, match="item 2"):
        ttrain.main(["--synthetic", "--output_dir", str(tmp_path),
                     "--remove_unused_ckpts"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttest.main(["--ckpt_dir", str(tmp_path), "--synthetic"])
