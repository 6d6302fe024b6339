"""The port's pretraining CLIs (cli/pretrain_pho, cli/pretrain_res,
cli/merge, cli/exprun, cli/train --pho_ckpt/--res_ckpt) against the JAX
package's: the dev accuracies on carried weights, the grid expander's
files, and the reference's recipe end to end on the CPU (pretrain_pho.sh,
pretrain_res.sh, merge.py, train.sh, test.sh)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from realise_tpu.cli import exprun as jexprun
from realise_tpu.cli.pretrain_pho import token_accuracy as j_token_accuracy
from realise_tpu.config import config_for
from realise_tpu.data.features import Featurizer as JFeaturizer
from realise_tpu.models.realise import init_pretrain
from realise_tpu.text.tokenizer import WordPieceTokenizer as JTokenizer
from realise_tpu.training.trainer import Trainer as JTrainer
from realise_tpu_torch.cli import exprun, merge, pretrain_pho, pretrain_res
from realise_tpu_torch.cli import test as ttest
from realise_tpu_torch.cli import train as ttrain
from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.data.dataset import synthetic_dataset
from realise_tpu_torch.data.features import Featurizer
from realise_tpu_torch.models.convert import state_dict_from_jax
from realise_tpu_torch.models.realise import RealisePretrain
from realise_tpu_torch.text.tokenizer import WordPieceTokenizer
from realise_tpu_torch.text.vocab import build_synthetic_vocab, vocab_to_dict
from realise_tpu_torch.training import checkpoint as tckpt
from realise_tpu_torch.training.merge import merge_state_dicts
from realise_tpu_torch.training.trainer import Trainer
from torch_port_fixtures import live_glyph_features, live_glyph_rows

SMALL = dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
             intermediate_size=32, pho_num_layers=1, max_seq_length=12,
             max_position_embeddings=16, num_fonts=1)


@pytest.fixture(scope="module")
def small_vocab():
    return build_synthetic_vocab(size=400, cjk_chars=300)


def _noisy(tree, rng, scale):
    return jax.tree.map(lambda x: np.asarray(x) + rng.normal(
        0, scale, np.shape(x)).astype(np.float32), tree)


def test_token_accuracy_matches_jax(small_vocab):
    """token_accuracy of the port and of the JAX CLI on carried weights:
    the same accuracy and mean loss, and the same at batch 8 (8 + a ragged
    2) and 16 (one ragged batch): padded rows count nowhere."""
    cfg = config_for("pho2-pretrain", vocab_size=len(small_vocab), **SMALL)
    pcfg = RealiseConfig.from_dict(cfg.to_dict())
    tok = WordPieceTokenizer(vocab_to_dict(small_vocab))
    jtok = JTokenizer(vocab_to_dict(small_vocab))
    feat, jfeat = Featurizer(tok, pcfg), JFeaturizer(jtok, cfg)
    params, state = init_pretrain(jax.random.PRNGKey(0), cfg,
                                  pho_tables=jfeat.pho2_tables())
    params = _noisy(params, np.random.RandomState(0), 0.3)
    model = RealisePretrain(pcfg)
    model.load_state_dict(state_dict_from_jax(params, state, pcfg))
    model.install_pho_vocab_tables(*feat.pho2_tables())
    ours_t = Trainer(pcfg, model, device="cpu")
    theirs_t = JTrainer(cfg, params, state, pretrain=True)
    data = synthetic_dataset(tok, num_examples=10, seed=2)
    got = [pretrain_pho.token_accuracy(ours_t, data, feat, batch_size=bs)
           for bs in (8, 16)]
    want = j_token_accuracy(theirs_t, data, jfeat, batch_size=8)
    for res in got:
        assert res["accuracy"] == want["accuracy"]
        np.testing.assert_allclose(res["avg_loss"], want["avg_loss"], rtol=1e-5)


def _jax_char_accuracy(trainer, char_ids, batch_size):
    """The JAX CLI's eval loop (realise_tpu/cli/pretrain_res.py:106-121)."""
    correct = 0
    for i in range(0, len(char_ids), batch_size):
        chunk = char_ids[i:i + batch_size]
        n = len(chunk)
        if n < batch_size:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], batch_size - n)])
        preds = np.asarray(trainer.eval_step({"char_idx": chunk})["pred_idx"])
        correct += int((preds.reshape(-1)[:n] == chunk[:n]).sum())
    return correct / max(len(char_ids), 1)


def test_char_accuracy_matches_jax(small_vocab):
    """The res stage's accuracy over every CJK char of the vocab, port and
    JAX CLI on carried weights, with a ragged last batch (300 chars in
    batches of 64 and 128). The head is set to each char's centred,
    normalized glyph features (the other tokens' logits far below), so
    that the chars whose features no other char shares are classified
    right (the tiny CharResNet maps the 300 glyphs to 76 distinct feature
    rows) and the padded duplicates of the last batch would show in the
    count."""
    cfg = config_for("res-pretrain", vocab_size=len(small_vocab), **SMALL)
    pcfg = RealiseConfig.from_dict(cfg.to_dict())
    feat = Featurizer(WordPieceTokenizer(vocab_to_dict(small_vocab)), pcfg)
    char_ids = np.nonzero(feat.cjk_token_mask())[0]
    assert len(char_ids) == 300
    rng = np.random.RandomState(1)
    glyphs = (rng.rand(len(small_vocab), 1, 32, 32) > 0.5).astype(np.float32)
    params, state = init_pretrain(jax.random.PRNGKey(0), cfg, glyphs=glyphs)
    params = live_glyph_features(_noisy(params, rng, 0.05))
    state = jax.tree.map(np.asarray, state)
    model = RealisePretrain(pcfg)
    model.load_state_dict(state_dict_from_jax(params, state, pcfg))
    assert live_glyph_rows(model) == len(small_vocab)
    with torch.inference_mode():
        f = model.res_features(torch.as_tensor(char_ids)).numpy()
    centred = f - f.mean(0)
    unit = centred / np.linalg.norm(centred, axis=1, keepdims=True)
    kernel = np.zeros_like(params["head"]["classifier"]["kernel"])
    bias = np.full_like(params["head"]["classifier"]["bias"], -100.0)
    kernel[:, char_ids] = unit.T
    bias[char_ids] = -(f.mean(0) @ unit.T)
    params["head"]["classifier"] = {"kernel": kernel, "bias": bias}
    model.load_state_dict(state_dict_from_jax(params, state, pcfg))
    ours_t = Trainer(pcfg, model, device="cpu")
    theirs_t = JTrainer(cfg, params, state, pretrain=True)
    want = _jax_char_accuracy(theirs_t, char_ids, 64)
    assert 0.2 < want < 1.0
    for bs in (64, 128):
        assert pretrain_res.char_accuracy(ours_t, char_ids, bs) == want


@pytest.mark.parametrize("fmt", ["json", "yaml"])
def test_exprun_writes_the_jax_tree(tmp_path, monkeypatch, fmt):
    """The same spec gives the same run.sh files (byte for byte, mode
    included) and the same manifest.json as the JAX package's."""
    spec = {"command": "python -m realise_tpu_torch.cli.train --model_type "
                       "{model_type} --learning_rate {lr} --output_dir {__name__}",
            "params": [{"name": "model_type",
                        "values": ["bert", "bert-pho2-res-arch3"]},
                       {"name": "lr", "values": [5e-5, 3e-5]}],
            "target_dir": "experiments"}
    trees = {}
    for name, main in (("ours", exprun.main), ("theirs", jexprun.main)):
        root = tmp_path / name
        root.mkdir()
        path = root / f"spec.{fmt}"
        if fmt == "json":
            path.write_text(json.dumps(spec))
        else:
            import yaml

            path.write_text(yaml.safe_dump(spec))
        monkeypatch.chdir(root)
        assert main(["--config", str(path)]) == 0
        trees[name] = {str(f.relative_to(root)): (f.read_bytes(),
                                                   f.stat().st_mode)
                       for f in (root / "experiments").rglob("*")
                       if f.is_file()}
    assert len(trees["ours"]) == 5
    assert trees["ours"] == trees["theirs"]


def test_pretraining_recipe_on_the_cpu(tmp_path, small_vocab, monkeypatch):
    """pretrain_pho → pretrain_res → merge → train --init_ckpt merged →
    test, and train --init_ckpt base --pho_ckpt --res_ckpt: the merged
    checkpoint holds the stages' encoders and the base's rest, both
    fine-tuning runs start from the same bits and end on the same bits
    with the same dev scores."""
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(small_vocab) + "\n", encoding="utf-8")
    common = ["--synthetic", "--tiny", "--device", "cpu", "--seed", "7",
              "--vocab_path", str(vocab)]
    d = {n: str(tmp_path / n) for n in ("pho", "res", "base", "merged",
                                        "ft_merged", "ft_overlay")}
    assert pretrain_pho.main(common + [
        "--output_dir", d["pho"], "--max_steps", "2", "--save_steps", "0",
        "--warmup_steps", "1", "--logging_steps", "1",
        "--per_device_train_batch_size", "4"]) == 0
    with open(os.path.join(d["pho"], "dev_results.json")) as f:
        assert set(json.load(f)) == {"accuracy", "avg_loss"}
    assert pretrain_res.main(common + [
        "--output_dir", d["res"], "--max_steps", "2",
        "--per_device_train_batch_size", "32"]) == 0
    with open(os.path.join(d["res"], "dev_results.json")) as f:
        assert 0.0 <= json.load(f)["accuracy"] <= 1.0
    assert ttrain.main(common + [
        "--output_dir", d["base"], "--max_steps", "1", "--save_steps", "0",
        "--warmup_steps", "1", "--per_device_train_batch_size", "4"]) == 0
    assert merge.main(["--base_ckpt", d["base"], "--pho_ckpt", d["pho"],
                       "--res_ckpt", d["res"], "--output_dir", d["merged"],
                       "--device", "cpu"]) == 0

    ckpt = {n: tckpt.list_checkpoints(d[n])[-1][1]
            for n in ("pho", "res", "base", "merged")}
    merged = tckpt.load_checkpoint(ckpt["merged"])
    want = merge_state_dicts(*(tckpt.load_checkpoint(ckpt[n])
                               for n in ("base", "pho", "res")))
    assert set(merged) == set(want)
    assert all(torch.equal(merged[k], v) for k, v in want.items())
    assert tckpt.load_training_args(ckpt["merged"])["merged_from"] == {
        "base": ckpt["base"], "pho": d["pho"], "res": d["res"]}
    assert tckpt.load_config(ckpt["merged"]).model_type == "bert-pho2-res-arch3"
    base = tckpt.load_checkpoint(ckpt["base"])
    pho = tckpt.load_checkpoint(ckpt["pho"])
    assert torch.equal(merged["pho_gru.weight_ih_l0"], pho["pho_gru.weight_ih_l0"])
    assert not torch.equal(merged["pho_gru.weight_ih_l0"],
                           base["pho_gru.weight_ih_l0"])
    assert torch.equal(merged["bert.embeddings.word_embeddings.weight"],
                       base["bert.embeddings.word_embeddings.weight"])

    starts = {}
    fit = Trainer.fit

    def recording_fit(self, batches, **kw):
        starts[len(starts)] = {k: v.clone()
                               for k, v in self.model.state_dict().items()}
        return fit(self, batches, **kw)

    monkeypatch.setattr(Trainer, "fit", recording_fit)
    ft = ["--max_steps", "2", "--save_steps", "2", "--warmup_steps", "1",
          "--do_train", "--do_eval", "--per_device_train_batch_size", "4"]
    assert ttrain.main(common + ft + ["--output_dir", d["ft_merged"],
                                      "--init_ckpt", ckpt["merged"]]) == 0
    assert ttrain.main(common + ft + ["--output_dir", d["ft_overlay"],
                                      "--init_ckpt", ckpt["base"],
                                      "--pho_ckpt", ckpt["pho"],
                                      "--res_ckpt", ckpt["res"]]) == 0
    for k, v in merged.items():
        assert torch.equal(starts[0][k], v) and torch.equal(starts[1][k], v), k
    ends = [tckpt.load_checkpoint(os.path.join(d[n], "saved_ckpt-2"))
            for n in ("ft_merged", "ft_overlay")]
    assert all(torch.equal(ends[0][k], ends[1][k]) for k in ends[0])
    scores = []
    for n in ("ft_merged", "ft_overlay"):
        with open(os.path.join(d[n], "dev_results.json")) as f:
            scores.append(json.load(f))
    assert scores[0] == scores[1]
    assert ttest.main(["--ckpt_dir", d["ft_merged"], "--synthetic",
                       "--vocab_path", str(vocab), "--device", "cpu"]) == 0
    with open(os.path.join(d["ft_merged"], "test_output",
                           "test_results.json")) as f:
        assert "sent-correct-f1" in json.load(f)


def test_pretraining_entry_points_need_a_device(tmp_path, monkeypatch):
    """Without CUDA and without --device, each entry point raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = ["--output_dir", str(tmp_path / "x")]
    for main, argv in (
            (pretrain_pho.main, ["--synthetic", "--tiny", "--max_steps", "1"]),
            (pretrain_res.main, ["--synthetic", "--tiny", "--max_steps", "1"]),
            (merge.main, ["--base_ckpt", str(tmp_path)]),
            (ttrain.main, ["--synthetic", "--tiny", "--max_steps", "1",
                           "--res_ckpt", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv + out)
