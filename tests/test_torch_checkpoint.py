"""The port's checkpoints with optimizer state against the JAX package's:
the save/load round trip, a resumed Trainer against an uninterrupted one,
``cli/train --resume`` and ``--init_ckpt``, ``retain_top_k`` and
``training_args.json``."""

import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from realise_tpu.cli import train as jtrain
from realise_tpu.config import PHO2_VOCAB_SIZE, config_for
from realise_tpu.training.checkpoint import retain_top_k as jax_retain_top_k
from realise_tpu_torch.cli import train as ttrain
from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.models.realise import Realise
from realise_tpu_torch.training import checkpoint as tckpt
from realise_tpu_torch.training.trainer import Trainer

V, B, S = 80, 4, 10
# Dropout 0.1 at both sites: a resume that loses the generator's state
# trains on other masks, and the bit checks below see it.
CFG = config_for("bert-pho2-res-arch3", vocab_size=V, hidden_size=16,
                 num_hidden_layers=1, num_attention_heads=2,
                 intermediate_size=32, pho_num_layers=1, out_num_layers=1,
                 max_seq_length=16, max_position_embeddings=16, num_fonts=1,
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
PCFG = RealiseConfig.from_dict(CFG.to_dict())
TRAINER_KW = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                  weight_decay=0.01, max_grad_norm=1.0, device="cpu", seed=5)
CLI = ["--synthetic", "--tiny", "--device", "cpu", "--no_prefetch",
       "--per_device_train_batch_size", "96", "--save_steps", "2"]


def _batch(seed):
    r = np.random.RandomState(seed)
    masks = np.ones((B, S), np.int32)
    masks[1, 6:] = 0
    loss_masks = masks.copy()
    loss_masks[:, 0] = 0
    return {"src_idx": r.randint(0, V, (B, S)).astype(np.int32),
            "tgt_idx": r.randint(0, V, (B, S)).astype(np.int32),
            "masks": masks, "loss_masks": loss_masks,
            "pho_idx": r.randint(1, PHO2_VOCAB_SIZE, (B, S, 8)).astype(np.int32),
            "pho_lens": r.randint(0, 9, (B, S)).astype(np.int32)}


def _model(seed):
    model = Realise(PCFG, generator=torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    model.install_glyphs((rng.rand(V, 1, 32, 32) > 0.5).astype(np.float32))
    return model


def _assert_states_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k].cpu()), k


def _assert_nested_equal(got, want, path="state"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_nested_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_nested_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want), path
    else:
        assert got == want, path


def test_save_load_round_trip(tmp_path):
    """Model, optimizer, step, generator state, config and arguments come
    back equal; every file is in place and no temporary is left."""
    tr = Trainer(PCFG, _model(0), **TRAINER_KW)
    tr.train_step(_batch(1))
    args = {"learning_rate": 1e-3, "output_dir": str(tmp_path), "seed": 5}
    path = tckpt.save_checkpoint(str(tmp_path), tr.step, tr.model.state_dict(),
                                 PCFG, trainer_state=tr.state_dict(),
                                 training_args=args)
    assert sorted(os.listdir(path)) == ["config.json", "model.pt",
                                        "trainer.pt", "training_args.json"]
    _assert_states_equal(tckpt.load_checkpoint(path), tr.model.state_dict())
    state = tckpt.load_trainer_state(path)
    _assert_nested_equal(state, tr.state_dict())
    assert state["step"] == 1 and state["optimizer"]["state"]
    assert tckpt.load_config(path) == PCFG
    assert tckpt.load_training_args(path) == args

    fresh = Trainer(PCFG, _model(1), **TRAINER_KW)
    fresh.load_state_dict(state)
    assert fresh.step == 1
    assert torch.equal(fresh.generator.get_state(), tr.generator.get_state())
    _assert_nested_equal(fresh.optimizer.state_dict(), tr.optimizer.state_dict())


def test_serving_checkpoint_has_no_trainer_state(tmp_path):
    path = tckpt.save_checkpoint(str(tmp_path), 3, _model(0).state_dict(), PCFG)
    assert sorted(os.listdir(path)) == ["config.json", "model.pt"]
    with pytest.raises(FileNotFoundError, match="trainer.pt"):
        tckpt.load_trainer_state(path)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_resume_equals_uninterrupted_run(tmp_path, use_kernels):
    """4 steps straight against 2 steps, a checkpoint, a fresh Trainer
    (other initial weights, other generator seed) loaded from it and 2
    more steps: the loss trace, every parameter and every buffer are the
    same bits. The same resume without the generator's state trains on
    other dropout masks and differs."""
    batches = [_batch(10 + i) for i in range(4)]
    kw = dict(TRAINER_KW, use_kernels=use_kernels)
    straight = Trainer(PCFG, _model(0), **kw)
    want = [float(straight.train_step(b)) for b in batches]

    first = Trainer(PCFG, _model(0), **kw)
    got = [float(first.train_step(b)) for b in batches[:2]]
    path = tckpt.save_checkpoint(str(tmp_path), first.step,
                                 first.model.state_dict(), PCFG,
                                 trainer_state=first.state_dict())

    def resumed(restore_generator):
        tr = Trainer(PCFG, _model(1), **dict(kw, seed=99))
        tr.model.load_state_dict(tckpt.load_checkpoint(path))
        state = tckpt.load_trainer_state(path)
        if not restore_generator:
            state = dict(state, generator=tr.generator.get_state())
        tr.load_state_dict(state)
        return tr, [float(tr.train_step(b)) for b in batches[2:]]

    second, tail = resumed(True)
    assert second.step == straight.step == 4
    assert got + tail == want
    _assert_states_equal(second.model.state_dict(), straight.model.state_dict())
    _assert_nested_equal(second.optimizer.state_dict(),
                         straight.optimizer.state_dict())

    lost, lost_tail = resumed(False)
    assert lost_tail != tail
    assert any(not torch.equal(p, q) for p, q in
               zip(lost.model.parameters(), straight.model.parameters()))


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """cli/train 4 steps straight, and 2 steps then --resume to 4, with a
    batch of 96 of the 256 synthetic sentences: 3 steps an epoch, so the
    resume skips 2 batches of epoch 0 and step 4 is epoch 1's first."""
    root = tmp_path_factory.mktemp("cli_resume")
    straight, resumed = str(root / "straight"), str(root / "resumed")
    assert ttrain.main(CLI + ["--output_dir", straight, "--max_steps", "4"]) == 0
    assert ttrain.main(CLI + ["--output_dir", resumed, "--max_steps", "2"]) == 0
    assert ttrain.main(CLI + ["--output_dir", resumed, "--max_steps", "4",
                              "--resume"]) == 0
    return straight, resumed


def test_cli_resume_equals_straight_run(cli_runs):
    straight, resumed = cli_runs
    assert [s for s, _ in tckpt.list_checkpoints(resumed)] == [2, 4]
    want = os.path.join(straight, "saved_ckpt-4")
    got = os.path.join(resumed, "saved_ckpt-4")
    _assert_states_equal(tckpt.load_checkpoint(got), tckpt.load_checkpoint(want))
    _assert_nested_equal(tckpt.load_trainer_state(got),
                         tckpt.load_trainer_state(want))
    assert tckpt.load_trainer_state(got)["step"] == 4


def test_training_args_match_the_jax_cli(cli_runs):
    """training_args.json holds vars(args) with the JAX CLI's keys and, for
    the same argv, its values. The port's device flags replace the JAX
    platform flags (--device, --no_kernels for --platform, --use_pallas);
    --remat is a JAX rematerialization option the port does not take."""
    straight, _ = cli_runs
    argv = CLI + ["--output_dir", straight, "--max_steps", "4"]
    ours = tckpt.load_training_args(os.path.join(straight, "saved_ckpt-4"))
    jargv = [a for a in argv if a not in ("--device", "cpu")]
    theirs = json.loads(json.dumps(vars(jtrain.build_parser().parse_args(jargv)),
                                   default=str))
    theirs["do_train"] = True  # both CLIs default to training
    assert set(ours) - set(theirs) == {"device", "no_kernels"}
    assert set(theirs) - set(ours) == {"platform", "use_pallas", "remat"}
    # --mesh and --distributed too: None and False, as in the JAX CLI.
    shared = set(ours) & set(theirs)
    assert {"mesh", "distributed"} <= shared
    assert {k: ours[k] for k in shared} == {k: theirs[k] for k in shared}


def test_cli_resume_after_a_crash_mid_save(cli_runs, tmp_path, monkeypatch):
    """A run killed while writing saved_ckpt-4's trainer.pt leaves no
    saved_ckpt-4: --resume continues from saved_ckpt-2 and reaches the
    straight run's step-4 checkpoint."""
    straight, resumed = cli_runs
    out = str(tmp_path / "crashed")
    shutil.copytree(os.path.join(resumed, "saved_ckpt-2"),
                    os.path.join(out, "saved_ckpt-2"))
    save = torch.save

    def crash_at_trainer_file(obj, path, *a, **kw):
        if os.path.basename(path) == tckpt.TRAINER_FILE:
            raise RuntimeError("simulated crash")
        return save(obj, path, *a, **kw)

    monkeypatch.setattr(torch, "save", crash_at_trainer_file)
    argv = CLI + ["--output_dir", out, "--max_steps", "4", "--resume"]
    with pytest.raises(RuntimeError, match="simulated crash"):
        ttrain.main(argv)
    assert [s for s, _ in tckpt.list_checkpoints(out)] == [2]
    assert os.path.isfile(os.path.join(out, "saved_ckpt-4.tmp", tckpt.MODEL_FILE))

    monkeypatch.setattr(torch, "save", save)
    assert ttrain.main(argv) == 0
    assert [s for s, _ in tckpt.list_checkpoints(out)] == [2, 4]
    assert not os.path.exists(os.path.join(out, "saved_ckpt-4.tmp"))
    got = os.path.join(out, "saved_ckpt-4")
    want = os.path.join(straight, "saved_ckpt-4")
    _assert_states_equal(tckpt.load_checkpoint(got), tckpt.load_checkpoint(want))
    _assert_nested_equal(tckpt.load_trainer_state(got),
                         tckpt.load_trainer_state(want))


def test_cli_init_ckpt_starts_from_its_weights(cli_runs, tmp_path, monkeypatch):
    """--init_ckpt: the Trainer starts at step 0 with a fresh optimizer
    from the checkpoint's weights, BN statistics and glyphs."""
    straight, _ = cli_runs
    init = os.path.join(straight, "saved_ckpt-4")
    seen = {}

    def fit(self, batches, **kw):
        seen["state"] = {k: v.clone() for k, v in self.model.state_dict().items()}
        seen["step"] = self.step
        seen["moments"] = len(self.optimizer.state)
        return {"steps": self.step}

    monkeypatch.setattr(Trainer, "fit", fit)
    out = str(tmp_path / "init")
    assert ttrain.main(CLI + ["--output_dir", out, "--max_steps", "4",
                              "--init_ckpt", init]) == 0
    assert seen["step"] == 0 and seen["moments"] == 0
    _assert_states_equal(seen["state"], tckpt.load_checkpoint(init))
    assert [s for s, _ in tckpt.list_checkpoints(out)] == [0]


def test_cli_resume_without_trainer_state_raises(tmp_path):
    """A checkpoint without trainer.pt (a serving one) cannot be resumed
    from: the moments are never restarted quietly."""
    out = str(tmp_path / "out")
    tckpt.save_checkpoint(out, 2, _model(0).state_dict(), PCFG)
    with pytest.raises(FileNotFoundError, match="trainer.pt"):
        ttrain.main(CLI + ["--output_dir", out, "--max_steps", "4", "--resume"])


NAN = float("nan")


@pytest.mark.parametrize("reverse", [True, False])
@pytest.mark.parametrize("scores, k", [
    ([0.5, NAN, 0.9, 0.1], 2),          # a NaN among the scores
    ([NAN, NAN, 0.3], 1),                # NaNs first
    ([0.4, 0.4, 0.2, 0.4], 2),           # ties
    ([0.7, 0.1], 5),                     # k >= len
    ([0.2, NAN, 0.8], 0),                # keep nothing
    ([3, 1, 2], 2),                      # integer scores
], ids=["nan", "nans-first", "ties", "k-ge-len", "k0", "ints"])
def test_retain_top_k_matches_jax(tmp_path, scores, k, reverse):
    """The same kept dirs, best first, and the same dirs deleted."""
    def scored_dirs(root):
        out = []
        for i, score in enumerate(scores):
            d = root / f"saved_ckpt-{i}"
            d.mkdir(parents=True)
            out.append((str(d), score))
        return out

    ours = tckpt.retain_top_k(scored_dirs(tmp_path / "port"), k, reverse=reverse)
    theirs = jax_retain_top_k(scored_dirs(tmp_path / "jax"), k, reverse=reverse)
    assert [os.path.basename(d) for d in ours] == \
        [os.path.basename(d) for d in theirs]
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))
    kept = [scores[int(os.path.basename(d).split("-")[1])] for d in ours]
    finite = [s for s in scores if not math.isnan(s)]
    assert sum(not math.isnan(s) for s in kept) == min(k, len(finite))


def test_cli_eval_keeps_the_best_checkpoints(tmp_path):
    """--do_eval --remove_unused_ckpts --num_save_ckpts 1 keeps one
    checkpoint: the best by the order metric in dev_results.json."""
    out = str(tmp_path / "out")
    assert ttrain.main(CLI + ["--output_dir", out, "--max_steps", "4",
                              "--do_train", "--do_eval",
                              "--remove_unused_ckpts",
                              "--num_save_ckpts", "1",
                              "--eval_batch_size", "64"]) == 0
    with open(os.path.join(out, "dev_results.json")) as f:
        results = json.load(f)
    assert sorted(results, key=int) == ["2", "4"]
    best = max(results, key=lambda s: results[s]["sent-detect-f1"])
    assert [str(s) for s, _ in tckpt.list_checkpoints(out)] == [best]
