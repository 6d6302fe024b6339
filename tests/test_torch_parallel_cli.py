"""The port's CLIs under two ranks of a gloo group on the CPU, launched as
torchrun launches them (``env://`` from MASTER_ADDR/MASTER_PORT,
WORLD_SIZE, RANK and LOCAL_RANK; tests/torch_parallel_workers.cli):
``cli/train --distributed --mesh data=2`` (a straight run with
``--do_eval --do_predict``, a run cut at step 2 and its ``--resume``, a run
at dropout 0), then ``cli/test --mesh data=2`` and both pretraining CLIs.
The run at dropout 0 is held to one process that takes the same update
batch as two microbatches: each rank's BatchNorm batch statistics are those
of its own rows, as each microbatch's are, so the loss trace is the same
function (within 1e-5, the summation order aside).
"""

import contextlib
import os

import numpy as np
import portpicker
import pytest
import torch

from realise_tpu_torch.cli import pretrain_pho, pretrain_res
from realise_tpu_torch.cli import test as ttest
from realise_tpu_torch.cli import train as ttrain
from realise_tpu_torch.training import checkpoint as tckpt
from realise_tpu_torch.training.trainer import Trainer
from torch_port_fixtures import one_intra_op_thread
from torch_parallel_workers import start_ranks, wait_ranks

COMMON = ["--synthetic", "--tiny", "--device", "cpu", "--no_prefetch",
          "--logging_steps", "1", "--seed", "3"]


@contextlib.contextmanager
def recorded_losses():
    losses = []
    step = Trainer.train_step

    def train_step(self, batch):
        loss = step(self, batch)
        losses.append(float(loss))
        return loss

    Trainer.train_step = train_step
    try:
        yield losses
    finally:
        Trainer.train_step = step


@pytest.fixture(scope="module")
def cli_ranks(tmp_path_factory):
    """Both ranks' recorded runs and their output dirs, and the loss trace
    of one process at dropout 0 (per-device batch 2, two microbatches),
    run while the ranks run."""
    work = str(tmp_path_factory.mktemp("cli_ranks"))
    with open(os.path.join(work, "port"), "w") as f:
        f.write(str(portpicker.pick_unused_port()))
    procs = start_ranks("cli", work)
    try:
        build_config = ttrain.build_config
        ttrain.build_config = lambda *a: build_config(*a).replace(
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
        try:
            with one_intra_op_thread(), recorded_losses() as one_process:
                assert ttrain.main(COMMON + [
                    "--per_device_train_batch_size", "2",
                    "--gradient_accumulation_steps", "2", "--max_steps", "4",
                    "--save_steps", "0", "--output_dir",
                    os.path.join(work, "one_process")]) == 0
        finally:
            ttrain.build_config = build_config
    finally:
        wait_ranks(procs)
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    return ranks, one_process, work


def test_only_rank0_writes_checkpoints(cli_ranks):
    ranks, _, work = cli_ranks
    assert ranks[1]["writes"] == []
    want = [os.path.join(d, f"saved_ckpt-{s}") for d, s in (
        ("straight", 2), ("straight", 4), ("resumed", 2), ("resumed", 4),
        ("no_dropout", 4), ("pho", 2), ("res", 2))]
    assert sorted(set(ranks[0]["writes"])) == sorted(want)
    for d in ("straight", "resumed"):
        assert [s for s, _ in tckpt.list_checkpoints(
            os.path.join(work, d))] == [2, 4]


def test_ranks_share_the_loss_trace(cli_ranks):
    ranks, _, _ = cli_ranks
    for name in ("straight", "cut", "resumed", "no_dropout", "pretrain_pho",
                 "pretrain_res"):
        trace = ranks[0][name]
        assert trace == ranks[1][name], name
        assert len(trace) in (2, 4) and np.isfinite(trace).all(), name


def test_loss_trace_matches_one_process(cli_ranks):
    ranks, one_process, _ = cli_ranks
    assert len(one_process) == 4
    np.testing.assert_allclose(ranks[0]["no_dropout"], one_process, atol=1e-5)


def test_resume_is_bitwise(cli_ranks):
    """The run cut at step 2 and resumed (dropout 0.1) writes the straight
    run's step-4 checkpoint, weights and trainer state, bit for bit."""
    ranks, _, work = cli_ranks
    assert ranks[0]["cut"] + ranks[0]["resumed"] == ranks[0]["straight"]
    got, want = (os.path.join(work, d, "saved_ckpt-4")
                 for d in ("resumed", "straight"))
    a, b = tckpt.load_checkpoint(got), tckpt.load_checkpoint(want)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    ta, tb = tckpt.load_trainer_state(got), tckpt.load_trainer_state(want)
    assert ta["step"] == tb["step"] == 4
    assert torch.equal(ta["generator"], tb["generator"])
    for pa, pb in zip(ta["optimizer"]["state"].values(),
                      tb["optimizer"]["state"].values()):
        assert all(torch.equal(pa[k], pb[k]) for k in pa)


@pytest.mark.parametrize("prefix", ["straight/eval-2", "straight/eval-4",
                                    "straight/predict",
                                    "straight/test_output/sighan15"])
def test_rank1_scores_into_its_own_files(cli_ranks, prefix):
    """Every rank scores the gathered predictions alike; rank 1 writes its
    files with a .p1 suffix, and rank 0 alone the result files."""
    _, _, work = cli_ranks
    d = os.path.join(work, prefix)
    for name in ("preds.txt", "labels.txt", "gold.lbl.tsv"):
        with open(os.path.join(d, name), encoding="utf-8") as f:
            mine = f.read()
        with open(os.path.join(d, name + ".p1"), encoding="utf-8") as f:
            assert f.read() == mine, name
    results = {"straight": ["dev_results.json", "predict_results.json"],
               "straight/test_output": ["test_results.json"],
               "pho": ["dev_results.json"], "res": ["dev_results.json"]}
    for sub, names in results.items():
        for name in names:
            assert os.path.isfile(os.path.join(work, sub, name)), (sub, name)


@pytest.mark.parametrize("cli", [ttrain, ttest, pretrain_pho, pretrain_res],
                         ids=["train", "test", "pretrain_pho", "pretrain_res"])
def test_mesh_errors_exit_with_the_reason(cli, tmp_path, monkeypatch):
    """In one process: a mesh of 2 ranks names the torchrun launch that
    fits, a model axis that does not divide the heads (the preset's, or the
    checkpoint's for cli/test) names them, a bad axis the syntax; each
    before the process group forms and the device is touched."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    base = (["--ckpt_dir", str(tmp_path)] if cli is ttest
            else ["--output_dir", str(tmp_path)])
    base += ["--synthetic", "--device", "cpu"]
    if cli is ttest:  # a checkpoint's config: the tiny preset's 2 heads
        from realise_tpu_torch.cli.common import TINY_OVERRIDES
        from realise_tpu_torch.config import config_for

        config_for("bert-pho2-res-arch3", **TINY_OVERRIDES).save(
            str(tmp_path))
        open(os.path.join(tmp_path, tckpt.MODEL_FILE), "wb").close()
    for mesh, reason in (("data=2", "torchrun --nproc_per_node 2"),
                         ("data=1,model=5", "num_attention_heads"),
                         ("data:2", "bad axis")):
        with pytest.raises(SystemExit, match=reason):
            cli.main(base + ["--mesh", mesh])
    assert not torch.distributed.is_initialized()

