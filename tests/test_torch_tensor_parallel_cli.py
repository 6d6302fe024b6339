"""The port's CLIs under tensor parallelism: ``--mesh data=1,model=2`` (two
ranks) and ``data=2,model=2`` (four) of a gloo group on the CPU, launched as
torchrun launches them (tests/torch_parallel_workers.cli_tensor).

``cli/train --distributed`` at dropout 0 and ``cli/pretrain_pho`` are held
to one process on the global batch within 1e-5 (the tensor-parallel step
is the GSPMD one: one dropout key, the global batch's BatchNorm
statistics), the checkpoints to one process's shapes and ``cli/test`` of
the mesh to one process's ``cli/test`` of its checkpoint. ``cli/pretrain_res``
has nothing to split: at ``data=1`` it is one process's run.
"""

import json
import os

import numpy as np
import portpicker
import pytest
import torch

from realise_tpu_torch.cli import pretrain_pho, pretrain_res
from realise_tpu_torch.cli import test as ttest
from realise_tpu_torch.cli import train as ttrain
from realise_tpu_torch.training import checkpoint as tckpt
from test_torch_parallel_cli import recorded_losses
from torch_port_fixtures import one_intra_op_thread
from torch_parallel_workers import (
    TENSOR_PHO,
    TENSOR_RES,
    TENSOR_TRAIN,
    start_ranks,
    wait_ranks,
)


# ---------------------------------------------------- tensor parallelism
TENSOR_MESHES = {"data=1,model=2": (1, 2), "data=2,model=2": (2, 4)}


def _scaled(argv, flag, data):
    """``argv`` with ``flag``'s value times ``data``: one process's batch
    for the mesh's global one."""
    i = argv.index(flag)
    return argv[:i + 1] + [str(int(argv[i + 1]) * data)] + argv[i + 2:]


@pytest.fixture(scope="module", params=sorted(TENSOR_MESHES))
def tensor_cli_ranks(request, tmp_path_factory):
    """The ranks' recorded runs under the mesh, and one process's runs of
    the same global batches (cli/train at dropout 0, cli/pretrain_pho,
    cli/pretrain_res at data=1), run while the ranks run."""
    mesh = request.param
    data, world = TENSOR_MESHES[mesh]
    work = str(tmp_path_factory.mktemp("tensor_cli"))
    with open(os.path.join(work, "port"), "w") as f:
        f.write(str(portpicker.pick_unused_port()))
    with open(os.path.join(work, "mesh"), "w") as f:
        f.write(mesh)
    procs = start_ranks("cli_tensor", work, world=world)
    one = {}
    try:
        build_config = ttrain.build_config
        ttrain.build_config = lambda *a: build_config(*a).replace(
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
        try:
            with one_intra_op_thread(), recorded_losses() as one["train"]:
                assert ttrain.main(_scaled(
                    TENSOR_TRAIN, "--per_device_train_batch_size", data) + [
                    "--output_dir",
                    os.path.join(work, "one_train")]) == 0
        finally:
            ttrain.build_config = build_config
        with one_intra_op_thread(), recorded_losses() as one["pretrain_pho"]:
            assert pretrain_pho.main(_scaled(
                TENSOR_PHO, "--per_device_train_batch_size", data) + [
                "--output_dir", os.path.join(work, "one_pho")]) == 0
        if data == 1:
            with one_intra_op_thread(), \
                    recorded_losses() as one["pretrain_res"]:
                assert pretrain_res.main(TENSOR_RES + [
                    "--output_dir", os.path.join(work, "one_res")]) == 0
    finally:
        wait_ranks(procs)
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(world)]
    return ranks, one, work, data


def test_tensor_cli_ranks_share_the_loss_traces(tensor_cli_ranks):
    """Every rank of the mesh records the same finite loss traces, and
    none ran the kernels."""
    ranks, _, _, _ = tensor_cli_ranks
    for name in ("train", "pretrain_pho", "pretrain_res"):
        trace = ranks[0][name]
        assert all(rank[name] == trace for rank in ranks[1:]), name
        assert len(trace) in (2, 3) and np.isfinite(trace).all(), name
    assert not any(rank["use_kernels"] for rank in ranks)


def test_tensor_cli_loss_traces_match_one_process(tensor_cli_ranks):
    """cli/train and cli/pretrain_pho under the mesh train on one process's
    trace over the same global batches (within 1e-5, the summation order
    aside); cli/pretrain_res at data=1 is one process's run."""
    ranks, one, _, data = tensor_cli_ranks
    for name in ("train", "pretrain_pho"):
        np.testing.assert_allclose(ranks[0][name], one[name], atol=1e-5,
                                   err_msg=name)
    if data == 1:
        np.testing.assert_allclose(ranks[0]["pretrain_res"],
                                   one["pretrain_res"], atol=1e-5)


def test_tensor_cli_checkpoints_hold_full_weights(tensor_cli_ranks):
    """The mesh's checkpoints hold the unsplit tensors (one process's
    shapes), and cli/test of the last one in one process scores what the
    mesh's cli/test scored."""
    _, _, work, _ = tensor_cli_ranks
    assert [s for s, _ in tckpt.list_checkpoints(
        os.path.join(work, "train"))] == [2, 3]
    got = tckpt.load_checkpoint(os.path.join(work, "train", "saved_ckpt-3"))
    want = tckpt.load_checkpoint(os.path.join(work, "one_train",
                                              "saved_ckpt-3"))
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    with one_intra_op_thread():
        assert ttest.main(["--ckpt_dir", os.path.join(work, "train"),
                           "--synthetic", "--device", "cpu", "--output_dir",
                           os.path.join(work, "one_test")]) == 0
    results = []
    for d in ("train/test_output", "one_test"):
        with open(os.path.join(work, d, "test_results.json")) as f:
            results.append(json.load(f))
    assert results[0].keys() == results[1].keys()
    for k in results[0]:
        np.testing.assert_allclose(results[0][k], results[1][k], rtol=1e-6,
                                   err_msg=k)
