"""The whole run, tiny on the CPU, with the timed path broken underneath:
each fault the cell can have makes ``correct`` false."""

import pytest

from conftest import DP_PARAMS, SERVE_PARAMS, TRAIN_PARAMS, run_cell


@pytest.mark.parametrize("workload", ["arch3.train.b256", "bert.train.b256",
                                      "bert.train.b32"])
@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_training_fault_is_not_correct(capsys, one_thread, workload, fault):
    rc, res = run_cell(capsys, workload, TRAIN_PARAMS, fault=fault)
    assert rc == 0 and res["correct"] is False, res["checks"]


def test_altered_token_is_not_correct(capsys, one_thread):
    rc, res = run_cell(capsys, "arch3.serve.open", SERVE_PARAMS, seconds="2",
                       fault="altered_token")
    assert rc == 0 and res["correct"] is False, res["checks"]


@pytest.mark.parametrize("fault", ["no_exchange", "half_batch"])
def test_data_parallel_fault_is_not_correct(capsys, one_thread, fault):
    rc, res = run_cell(capsys, "arch3.train.dp4", DP_PARAMS, fault=fault)
    assert rc == 0 and res["correct"] is False, res["checks"]
