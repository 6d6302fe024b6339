"""The whole run, tiny on the CPU, with the timed path broken underneath:
each fault the cell can have makes ``correct`` false."""

import pytest

from conftest import (CLOSED_PARAMS, DP_PARAMS, SERVE_PARAMS, TRAIN_PARAMS,
                      run_cell)


@pytest.mark.parametrize("workload", ["arch3.train.b256", "bert.train.b256",
                                      "bert.train.b32"])
@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_training_fault_is_not_correct(capsys, one_thread, workload, fault):
    rc, res = run_cell(capsys, workload, TRAIN_PARAMS, fault=fault)
    assert rc == 0 and res["correct"] is False, res["checks"]


@pytest.mark.parametrize("workload,params", [
    ("arch3.serve.open", SERVE_PARAMS), ("arch3.serve.closed8", CLOSED_PARAMS)])
def test_altered_token_is_not_correct(capsys, one_thread, workload, params):
    rc, res = run_cell(capsys, workload, params, seconds="2",
                       fault="altered_token")
    assert rc == 0 and res["correct"] is False, res["checks"]


@pytest.mark.parametrize("fault", ["no_exchange", "half_batch",
                                   "dropped_rank"])
def test_data_parallel_fault_is_not_correct(capsys, one_thread, fault):
    rc, res = run_cell(capsys, "arch3.train.dp4", DP_PARAMS, fault=fault)
    assert rc == 0 and res["correct"] is False, res["checks"]
