"""The benchmark's CPU tests: tiny configurations of the cells, run on the
CPU through ``benchmark/run.py``'s ``main`` (which then skips its look for a
card)."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny_config(**overrides):
    """Overrides of a configuration file that keep its wiring: two semantic
    layers, one pho and one output layer, H=32, a 2048-token vocabulary, in
    float32 (the cells' limits are set at their published width in bf16;
    at H=32 bf16 rounding alone would pass them)."""
    with open(os.path.join(ROOT, "benchmark", "configs", "arch3.json")) as f:
        assumed = json.load(f)["assumed"]
    cfg = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
               intermediate_size=64, pho_num_layers=1, out_num_layers=1,
               max_position_embeddings=64, max_seq_length=32, vocab_size=2048,
               assumed=dict(assumed, vocab_cjk_chars=1500), dtype="float32")
    cfg.update(overrides)
    return cfg


TRAIN_PARAMS = dict(batch=4, buckets=[8, 16, 32], pool=24, warmup_steps=2,
                    length_mean=8, length_max=30, trace_seconds=1)
# Four gloo ranks of two rows each, in processes of their own.
DP_PARAMS = dict(TRAIN_PARAMS, batch=8)
SERVE_PARAMS = dict(buckets=[8, 16, 32], rate=20.0, length_mean=8,
                    length_max=30, warm_seconds=0.5, trace_seconds=1,
                    sample_step_share=0.5)
CLOSED_PARAMS = dict(buckets=[8, 16, 32], clients=4, requests=64,
                     length_mean=8, length_max=30, warm_seconds=0.5,
                     trace_seconds=1, sample_step_share=0.5)


def run_cell(capsys, workload, params, seconds="1", fault=None, **cfg):
    """Run a cell tiny on the CPU; (exit code, the printed result or None)."""
    import torch

    from benchmark import run

    rc = run.main(["--workload", workload, "--seed", "3000000001",
                   "--seconds", seconds, "--trace", "0"],
                  device=torch.device("cpu"), config_overrides=tiny_config(**cfg),
                  param_overrides=params, fault=fault)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)


@pytest.fixture
def one_thread():
    """One intra-op thread: the suite runs under several workers."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
