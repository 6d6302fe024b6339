"""The ranks of the port's data-parallel tests (tests/test_torch_parallel*.py).

Each rank is a process of its own that imports no JAX: the tests start two
with :func:`start_ranks`, on one torch intra-op thread each, and compare
what they write with the JAX package in the test process.

    python tests/torch_parallel_workers.py SCENARIO RANK WORLD WORK_DIR

``library`` forms a gloo group through ``parallel.distributed.initialize``
(a ``file://`` store in WORK_DIR) and drives the Trainer; ``cli`` sets
torchrun's environment (``env://`` on the port in WORK_DIR/port) and drives
the CLIs. Each rank writes ``WORK_DIR/rank{RANK}.pt``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# A rank that raises leaves its peer blocked in a collective: both are
# killed after this many seconds, and the test fails. The CLI ranks take
# ~45 s alone on an 8-core CPU; the rest is room for a loaded test lane.
RANK_TIMEOUT_S = 180


def start_ranks(scenario: str, work_dir: str, world: int = 2):
    """Start ``world`` ranks of ``scenario``; returns their Popen handles."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "MASTER_ADDR", "MASTER_PORT",
                        "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), scenario, str(rank),
         str(world), work_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for rank in range(world)]


def wait_ranks(procs, timeout: float = RANK_TIMEOUT_S):
    """Wait for every rank; kill all and raise AssertionError when one
    fails or the time runs out. Returns their outputs."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            left = max(deadline - time.monotonic(), 0.1)
            try:
                out, _ = p.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"rank timed out after {timeout} s")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{out[-4000:]}"
    return outs


# ------------------------------------------------------------------ ranks
def _rows(batch, rank, world):
    """This rank's contiguous rows of every array of ``batch``."""
    import numpy as np

    from realise_tpu_torch.parallel.distributed import local_slice

    return {k: np.asarray(local_slice(v, rank, world))
            for k, v in batch.items()}


def _model(cfg, sd):
    from realise_tpu_torch.models.realise import Realise

    model = Realise(cfg)
    model.load_state_dict(sd)
    return model


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


class _PinyinTables:
    """The featurizer's ``pho2_tables`` of the tiny test vocabulary."""

    def __init__(self, tables):
        self.tables = tables

    def pho2_tables(self):
        return self.tables


def library(rank: int, world: int, work: str) -> dict:
    import torch
    import torch.distributed as dist

    from realise_tpu_torch.config import RealiseConfig
    from realise_tpu_torch.ops.layers import dropout_generator
    from realise_tpu_torch.parallel.distributed import gather_rows, initialize
    from realise_tpu_torch.training.checkpoint import (
        load_checkpoint,
        load_trainer_state,
        save_checkpoint,
    )
    from realise_tpu_torch.training.trainer import Trainer

    initialize(f"file://{work}/store", world, rank, device="cpu")
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    cfg = RealiseConfig.from_dict(inp["cfg"])
    dcfg = cfg.replace(hidden_dropout_prob=0.1,
                       attention_probs_dropout_prob=0.1)
    out = {}
    # Dropout 0 against the JAX shard_map step, accumulation 1 and 2: the
    # step's loss, gradients (after the clip), weights and BN statistics,
    # then the eval of the updated weights, live and with the tables.
    for accum, batch in ((1, inp["batch4"]), (2, inp["batch8"])):
        tr = Trainer(cfg, _model(cfg, inp["sd"]), use_kernels=True,
                     device="cpu", grad_accum_steps=accum, **inp["trainer_kw"])
        loss = tr.train_step(_rows(batch, rank, world))
        res = {"loss": float(loss), "state": _state(tr.model),
               "grads": {n: p.grad.clone()
                         for n, p in tr.model.named_parameters()}}
        ev = _rows(inp["eval_batch"], rank, world)
        res["eval_live"] = tr.eval_step(ev)
        tr.prepare_eval_tables(_PinyinTables(inp["pho_tables"]))
        res["eval_tables"] = tr.eval_step(ev)
        out[f"accum{accum}"] = res

    # Dropout 0.1: four steps twice from one init, and two steps, a
    # checkpoint of rank 0 and two more steps in a fresh trainer.
    def run(steps, trainer=None):
        trainer = trainer or Trainer(dcfg, _model(dcfg, inp["sd"]),
                                     use_kernels=True, device="cpu", seed=5,
                                     **inp["trainer_kw"])
        losses = [float(trainer.train_step(_rows(b, rank, world)))
                  for b in steps]
        return trainer, losses

    batches = inp["dropout_batches"]
    straight, out["straight_losses"] = run(batches)
    out["straight"] = _state(straight.model)
    rerun, out["rerun_losses"] = run(batches)
    out["rerun"] = _state(rerun.model)
    first, _ = run(batches[:2])
    ckpt = save_checkpoint(os.path.join(work, "ckpt"), 2,
                           first.model.state_dict(), dcfg,
                           trainer_state=first.state_dict())
    resumed = Trainer(dcfg, _model(dcfg, load_checkpoint(ckpt)),
                      use_kernels=True, device="cpu", seed=99,
                      **inp["trainer_kw"])
    resumed.load_state_dict(load_trainer_state(ckpt))
    _, out["resumed_losses"] = run(batches[2:], resumed)
    out["resumed"] = _state(resumed.model)

    # The masks: every rank's training loss on the same rows, each from
    # the generator of its rank (seeded alike), gathered in rank order.
    model = _model(dcfg, inp["sd"]).train()
    batch = {k: torch.as_tensor(v, dtype=torch.long)
             for k, v in batches[0].items()}
    with torch.no_grad():
        loss_sum = model(batch, use_kernels=True,
                         generator=dropout_generator(7, rank))["loss_sum"]
    out["mask_losses"] = gather_rows(loss_sum.reshape(1)).tolist()

    # World 1: a group of this rank alone gives the bits of a trainer
    # without a group (the test runs that one).
    groups = [dist.new_group([r]) for r in range(world)]
    alone = Trainer(dcfg, _model(dcfg, inp["sd"]), use_kernels=True,
                    device="cpu", seed=5, process_group=groups[rank],
                    **inp["trainer_kw"])
    out["world1_losses"] = [float(alone.train_step(b)) for b in batches[:2]]
    out["world1"] = _state(alone.model)
    return out


def cli(rank: int, world: int, work: str) -> dict:
    """cli/train (a straight run with --do_eval --do_predict, a run cut at
    step 2 and its --resume, a run at dropout 0 with the loss trace), then
    cli/test and both pretraining CLIs, every one with --mesh data=WORLD."""
    import contextlib

    from realise_tpu_torch.cli import pretrain_pho, pretrain_res
    from realise_tpu_torch.cli import test as ttest
    from realise_tpu_torch.cli import train as ttrain
    from realise_tpu_torch.training.trainer import Trainer

    with open(os.path.join(work, "port")) as f:
        port = f.read().strip()
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    mesh = ["--distributed", "--mesh", f"data={world}"]
    common = ["--synthetic", "--tiny", "--device", "cpu", "--no_prefetch",
              "--per_device_train_batch_size", "2", "--logging_steps", "1",
              "--seed", "3"]
    out = {}

    @contextlib.contextmanager
    def recorded(name):
        losses = out.setdefault(name, [])
        step = Trainer.train_step

        def train_step(self, batch):
            loss = step(self, batch)
            losses.append(float(loss))
            return loss

        Trainer.train_step = train_step
        try:
            yield
        finally:
            Trainer.train_step = step

    def path(name):
        return os.path.join(work, name)

    # The checkpoints this rank writes.
    from realise_tpu_torch.training import checkpoint

    write = checkpoint._write_checkpoint
    out["writes"] = []

    def recording_write(ckpt_dir, *a):
        out["writes"].append(os.path.relpath(ckpt_dir, work))
        return write(ckpt_dir, *a)

    checkpoint._write_checkpoint = recording_write

    with recorded("straight"):
        assert ttrain.main(common + mesh + [
            "--output_dir", path("straight"), "--max_steps", "4",
            "--save_steps", "2", "--do_train", "--do_eval",
            "--do_predict"]) == 0
    with recorded("cut"):
        assert ttrain.main(common + mesh + [
            "--output_dir", path("resumed"), "--max_steps", "2",
            "--save_steps", "2"]) == 0
    with recorded("resumed"):
        assert ttrain.main(common + mesh + [
            "--output_dir", path("resumed"), "--max_steps", "4",
            "--save_steps", "2", "--resume"]) == 0
    build_config = ttrain.build_config
    ttrain.build_config = lambda *a: build_config(*a).replace(
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    try:
        with recorded("no_dropout"):
            assert ttrain.main(common + mesh + [
                "--output_dir", path("no_dropout"), "--max_steps", "4",
                "--save_steps", "0"]) == 0
    finally:
        ttrain.build_config = build_config
    assert ttest.main(["--ckpt_dir", path("straight"), "--synthetic",
                       "--device", "cpu", "--mesh", f"data={world}"]) == 0
    with recorded("pretrain_pho"):
        assert pretrain_pho.main([
            "--synthetic", "--tiny", "--device", "cpu", "--max_steps", "2",
            "--per_device_train_batch_size", "2",
            "--gradient_accumulation_steps", "1", "--output_dir",
            path("pho"), "--mesh", f"data={world}"]) == 0
    with recorded("pretrain_res"):
        assert pretrain_res.main([
            "--synthetic", "--tiny", "--device", "cpu", "--max_steps", "2",
            "--per_device_train_batch_size", "8", "--output_dir",
            path("res"), "--mesh", f"data={world}"]) == 0
    return out


def main(argv) -> int:
    scenario, rank, world, work = argv[0], int(argv[1]), int(argv[2]), argv[3]
    import torch

    from realise_tpu_torch.parallel.distributed import shutdown

    torch.set_num_threads(1)
    try:
        out = {"library": library, "cli": cli}[scenario](rank, world, work)
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
