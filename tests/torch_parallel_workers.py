"""The ranks of the port's data- and tensor-parallel tests
(tests/test_torch_parallel*.py, tests/test_torch_tensor_parallel.py).

Each rank is a process of its own that imports no JAX: the tests start two
or four with :func:`start_ranks`, on one torch intra-op thread each, and
compare what they write with the JAX package in the test process.

    python tests/torch_parallel_workers.py SCENARIO RANK WORLD WORK_DIR

``library`` and ``tensor`` form a gloo group through
``parallel.distributed.initialize`` (a ``file://`` store in WORK_DIR) and
drive the Trainer; ``cli`` and ``cli_tensor`` set torchrun's environment
(``env://`` on the port in WORK_DIR/port) and drive the CLIs. Each rank
writes ``WORK_DIR/rank{RANK}.pt``.
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
    from realise_tpu_torch.parallel.mesh import make_mesh
    from realise_tpu_torch.parallel.tensor import MeshGroups
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
    solo = MeshGroups(make_mesh({"data": 1}, world_size=1),
                      data_group=groups[rank])
    alone = Trainer(dcfg, _model(dcfg, inp["sd"]), use_kernels=True,
                    device="cpu", seed=5, mesh=solo, **inp["trainer_kw"])
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


def tensor(rank: int, world: int, work: str) -> dict:
    """The Trainer under ``inp['axes']`` (data=2,model=2 over four ranks):
    first the eval-mode forward of ``inp['eval_batch']`` on the model split
    over each data index's model group alone (a data=1,model=2 mesh); at
    dropout 0 one step (its loss, the clip's norm, the gathered
    gradients, weights and AdamW moments, the eval of the new weights), a
    checkpoint of the full tensors and a second step; a step with
    ``grad_accum_steps=2``; three steps at dropout 0.1; and a one-process
    checkpoint loaded onto the mesh and stepped."""
    import copy

    import numpy as np
    import torch

    from realise_tpu_torch.config import RealiseConfig
    from realise_tpu_torch.parallel.distributed import initialize, local_slice
    from realise_tpu_torch.parallel.mesh import make_mesh
    from realise_tpu_torch.parallel.tensor import (
        MeshGroups,
        gather_tensor,
        mesh_groups,
        shard_module,
    )
    from realise_tpu_torch.training import trainer as trainer_module
    from realise_tpu_torch.training.checkpoint import (
        load_checkpoint,
        load_trainer_state,
        save_checkpoint,
    )
    from realise_tpu_torch.training.trainer import Trainer

    initialize(f"file://{work}/store", world, rank, device="cpu")
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    cfg = RealiseConfig.from_dict(inp["cfg"])
    mesh = make_mesh(inp["axes"])
    d, n = mesh.data_index(rank), mesh.data
    norms = []
    clip = trainer_module.clip_by_global_norm

    def recording_clip(*a, **kw):
        norm = clip(*a, **kw)
        norms.append(float(norm))
        return norm

    trainer_module.clip_by_global_norm = recording_clip

    def rows(batch):
        return {k: np.asarray(local_slice(v, d, n)) for k, v in batch.items()}

    def trainer(c, **kw):
        return Trainer(c, _model(c, inp["sd"]), device="cpu", mesh=mesh,
                       **dict(inp["trainer_kw"], **kw))

    def full(tr):  # the gathered weights, copied: the live ones move on
        return {k: v.clone() for k, v in tr.model_state_dict().items()}

    groups = mesh_groups(mesh)
    pair = MeshGroups(make_mesh({"data": 1, "model": 2}, world_size=2),
                      model_index=groups.model_index,
                      model_group=groups.model_group)
    model = _model(cfg, inp["sd"])
    shard_module(model, pair)
    with torch.no_grad():
        logits = model({k: torch.as_tensor(v, dtype=torch.long)
                        for k, v in inp["eval_batch"].items()})["logits"]
    out = {"forward": logits}
    tr = trainer(cfg)
    params = dict(tr.model.named_parameters())
    res = {"loss": float(tr.train_step(rows(inp["batch"]))),
           "norm": norms[-1], "splits": dict(tr.splits),
           "use_kernels": tr.use_kernels,
           "grads": {k: (gather_tensor(p.grad, tr.splits[k],
                                       tr.groups.model_group)
                         if k in tr.splits else p.grad.clone())
                     for k, p in params.items()},
           "replicated": {k: v.clone() for k, v in tr.model.state_dict().items()
                          if k not in tr.splits},
           "state": full(tr)}
    opt = tr.optimizer.state_dict()["state"]
    res["moment_shapes_local"] = all(
        opt[i][m].shape == params[name].shape
        for i, name in enumerate(tr._opt_names)
        for m in ("exp_avg", "exp_avg_sq"))
    res["trainer_state"] = copy.deepcopy(tr.state_dict())
    res["eval"] = tr.eval_step(rows(inp["eval_batch"]))
    save_checkpoint(os.path.join(work, "tp"), 1, tr.model_state_dict(), cfg,
                    trainer_state=tr.state_dict())
    res["loss2"] = float(tr.train_step(rows(inp["batch2"])))
    res["state2"] = full(tr)
    out["step"] = res

    tr = trainer(cfg, grad_accum_steps=2)
    out["accum2"] = {"loss": float(tr.train_step(rows(inp["batch"]))),
                     "state": full(tr)}

    dcfg = cfg.replace(hidden_dropout_prob=0.1,
                       attention_probs_dropout_prob=0.1)
    tr = trainer(dcfg, seed=5)
    out["dropout"] = {"losses": [float(tr.train_step(rows(b)))
                                 for b in inp["dropout_batches"]],
                      "state": full(tr)}

    # The first dropout step's masks as chip_smoke.py's phase 16b records
    # them: as the program draws them, and with the first head-split site's
    # layout taken away (its block's mask drawn by the block's own indices).
    import chip_smoke
    from realise_tpu_torch.ops import bert as bert_module

    layout = bert_module._layout
    heads_seen = []

    def planted(tp, x, heads=False):
        heads_seen.append(heads)
        if heads and heads_seen.count(True) == 1:
            return None
        return layout(tp, x, heads)

    out["masks"] = {}
    for plant in (False, True):
        bert_module._layout = planted if plant else layout
        try:
            with chip_smoke.recorded_masks() as calls:
                trainer(dcfg, seed=5).train_step(
                    rows(inp["dropout_batches"][0]))
        finally:
            bert_module._layout = layout
        out["masks"][plant] = calls

    tr = trainer(cfg)
    one = os.path.join(work, "one", "saved_ckpt-1")
    tr.model.load_state_dict(load_checkpoint(one))
    tr.load_state_dict(load_trainer_state(one))
    out["resumed"] = {"loss": float(tr.train_step(rows(inp["batch2"]))),
                      "state": full(tr)}
    return out


def cli_tensor(rank: int, world: int, work: str) -> dict:
    """cli/train --distributed (dropout 0), cli/test and both pretraining CLIs under ``--mesh`` WORK_DIR/mesh, with their
    loss traces."""
    import contextlib

    from realise_tpu_torch.cli import pretrain_pho, pretrain_res
    from realise_tpu_torch.cli import test as ttest
    from realise_tpu_torch.cli import train as ttrain
    from realise_tpu_torch.training.trainer import Trainer

    with open(os.path.join(work, "port")) as f:
        port = f.read().strip()
    with open(os.path.join(work, "mesh")) as f:
        mesh = ["--mesh", f.read().strip()]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    out = {}

    @contextlib.contextmanager
    def recorded(name):
        losses = out.setdefault(name, [])
        step = Trainer.train_step

        def train_step(self, batch):
            loss = step(self, batch)
            losses.append(float(loss))
            out["use_kernels"] = self.use_kernels
            return loss

        Trainer.train_step = train_step
        try:
            yield
        finally:
            Trainer.train_step = step

    def path(name):
        return os.path.join(work, name)

    build_config = ttrain.build_config
    ttrain.build_config = lambda *a: build_config(*a).replace(
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    try:
        with recorded("train"):
            assert ttrain.main(TENSOR_TRAIN + ["--distributed"] + mesh + [
                "--output_dir", path("train")]) == 0
    finally:
        ttrain.build_config = build_config
    assert ttest.main(["--ckpt_dir", path("train"), "--synthetic",
                       "--device", "cpu"] + mesh) == 0
    with recorded("pretrain_pho"):
        assert pretrain_pho.main(TENSOR_PHO + mesh + [
            "--output_dir", path("pho")]) == 0
    with recorded("pretrain_res"):
        assert pretrain_res.main(TENSOR_RES + mesh + [
            "--output_dir", path("res")]) == 0
    return out


# The runs of ``cli_tensor`` (the test runs them in one process too).
TENSOR_TRAIN = ["--synthetic", "--tiny", "--device", "cpu", "--no_prefetch",
                "--logging_steps", "1", "--seed", "3",
                "--per_device_train_batch_size", "4", "--max_steps", "3",
                "--save_steps", "2", "--do_train"]
TENSOR_PHO = ["--synthetic", "--tiny", "--device", "cpu", "--max_steps", "2",
              "--per_device_train_batch_size", "2",
              "--gradient_accumulation_steps", "1", "--save_steps", "0"]
TENSOR_RES = ["--synthetic", "--tiny", "--device", "cpu", "--max_steps", "2",
              "--per_device_train_batch_size", "8"]


def main(argv) -> int:
    scenario, rank, world, work = argv[0], int(argv[1]), int(argv[2]), argv[3]
    import torch

    from realise_tpu_torch.parallel.distributed import shutdown

    torch.set_num_threads(1)
    try:
        out = {"library": library, "cli": cli, "tensor": tensor,
               "cli_tensor": cli_tensor}[scenario](rank, world, work)
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
