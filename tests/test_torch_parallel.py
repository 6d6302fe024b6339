"""The port's data parallelism (realise_tpu_torch/parallel/, the Trainer's
process group) against the JAX package's.

The slicing helpers and the mesh checks run here. The step runs in two
ranks of a gloo group on the CPU (tests/torch_parallel_workers.py, JAX-free
processes), from the weights of tests/test_torch_training.py's tiny arch3,
and is held to the JAX Trainer's shard_map step on a data=2 mesh
(``use_pallas=True``: the Pallas kernels in interpret mode) with the limits
of that file: the loss within 1e-6 relative, every gradient within 5e-5,
the BatchNorm running statistics within 1e-5, the weights within Adam's
sign limit. The ranks' dropout contract, their resume from rank 0's
checkpoint and the gathered eval are held to one process of the port.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from realise_tpu.config import PHO2_VOCAB_SIZE
from realise_tpu.models.realise import apply_realise, init_realise
from realise_tpu.parallel.distributed import local_slice as jax_local_slice
from realise_tpu.parallel.distributed import pad_to_multiple as jax_pad
from realise_tpu.parallel.mesh import make_mesh as jax_make_mesh
from realise_tpu.training.trainer import Trainer as JaxTrainer
from realise_tpu_torch.models.convert import state_dict_from_jax
from realise_tpu_torch.parallel import distributed, mesh
from realise_tpu_torch.training.trainer import Trainer
from test_torch_training import BN_ATOL, CFG, GRAD_ATOL, PCFG, V, _batch
from torch_port_fixtures import live_glyph_features, one_intra_op_thread
from torch_parallel_workers import start_ranks, wait_ranks

TRAINER_KW = dict(learning_rate=1e-5, warmup_steps=0, total_steps=10,
                  weight_decay=0.01, max_grad_norm=1.0)
# (grad_accum_steps, global batch): two rows a microbatch on each rank.
ACCUM = {1: 4, 2: 8}


@pytest.fixture(autouse=True)
def _one_thread():
    with one_intra_op_thread():
        yield


# ---------------------------------------------------------------- slicing
@pytest.mark.parametrize("items,multiple", [
    ([1, 2, 3], 2), ([1, 2, 3, 4], 2), ([], 4), ([7], 1), ([5, 6], 3)])
def test_pad_to_multiple_matches_jax(items, multiple):
    assert distributed.pad_to_multiple(items, multiple) == jax_pad(items,
                                                                   multiple)


@pytest.mark.parametrize("n,procs", [(8, 2), (8, 4), (7, 2), (5, 4), (9, 3),
                                     (3, 1)])
def test_local_slices_match_jax(n, procs):
    """Every rank's slice is the JAX package's, and their concatenation is
    the padded global batch in order."""
    batch = list(range(n))
    slices = [distributed.local_slice(batch, p, procs) for p in range(procs)]
    assert slices == [jax_local_slice(batch, p, procs) for p in range(procs)]
    assert [x for s in slices for x in s] == jax_pad(batch, procs)


def test_helpers_without_a_group_are_the_identity():
    assert (distributed.process_index(), distributed.process_count(),
            distributed.is_main_process()) == (0, 1, True)
    assert distributed.local_slice([1, 2, 3]) == [1, 2, 3]
    rows = torch.arange(6).reshape(3, 2)
    assert distributed.gather_rows(rows) is rows
    distributed.barrier()
    assert mesh.make_mesh().axes == {"data": 1}


def test_make_mesh_checks_the_group():
    assert mesh.make_mesh({"data": 4}, world_size=4).data == 4
    assert mesh.make_mesh({"data": 2, "model": 1}, world_size=2).size == 2
    assert mesh.make_mesh(None, world_size=3).axes == {"data": 3}
    with pytest.raises(ValueError, match=r"needs 2 processes.* has 1.*"
                                         r"torchrun --nproc_per_node 2"):
        mesh.make_mesh({"data": 2}, world_size=1)
    assert mesh.make_mesh({"data": 1, "model": 2}, world_size=2).model == 2
    with pytest.raises(ValueError, match=r"model axis of 5 must divide "
                                         r"num_attention_heads \(12\)"):
        mesh.make_mesh({"data": 1, "model": 5}, world_size=1, cfg=PCFG.replace(
            num_attention_heads=12, intermediate_size=3072))
    with pytest.raises(ValueError, match="first"):
        mesh.make_mesh({"model": 1, "data": 2}, world_size=2)
    with pytest.raises(ValueError, match="unknown"):
        mesh.make_mesh({"data": 2, "pipe": 1}, world_size=2)
    with pytest.raises(ValueError, match="at least 1"):
        mesh.make_mesh({"data": 0}, world_size=0)


def test_initialize_needs_the_launcher(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        distributed.initialize(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.initialize("127.0.0.1:1", 2, 0)
    assert not torch.distributed.is_initialized()


# ------------------------------------------------------------ two ranks
def _jax_model():
    """tests/test_torch_training.py's jax_model fixture, as numpy."""
    rng = np.random.RandomState(0)
    glyphs = (rng.rand(V, 1, 32, 32) > 0.5).astype(np.float32)
    params, state = init_realise(jax.random.PRNGKey(0), CFG, glyphs=glyphs)
    params = live_glyph_features(jax.tree.map(
        lambda x: np.asarray(x) + rng.normal(0, 0.05, np.shape(x)).astype(
            np.float32), params))
    return params, jax.tree.map(np.asarray, state)


def _loss_sum_grad(state):
    """The jitted gradient of one microbatch's loss sum (and its count)."""

    def loss_sum(p, mb):
        out = apply_realise(p, state, mb, CFG, deterministic=False,
                            rng=jax.random.PRNGKey(0), train=True,
                            use_pallas=True)
        return out["loss_sum"], out["loss_count"]

    return jax.jit(jax.grad(loss_sum, has_aux=True))


def _jax_step(params, state, accum, batch, grad_fn):
    """The JAX Trainer's shard_map step on data=2 (its loss, weights and
    state after the step) and its gradient after the clip: the sum over
    both shards' microbatches of the loss sum's gradient (each microbatch
    with its own BatchNorm batch statistics, as in the shard_map body) over
    the global count, clipped by global norm as optax clips it."""
    jmesh = jax_make_mesh({"data": 2}, devices=jax.devices()[:2])
    jt = JaxTrainer(CFG, jax.tree.map(jnp.asarray, params),
                    jax.tree.map(jnp.asarray, state), mesh=jmesh,
                    use_pallas=True, grad_accum_steps=accum, **TRAINER_KW)
    assert jt._shard_pallas
    loss = float(jt.train_step(batch))
    ts = jax.tree.map(np.asarray, (jt.train_state.params,
                                   jt.train_state.state))
    rows = len(batch["src_idx"]) // (2 * accum)
    grads, count = None, 0.0
    for i in range(2 * accum):
        mb = {k: jnp.asarray(v[i * rows:(i + 1) * rows])
              for k, v in batch.items()}
        g, c = grad_fn(jax.tree.map(jnp.asarray, params), mb)
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        count += float(c)
    grads = jax.tree.map(lambda g: g / count, grads)
    grads, _ = optax.clip_by_global_norm(
        TRAINER_KW["max_grad_norm"]).update(grads, optax.EmptyState())
    return loss, ts, jax.tree.map(np.asarray, grads)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results (tests/torch_parallel_workers.library) and the
    JAX shard_map step's, computed while the ranks run."""
    work = str(tmp_path_factory.mktemp("ranks"))
    params, state = _jax_model()
    rng = np.random.RandomState(4)
    pho_tables = (rng.randint(1, PHO2_VOCAB_SIZE, (V, 8)).astype(np.int64),
                  rng.randint(1, 9, V).astype(np.int64))
    inputs = {"sd": state_dict_from_jax(params, state, PCFG),
              "cfg": PCFG.to_dict(), "trainer_kw": TRAINER_KW,
              "eval_batch": _batch(3, 8), "pho_tables": pho_tables,
              "dropout_batches": [_batch(10 + i) for i in range(4)]}
    for accum, b in ACCUM.items():
        inputs[f"batch{b}"] = _batch(accum, b)
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    procs = start_ranks("library", work)
    try:
        grad_fn = _loss_sum_grad(state)
        jax_out = {accum: _jax_step(params, state, accum,
                                    inputs[f"batch{b}"], grad_fn)
                   for accum, b in ACCUM.items()}
    finally:
        wait_ranks(procs)
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    return ranks, jax_out, inputs


def _equal_bits(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("accum", sorted(ACCUM))
def test_step_matches_the_jax_shard_map_step(two_ranks, accum):
    """Rank 0's step against the JAX shard_map step on data=2: the loss,
    every gradient (of the mean loss, after the clip), the BatchNorm
    running statistics (the mean over the ranks of each rank's updates) and
    the updated weights (Adam's step is lr·m̂/(√v̂+eps), so a near-zero
    gradient whose sign two summation orders disagree on moves by up to
    lr: every element within 2 lr, 99.9% within 1e-6)."""
    ranks, jax_out, _ = two_ranks
    got = ranks[0][f"accum{accum}"]
    loss, (params, state), grads = jax_out[accum]
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-6)
    want_grads = state_dict_from_jax(grads, state, PCFG)
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(),
                                   atol=GRAD_ATOL, err_msg=name)
    want = state_dict_from_jax(params, state, PCFG)
    diffs = []
    for name in got["grads"]:
        d = np.abs(got["state"][name].numpy() - want[name].numpy())
        assert d.max() <= 2 * TRAINER_KW["learning_rate"], (name, d.max())
        diffs.append(d.ravel())
    assert (np.concatenate(diffs) > 1e-6).mean() < 1e-3
    stats = [n for n in got["state"] if "running_" in n]
    assert stats
    for name in stats:
        np.testing.assert_allclose(got["state"][name].numpy(),
                                   want[name].numpy(), atol=BN_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("accum", sorted(ACCUM))
def test_ranks_hold_equal_replicas(two_ranks, accum):
    """After the all-reduce every rank holds the same loss, gradients,
    weights and BatchNorm statistics, bit for bit."""
    ranks, _, _ = two_ranks
    a, b = (r[f"accum{accum}"] for r in ranks)
    assert a["loss"] == b["loss"]
    _equal_bits(a["grads"], b["grads"])
    _equal_bits(a["state"], b["state"])


@pytest.mark.parametrize("path", ["eval_live", "eval_tables"])
@pytest.mark.parametrize("accum", sorted(ACCUM))
def test_gathered_eval_matches_one_process(two_ranks, accum, path):
    """``eval_step`` over each rank's half of a batch gives every rank the
    predictions of one process over the whole batch (live streams, and the
    (V, H) tables), and the loss of its global sums."""
    ranks, _, inputs = two_ranks
    res = ranks[0][f"accum{accum}"]
    model = _port_model_from(res["state"])
    tr = Trainer(PCFG, model, use_kernels=True, device="cpu")
    if path == "eval_tables":
        tr.prepare_eval_tables(_Tables(inputs["pho_tables"]))
    want = tr.eval_step(inputs["eval_batch"])
    for rank in ranks:
        got = rank[f"accum{accum}"][path]
        np.testing.assert_array_equal(got["pred_idx"], want["pred_idx"])
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)


class _Tables:
    def __init__(self, tables):
        self.tables = tables

    def pho2_tables(self):
        return self.tables


def _port_model_from(sd, cfg=PCFG):
    from realise_tpu_torch.models.realise import Realise

    model = Realise(cfg)
    model.load_state_dict(sd)
    return model


def _dropout_cfg():
    return PCFG.replace(hidden_dropout_prob=0.1,
                        attention_probs_dropout_prob=0.1)


def test_world_of_one_gives_the_bits_without_a_group(two_ranks):
    """A trainer over a group of one rank (each rank's own group, dropout
    0.1) steps to the same bits as a trainer without a group."""
    ranks, _, inputs = two_ranks
    cfg = _dropout_cfg()
    tr = Trainer(cfg, _port_model_from(inputs["sd"], cfg), use_kernels=True,
                 device="cpu", seed=5, **TRAINER_KW)
    losses = [float(tr.train_step(b)) for b in inputs["dropout_batches"][:2]]
    for rank in ranks:
        assert rank["world1_losses"] == losses
        _equal_bits(rank["world1"], tr.model.state_dict())


def test_ranks_draw_their_own_masks(two_ranks):
    """Generators seeded alike draw other masks on rank 1; rank 0 draws
    those of a plain generator of that seed."""
    ranks, _, inputs = two_ranks
    losses = ranks[0]["mask_losses"]
    assert ranks[1]["mask_losses"] == losses
    assert losses[0] != losses[1]
    cfg = _dropout_cfg()
    model = _port_model_from(inputs["sd"], cfg).train()
    batch = {k: torch.as_tensor(v, dtype=torch.long)
             for k, v in inputs["dropout_batches"][0].items()}
    with torch.no_grad():
        want = model(batch, use_kernels=True,
                     generator=torch.Generator().manual_seed(7))["loss_sum"]
    assert losses[0] == float(want)


def test_dropout_steps_repeat_and_stay_in_sync(two_ranks):
    """Four steps at dropout 0.1: both ranks hold the same bits after them,
    and a second run from the same init gives those bits again."""
    ranks, _, _ = two_ranks
    _equal_bits(ranks[0]["straight"], ranks[1]["straight"])
    for rank in ranks:
        assert rank["rerun_losses"] == rank["straight_losses"]
        _equal_bits(rank["rerun"], rank["straight"])


def test_resume_from_rank0_checkpoint_is_bitwise(two_ranks):
    """Two steps, rank 0's checkpoint (weights and trainer.pt), then two
    steps in fresh trainers on both ranks: the straight run's bits."""
    ranks, _, _ = two_ranks
    for rank in ranks:
        assert rank["resumed_losses"] == rank["straight_losses"][2:]
        _equal_bits(rank["resumed"], rank["straight"])
