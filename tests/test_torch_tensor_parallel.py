"""The port's tensor parallelism (the ``model`` mesh axis:
realise_tpu_torch/parallel/mesh.py and tensor.py, the Trainer under a mesh)
against the JAX package's GSPMD step and the port's one process.

A tiny arch3 with four heads (so that ``model=2`` splits them) runs in four
ranks of a gloo group on the CPU at ``data=2,model=2``
(tests/torch_parallel_workers.tensor, JAX-free processes), from JAX weights
carried across with state_dict_from_jax. Its step is held to the JAX
Trainer on ``make_mesh({"data": 2, "model": 2})`` of four virtual devices
(GSPMD, the jnp path) with the limits of
test_torch_parallel.py::test_step_matches_the_jax_shard_map_step: the loss
within 1e-6 relative, every gradient (and the AdamW moments' gradients)
within 5e-5, the BatchNorm running statistics within 1e-5, the weights
within Adam's sign limit. The same limits hold it to the port's one
process on the global batch, with dropout, accumulation and checkpoints in
both directions.
"""

import contextlib
import copy
import os

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from realise_tpu.config import config_for as jax_config_for
from realise_tpu.models.realise import apply_realise, init_pretrain, init_realise
from realise_tpu.parallel.mesh import make_mesh as jax_make_mesh
from realise_tpu.parallel.mesh import param_shardings as jax_param_shardings
from realise_tpu.training.trainer import Trainer as JaxTrainer
from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.models.convert import state_dict_from_jax
from realise_tpu_torch.models.realise import Realise, build_model
from realise_tpu_torch.ops import layers
from realise_tpu_torch.parallel import mesh as tmesh
from realise_tpu_torch.parallel.tensor import MeshGroups
from realise_tpu_torch.training.checkpoint import (
    load_checkpoint,
    load_trainer_state,
    save_checkpoint,
)
from realise_tpu_torch.training import trainer as trainer_module
from realise_tpu_torch.training.trainer import Trainer
from test_torch_training import BN_ATOL, GRAD_ATOL, _batch
from torch_port_fixtures import live_glyph_features, one_intra_op_thread
from torch_parallel_workers import start_ranks, wait_ranks

V = 80
TINY = dict(vocab_size=V, hidden_size=16, num_hidden_layers=1,
            num_attention_heads=4, intermediate_size=32, pho_num_layers=1,
            out_num_layers=1, max_seq_length=16, max_position_embeddings=16,
            num_fonts=1, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
CFG = jax_config_for("bert-pho2-res-arch3", **TINY)
PCFG = RealiseConfig.from_dict(CFG.to_dict())
AXES = {"data": 2, "model": 2}
TRAINER_KW = dict(learning_rate=1e-5, warmup_steps=0, total_steps=10,
                  weight_decay=0.01, max_grad_norm=1.0)
ROWS = 8  # the global batch: four rows a data rank


@pytest.fixture(autouse=True)
def _one_thread():
    with one_intra_op_thread():
        yield


# -------------------------------------------------------------- the rules
def _marked(params, mesh):
    """Each JAX leaf as 1 + its index along the axis its sharding splits
    over ``model`` (0 where it is replicated), so that the split survives
    state_dict_from_jax's transposes and unstacking."""
    specs = jax_param_shardings(params, mesh)

    def mark(leaf, sharding):
        shape = np.shape(leaf)
        spec = tuple(sharding.spec) + (None,) * (len(shape)
                                                 - len(sharding.spec))
        if "model" not in spec:
            return np.zeros(shape, np.float32)
        axis = spec.index("model")
        idx = np.arange(1, shape[axis] + 1, dtype=np.float32)
        view = [1] * len(shape)
        view[axis] = shape[axis]
        return np.broadcast_to(idx.reshape(view), shape).copy()

    return jax.tree.map(mark, params, specs)


def _split_dim(t):
    """The dim a marked tensor varies along, None when it is all zeros."""
    if not t.any():
        return None
    dims = [d for d in range(t.ndim)
            if not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]
    assert len(dims) == 1, dims
    return dims[0]


@pytest.mark.parametrize("model_type", [
    "bert-pho2-res-arch3", "bert-pho2", "pho2-pretrain", "res-pretrain",
    "pho2-res-pretrain"])
def test_param_shardings_match_the_jax_rules(model_type):
    """Every parameter of the preset is split along the dim, or replicated,
    as the JAX ``param_shardings`` shards its leaf, name by name through
    models/convert; the three BERT stacks are all split."""
    pretrain = model_type.endswith("-pretrain")
    cfg = jax_config_for(model_type, **{k: v for k, v in TINY.items()
                                        if k != "out_num_layers"
                                        or not pretrain})
    init = init_pretrain if pretrain else init_realise
    params, state = init(jax.random.PRNGKey(0), cfg)
    mesh = jax_make_mesh(AXES, devices=jax.devices()[:4])
    pcfg = RealiseConfig.from_dict(cfg.to_dict())
    want = state_dict_from_jax(_marked(params, mesh), state, pcfg)
    with torch.device("meta"):
        model = build_model(pcfg)
    got = tmesh.param_shardings(model.named_parameters(), tmesh.Mesh(AXES))
    assert set(got) <= set(want)
    assert got == {n: _split_dim(want[n]) for n in got}
    split = {n.split(".encoder.")[0] for n, d in got.items() if d is not None}
    stacks = {"bert", "pho_model", "output_block", "pho_res_model"}
    assert split == {n for n, _ in model.named_children() if n in stacks}
    assert all(d is None for d in tmesh.param_shardings(
        model.named_parameters(), tmesh.Mesh({"data": 4})).values())


def test_ffn_rule_does_not_catch_the_attention_output():
    names = ["bert.encoder.layer.11.attention.output.dense.weight",
             "bert.encoder.layer.11.attention.output.dense.bias",
             "bert.encoder.layer.11.output.dense.weight",
             "bert.encoder.layer.11.output.dense.bias",
             "cls.predictions.transform.dense.weight", "gate_net.weight",
             "integrate.weight", "cls3.weight", "classifier.bias"]
    got = tmesh.param_shardings([(n, None) for n in names],
                                tmesh.Mesh({"data": 1, "model": 2}))
    assert list(got.values()) == [1, None, 1] + [None] * 6


def test_mesh_positions_are_row_major():
    mesh = tmesh.make_mesh({"data": 2, "model": 3}, world_size=6)
    assert [(mesh.data_index(r), mesh.model_index(r)) for r in range(6)] == [
        (0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]


def test_dropout_blocks_are_the_global_mask():
    """Each rank's block of attention probabilities and of hidden rows,
    dropped with its layout, is its slice of one process's mask."""
    x = torch.rand(4, 6, 5, 5) + 0.5
    key = (123, 456)
    whole = layers.dropout(x, 0.3, key)
    for d in range(2):
        for m in range(3):
            g = MeshGroups(tmesh.Mesh({"data": 2, "model": 3}), d, m)
            block = x[2 * d:2 * d + 2, 2 * m:2 * m + 2]
            got = layers.dropout(block, 0.3, key, g.heads(block))
            assert torch.equal(got, whole[2 * d:2 * d + 2, 2 * m:2 * m + 2])
            rows = x[2 * d:2 * d + 2]
            assert torch.equal(layers.dropout(rows, 0.3, key, g.rows(rows)),
                               whole[2 * d:2 * d + 2])


def test_kernels_are_off_under_a_model_axis(caplog):
    """Without a group of its own the Trainer only checks and shards: an
    explicit use_kernels=True raises, None resolves to the plain path and
    says why, and the layers refuse the kernels."""
    groups = MeshGroups(tmesh.Mesh({"data": 1, "model": 2}))
    with pytest.raises(ValueError, match="whole hidden dim"):
        Trainer(PCFG, Realise(PCFG), device="cpu", mesh=groups,
                use_kernels=True)
    with caplog.at_level("INFO", logger="realise_tpu_torch"):
        tr = Trainer(PCFG, Realise(PCFG), device="cpu", mesh=groups)
    assert not tr.use_kernels and tr.tensor_parallel
    assert "kernels off" in caplog.text
    q = tr.model.bert.encoder.layer[0].attention.self.query.weight
    assert q.shape == (8, 16)
    layer = tr.model.bert.encoder.layer[0]
    with pytest.raises(ValueError, match="whole hidden dim"):
        layer(torch.zeros(1, 2, 16), torch.zeros(1, 1, 1, 2), use_kernels=True)


def test_model_axis_must_divide_heads_and_units():
    tmesh.make_mesh({"data": 1, "model": 4}, world_size=4, cfg=PCFG)
    for m in (3, 8):
        with pytest.raises(ValueError, match="num_attention_heads"):
            tmesh.make_mesh({"data": 1, "model": m}, world_size=m, cfg=PCFG)


# ------------------------------------------------------------- four ranks
def _jax_model():
    rng = np.random.RandomState(0)
    glyphs = (rng.rand(V, 1, 32, 32) > 0.5).astype(np.float32)
    params, state = init_realise(jax.random.PRNGKey(0), CFG, glyphs=glyphs)
    params = live_glyph_features(jax.tree.map(
        lambda x: np.asarray(x) + rng.normal(0, 0.05, np.shape(x)).astype(
            np.float32), params))
    return params, jax.tree.map(np.asarray, state)


def _jax_gspmd_step(params, state, batch):
    """The JAX Trainer's GSPMD step on data=2,model=2 (loss, params, BN
    state, Adam moments) and its gradient after the clip: the global
    batch's, one device's, clipped by global norm as optax clips it."""
    jmesh = jax_make_mesh(AXES, devices=jax.devices()[:4])
    jt = JaxTrainer(CFG, jax.tree.map(jnp.asarray, params),
                    jax.tree.map(jnp.asarray, state), mesh=jmesh,
                    **TRAINER_KW)
    assert not jt.use_pallas
    loss = float(jt.train_step(batch))
    ts = jt.train_state
    adam = [s for s in jax.tree_util.tree_leaves(
        ts.opt_state, is_leaf=lambda n: hasattr(n, "mu")) if hasattr(s, "mu")]

    def loss_sum(p):
        out = apply_realise(p, state, jax.tree.map(jnp.asarray, batch), CFG,
                            deterministic=False, rng=jax.random.PRNGKey(0),
                            train=True)
        return out["loss_sum"], out["loss_count"]

    g, count = jax.jit(jax.grad(loss_sum, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    g = jax.tree.map(lambda x: x / count, g)
    g, _ = optax.clip_by_global_norm(TRAINER_KW["max_grad_norm"]).update(
        g, optax.EmptyState())
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(loss=loss, params=as_np(ts.params), state=as_np(ts.state),
                mu=as_np(adam[0].mu), nu=as_np(adam[0].nu), grads=as_np(g))


@contextlib.contextmanager
def recorded_norms():
    """The norms the Trainer's clip returns, in order."""
    norms = []
    clip = trainer_module.clip_by_global_norm

    def recording(*a, **kw):
        norm = clip(*a, **kw)
        norms.append(float(norm))
        return norm

    trainer_module.clip_by_global_norm = recording
    try:
        yield norms
    finally:
        trainer_module.clip_by_global_norm = clip


def _copied(state):
    """A state dict's tensors copied (the live weights move on)."""
    return {k: v.clone() for k, v in state.items()}


def _one_process(sd, cfg=PCFG, **kw):
    model = Realise(cfg)
    model.load_state_dict(sd)
    return Trainer(cfg, model, device="cpu", **dict(TRAINER_KW, **kw))


def _interleaved(batch, parts=2, data=2):
    """The global rows in the order of a data×model step's microbatches:
    microbatch j is every data rank's j-th part of its rows."""
    n = len(batch["src_idx"])
    share, size = n // data, n // data // parts
    order = [d * share + j * size + i for j in range(parts)
             for d in range(data) for i in range(size)]
    return {k: np.asarray(v)[order] for k, v in batch.items()}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The ranks' results, the JAX GSPMD step's and the port's one-process
    runs of the same work, the last two computed while the ranks run."""
    work = str(tmp_path_factory.mktemp("tp_ranks"))
    params, state = _jax_model()
    sd = state_dict_from_jax(params, state, PCFG)
    batches = [_batch(20 + i, ROWS) for i in range(6)]
    inputs = {"sd": sd, "cfg": PCFG.to_dict(), "axes": AXES,
              "trainer_kw": TRAINER_KW, "batch": batches[0],
              "batch2": batches[1], "eval_batch": batches[2],
              "dropout_batches": batches[3:6]}
    with one_intra_op_thread(), recorded_norms() as norms:
        one = _one_process(sd)
        loss = float(one.train_step(batches[0]))
        one_step = {"loss": loss, "norm": norms[0],
                    "state": _copied(one.model_state_dict()),
                    "trainer_state": copy.deepcopy(one.state_dict()),
                    "opt_names": list(one._opt_names),
                    "grads": {n: p.grad.clone()
                              for n, p in one.model.named_parameters()}}
        one_step["eval"] = one.eval_step(batches[2])
        save_checkpoint(os.path.join(work, "one"), 1, one.model_state_dict(),
                        PCFG, trainer_state=one.state_dict())
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    procs = start_ranks("tensor", work, world=4)
    try:
        with one_intra_op_thread():
            one_step["loss2"] = float(one.train_step(batches[1]))
            one_step["state2"] = _copied(one.model_state_dict())
            accum = _one_process(sd, grad_accum_steps=2)
            one_accum = {"loss": float(accum.train_step(
                _interleaved(batches[0]))), "state": accum.model_state_dict()}
            dcfg = PCFG.replace(hidden_dropout_prob=0.1,
                                attention_probs_dropout_prob=0.1)
            drop = _one_process(sd, dcfg, seed=5)
            with chip_smoke.recorded_masks() as masks:
                losses = [float(drop.train_step(batches[3]))]
            losses += [float(drop.train_step(b)) for b in batches[4:6]]
            one_drop = {"losses": losses, "masks": masks,
                        "state": drop.model_state_dict()}
        jax_step = _jax_gspmd_step(params, state, batches[0])
        jax_step["forward"] = np.asarray(apply_realise(
            jax.tree.map(jnp.asarray, params), state,
            jax.tree.map(jnp.asarray, batches[2]), CFG)["logits"])
    finally:
        wait_ranks(procs)
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(4)]
    ones = {"step": one_step, "accum2": one_accum, "dropout": one_drop}
    return ranks, ones, jax_step, work


def _weights_close(got, want, lr=TRAINER_KW["learning_rate"]):
    """Adam's step is lr·m̂/(√v̂+eps): a near-zero gradient whose sign two
    summation orders disagree on moves by up to lr, so every weight within
    2 lr and 99.9% within 1e-6; the BN running statistics within 1e-5."""
    diffs = []
    for name, w in want.items():
        d = np.abs(got[name].numpy().astype(np.float64)
                   - w.numpy().astype(np.float64))
        if "running_" in name:
            assert d.max() <= BN_ATOL, (name, d.max())
        elif w.is_floating_point():
            assert d.max() <= 2 * lr, (name, d.max())
            diffs.append(d.ravel())
    assert (np.concatenate(diffs) > 1e-6).mean() < 1e-3


def test_forward_matches_the_jax_forward(four_ranks):
    """The data=1,model=2 forward (each data index's two ranks split the
    model alone) gives apply_realise's logits (tests/test_training.py's
    test_tensor_parallel_forward_matches holds the JAX GSPMD forward to
    them) within the port's forward limit of test_torch_model.py."""
    ranks, _, jax_step, _ = four_ranks
    for rank in ranks:
        np.testing.assert_allclose(rank["forward"].numpy(),
                                   jax_step["forward"], atol=1e-4)


def test_step_matches_the_jax_gspmd_step(four_ranks):
    """Rank 0's data=2,model=2 step against the JAX Trainer's on a 2×2
    mesh: the loss, the gathered gradients (after the clip), weights, BN
    running statistics and AdamW moments (m = 0.1 g, √(v / 0.001) = |g|
    after one step)."""
    ranks, _, jax_step, _ = four_ranks
    got = ranks[0]["step"]
    np.testing.assert_allclose(got["loss"], jax_step["loss"], rtol=1e-6)
    want_grads = state_dict_from_jax(jax_step["grads"], jax_step["state"],
                                     PCFG)
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(),
                                   atol=GRAD_ATOL, err_msg=name)
    want = state_dict_from_jax(jax_step["params"], jax_step["state"], PCFG)
    _weights_close(got["state"], {k: want[k] for k in got["state"]
                                  if k in got["grads"] or "running_" in k})
    mu = state_dict_from_jax(jax_step["mu"], jax_step["state"], PCFG)
    nu = state_dict_from_jax(jax_step["nu"], jax_step["state"], PCFG)
    opt = got["trainer_state"]["optimizer"]["state"]
    for i, name in enumerate(four_ranks[1]["step"]["opt_names"]):
        np.testing.assert_allclose(opt[i]["exp_avg"].numpy() / 0.1,
                                   mu[name].numpy() / 0.1, atol=GRAD_ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(
            np.sqrt(opt[i]["exp_avg_sq"].numpy() / 1e-3),
            np.sqrt(nu[name].numpy() / 1e-3), atol=GRAD_ATOL, err_msg=name)


def test_step_matches_one_process(four_ranks):
    """Every rank's step against the port's one process on the global
    batch: the loss, gradients, weights, BN statistics and moments; the
    clip's norm is one process's."""
    ranks, ones, _, _ = four_ranks
    want = ones["step"]
    for rank in ranks:
        got = rank["step"]
        assert got["splits"] and not got["use_kernels"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), want["grads"][name].numpy(),
                                       atol=GRAD_ATOL, err_msg=name)
        _weights_close(got["state"], want["state"])
        opt = got["trainer_state"]["optimizer"]["state"]
        for i, st in want["trainer_state"]["optimizer"]["state"].items():
            for m in ("exp_avg", "exp_avg_sq"):
                assert opt[i][m].shape == st[m].shape
                np.testing.assert_allclose(opt[i][m].numpy(), st[m].numpy(),
                                           atol=0.1 * GRAD_ATOL)


def test_clip_norm_is_one_process_norm(four_ranks):
    """The clip's norm: the split gradients' squares summed over the model
    group and the replicated ones counted once give one process's norm,
    the same on every rank."""
    ranks, ones, _, _ = four_ranks
    for rank in ranks:
        np.testing.assert_allclose(rank["step"]["norm"], ones["step"]["norm"],
                                   rtol=1e-5)
    assert len({r["step"]["norm"] for r in ranks}) == 1


def test_moments_are_split_like_the_params(four_ranks):
    """AdamW steps each rank's slices: its moments have the local shapes,
    and the trainer state gathers them to the full ones."""
    ranks, ones, _, _ = four_ranks
    for rank in ranks:
        assert rank["step"]["moment_shapes_local"]


def test_replicated_weights_hold_equal_bits(four_ranks):
    """After the step, every replicated parameter and buffer has the same
    bits on all four ranks, and each model group's gathered weights too."""
    ranks, _, _, _ = four_ranks
    for rank in ranks[1:]:
        for name, t in ranks[0]["step"]["replicated"].items():
            assert torch.equal(rank["step"]["replicated"][name], t), name
        for name, t in ranks[0]["step"]["state"].items():
            assert torch.equal(rank["step"]["state"][name], t), name


def test_eval_matches_one_process(four_ranks):
    """eval_step under the mesh (each data rank its rows, each model rank
    its heads): every rank gets one process's predictions and loss."""
    ranks, ones, _, _ = four_ranks
    want = ones["step"]["eval"]
    for rank in ranks:
        got = rank["step"]["eval"]
        np.testing.assert_array_equal(got["pred_idx"], want["pred_idx"])
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)


def test_dropout_masks_are_one_process_masks(four_ranks):
    """Three steps at dropout 0.1: every rank draws stream 0 and places its
    blocks by their global index, so the losses are one process's with
    the same seed and the weights follow within the limits."""
    ranks, ones, _, _ = four_ranks
    want = ones["dropout"]
    for rank in ranks:
        got = rank["dropout"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
        _weights_close(got["state"], want["state"])


def test_chip_mask_check_fails_a_missing_layout(four_ranks):
    """chip_smoke.py phase 16b's mask check (each call's kept count and
    global index sum, blocks summed over the ranks) holds the mesh's first
    dropout step to one process's, and fails the one site whose mask was
    drawn without its layout."""
    ranks, ones, _, _ = four_ranks
    want = ones["dropout"]["masks"]
    heads = [m[3] for m in want]
    assert any(heads) and not all(heads)
    got = chip_smoke.mask_agreement([r["masks"][False] for r in ranks], want,
                                    AXES["model"])
    assert got == [True] * len(want)
    planted = chip_smoke.mask_agreement([r["masks"][True] for r in ranks],
                                        want, AXES["model"])
    first = heads.index(True)
    assert [i for i, ok in enumerate(planted) if not ok] == [first]


def test_chip_weight_rule_fails_a_skipped_update(four_ranks):
    """chip_smoke.py phase 16a/16d's weight rule (none beyond 2 lr of one
    process's, at most TP_FLIP_SHARE beyond TP_NEAR lr) takes the mesh's
    step and fails it with the split weights' update skipped or
    sign-flipped."""
    ranks, ones, _, work = four_ranks
    lr = TRAINER_KW["learning_rate"]
    want = ones["step"]["state"]
    for rank in ranks:
        errors = chip_smoke.weight_errors(rank["step"]["state"], want, lr)
        assert chip_smoke.weights_agree(errors), errors
    init = torch.load(os.path.join(work, "inputs.pt"),
                      weights_only=False)["sd"]
    got, splits = ranks[0]["step"]["state"], ranks[0]["step"]["splits"]
    skipped = dict(got, **{n: init[n] for n in splits})
    errors = chip_smoke.weight_errors(skipped, want, lr)
    assert errors[2] > chip_smoke.TP_FLIP_SHARE, errors
    flipped = dict(got, **{n: 2 * init[n] - got[n] for n in splits})
    assert not chip_smoke.weights_agree(
        chip_smoke.weight_errors(flipped, want, lr))


def test_grad_accum_on_the_mesh(four_ranks):
    """grad_accum_steps=2 on data=2,model=2 is one process's accumulated
    step on the rows of its microbatches (each the union of the data
    ranks' j-th parts), BatchNorm statistics included."""
    ranks, ones, _, _ = four_ranks
    for rank in ranks:
        got = rank["accum2"]
        np.testing.assert_allclose(got["loss"], ones["accum2"]["loss"],
                                   rtol=1e-6)
        _weights_close(got["state"], ones["accum2"]["state"])


def test_checkpoint_from_the_mesh_steps_in_one_process(four_ranks):
    """The mesh's checkpoint holds the full tensors; one process loads it
    and takes the mesh's next step."""
    ranks, _, _, work = four_ranks
    ckpt = os.path.join(work, "tp", "saved_ckpt-1")
    sd = load_checkpoint(ckpt)
    state = load_trainer_state(ckpt)
    for name, t in ranks[0]["step"]["state"].items():
        assert torch.equal(sd[name], t), name
    one = _one_process(sd)
    one.load_state_dict(state)
    batch2 = torch.load(os.path.join(work, "inputs.pt"),
                        weights_only=False)["batch2"]
    loss = float(one.train_step(batch2))
    np.testing.assert_allclose(loss, ranks[0]["step"]["loss2"], rtol=1e-6)
    _weights_close(one.model_state_dict(), ranks[0]["step"]["state2"])


def test_one_process_checkpoint_steps_on_the_mesh(four_ranks):
    """A one-process checkpoint loaded onto the mesh (each rank slices the
    full tensors) takes one process's next step; so does the mesh's own."""
    ranks, ones, _, _ = four_ranks
    for rank in ranks:
        for got in (rank["resumed"], {"loss": rank["step"]["loss2"],
                                      "state": rank["step"]["state2"]}):
            np.testing.assert_allclose(got["loss"], ones["step"]["loss2"],
                                       rtol=1e-6)
            _weights_close(got["state"], ones["step"]["state2"])
