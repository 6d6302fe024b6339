"""The port's training step against the JAX package's.

A tiny arch3 (the config of tests/test_pallas.py:278-284, dropout 0) with
every parameter random is carried across with state_dict_from_jax. The JAX
state holds no pinyin vocab tables and the batch has fewer token slots than
glyph rows, so both sides run the per-token GRU and conv streams.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from realise_tpu.config import PHO2_VOCAB_SIZE, config_for
from realise_tpu.models.realise import apply_realise, init_realise
from realise_tpu.training.optim import decay_mask as jax_decay_mask
from realise_tpu.training.optim import linear_warmup_schedule as jax_schedule
from realise_tpu.training.optim import make_tx as jax_make_tx
from realise_tpu.training.trainer import Trainer as JaxTrainer
from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.models import realise as trealise
from realise_tpu_torch.models.convert import state_dict_from_jax
from realise_tpu_torch.ops import resnet as tresnet
from realise_tpu_torch.training import optim as toptim
from realise_tpu_torch.training.trainer import Trainer
from torch_port_fixtures import (live_glyph_features, live_glyph_rows,
                                 one_intra_op_thread)

V, B, S = 80, 4, 10
CFG = config_for("bert-pho2-res-arch3", vocab_size=V, hidden_size=16,
                 num_hidden_layers=1, num_attention_heads=2,
                 intermediate_size=32, pho_num_layers=1, out_num_layers=1,
                 max_seq_length=16, max_position_embeddings=16, num_fonts=1,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
PCFG = RealiseConfig.from_dict(CFG.to_dict())
# Gradients of the mean loss: the JAX package's own tolerance between its
# train kernels and the jnp path over the whole model (test_pallas.py:298).
GRAD_ATOL = 5e-5
BN_ATOL = 1e-5


@pytest.fixture(scope="module")
def jax_model():
    rng = np.random.RandomState(0)
    glyphs = (rng.rand(V, 1, 32, 32) > 0.5).astype(np.float32)
    params, state = init_realise(jax.random.PRNGKey(0), CFG, glyphs=glyphs)
    params = live_glyph_features(jax.tree.map(
        lambda x: np.asarray(x) + rng.normal(0, 0.05, np.shape(x)).astype(np.float32),
        params))
    state = jax.tree.map(np.asarray, state)
    assert live_glyph_rows(_port_model(params, state)) == V
    return params, state


def _port_model(params, state):
    model = trealise.Realise(PCFG)
    model.load_state_dict(state_dict_from_jax(params, state, PCFG))
    return model


def _batch(seed, b=B):
    r = np.random.RandomState(seed)
    masks = np.ones((b, S), np.int32)
    masks[1, 6:] = 0
    masks[-1, 4:] = 0
    loss_masks = masks.copy()
    loss_masks[:, 0] = 0
    return {"src_idx": r.randint(0, V, (b, S)).astype(np.int32),
            "tgt_idx": r.randint(0, V, (b, S)).astype(np.int32),
            "masks": masks, "loss_masks": loss_masks,
            "pho_idx": r.randint(1, PHO2_VOCAB_SIZE, (b, S, 8)).astype(np.int32),
            "pho_lens": r.randint(0, 9, (b, S)).astype(np.int32)}


def _t(batch):
    return {k: torch.as_tensor(v, dtype=torch.long) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_step(jax_model):
    """apply_realise(train=True, use_pallas=True) on batch 1: (loss sum,
    count, gradients of the mean loss, new BN state), jitted once."""
    params, state = jax_model
    batch = {k: jnp.asarray(v) for k, v in _batch(1).items()}

    def loss(p):
        out = apply_realise(p, state, batch, CFG, deterministic=False,
                            rng=jax.random.PRNGKey(3), train=True,
                            use_pallas=True)
        return out["loss"], (out["loss_sum"], out["loss_count"], out["state"])

    (_, aux), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    return aux + (grads,)


@pytest.mark.parametrize("kernels", [True, False])
def test_training_forward_matches_apply_realise(jax_model, jax_step, kernels):
    """loss_sum / loss_count, every gradient (of the mean loss) and the BN
    running statistics after the step equal apply_realise(train=True,
    use_pallas=True)'s. ``kernels`` False: the plain sub-blocks."""
    params, state = jax_model
    ls, lc, new_state, grads = jax_step
    batch = _batch(1)
    model = _port_model(params, state).train()
    out = model(_t(batch), use_kernels=kernels,
                generator=torch.Generator().manual_seed(1))
    assert "logits" not in out  # training mode builds only the loss
    assert out["loss_count"].item() == float(lc)
    np.testing.assert_allclose(out["loss_sum"].item(), float(ls), rtol=1e-6)
    (out["loss_sum"] / out["loss_count"]).backward()
    want = state_dict_from_jax(jax.tree.map(np.asarray, grads), state, PCFG)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=GRAD_ATOL, err_msg=name)
    want_state = state_dict_from_jax(params, jax.tree.map(np.asarray, new_state),
                                     PCFG)
    for name, buf in model.named_buffers():
        if "running_" in name:
            np.testing.assert_allclose(buf.numpy(), want_state[name].numpy(),
                                       atol=BN_ATOL, err_msg=name)
        elif name.endswith("num_batches_tracked"):
            assert int(buf) == 1


def test_batch_norm_train_matches_torch_module():
    """The BN train path normalizes like nn.BatchNorm2d in train mode and
    moves the running stats as it does (momentum 0.1, unbiased variance)."""
    torch.manual_seed(0)
    ref = torch.nn.BatchNorm2d(6, eps=tresnet.BN_EPS).train()
    with torch.no_grad():
        ref.weight.normal_(1, 0.2)
        ref.bias.normal_(0, 0.2)
    ours = torch.nn.BatchNorm2d(6, eps=tresnet.BN_EPS).train()
    ours.load_state_dict(ref.state_dict())
    x = torch.randn(5, 6, 4, 4) * 3 + 1
    torch.testing.assert_close(tresnet.batch_norm(ours, x), ref(x),
                               atol=2e-6, rtol=0)
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        torch.testing.assert_close(getattr(ours, name), getattr(ref, name))
    ours.eval()
    y = tresnet.batch_norm(ours, x)  # eval: the running stats, no update
    assert int(ours.num_batches_tracked) == 1
    torch.testing.assert_close(y, ref.eval()(x), atol=2e-6, rtol=0)


def test_dropout_training_is_seeded_and_masks_replay(jax_model):
    """With dropout on, a step is a pure function of the generator's seed,
    the kernel path and the plain path both drop, and they differ from the
    dropout-free forward."""
    params, state = jax_model
    cfg = PCFG.replace(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    sd = state_dict_from_jax(params, state, PCFG)
    model = trealise.Realise(cfg)
    model.load_state_dict(sd)
    batch = _t(_batch(2))
    with torch.no_grad():
        base = float(model.eval()(batch)["loss_sum"])
    model.train()
    run = lambda seed, k=True: float(model(batch, use_kernels=k, generator=(
        torch.Generator().manual_seed(seed)))["loss_sum"])
    assert run(5) == run(5)
    assert run(5) != run(6)
    assert run(5, False) == run(5, False)
    assert base not in (run(5), run(5, False))
    with pytest.raises(ValueError, match="Generator"):
        model(batch, use_kernels=True)


# ------------------------------------------------------------- optimizer
def test_decay_mask_matches_jax(jax_model):
    """decay_mask over the port's parameter names == the JAX package's
    mask mapped to torch names: no decay on biases (the GRU's too) or any
    LayerNorm (resnet_layernorm too); BN weights decayed."""
    params, state = jax_model
    jmask = jax.tree.map(lambda b: np.full((1,), float(b), np.float32),
                         jax_decay_mask(params))
    want = state_dict_from_jax(
        jax.tree.map(lambda m, p: np.broadcast_to(m, np.shape(p)) if np.ndim(p)
                     else m[0], jmask, params), state, PCFG)
    model = _port_model(params, state)
    got = dict(toptim.decay_mask(model.named_parameters()))
    assert set(got) == {n for n, _ in model.named_parameters()}
    for name, decayed in got.items():
        assert bool(want[name].reshape(-1)[0]) == decayed, name
    assert not got["pho_gru.bias_hh_l0"] and not got["resnet_layernorm.weight"]
    assert got["resnet.res_block1.residual_function.1.weight"]


@pytest.mark.parametrize("warmup, total", [(0, 7), (3, 10), (1, 4)])
def test_schedule_matches_jax(warmup, total):
    ours = toptim.linear_warmup_schedule(2e-3, warmup, total)
    theirs = jax_schedule(2e-3, warmup, total)
    for step in range(total + 3):
        np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-6,
                                   atol=1e-12)


def test_clip_by_global_norm_matches_optax():
    rng = np.random.RandomState(0)
    grads = [rng.normal(0, 1, (3, 4)).astype(np.float32),
             rng.normal(0, 1, (5,)).astype(np.float32)]
    for max_norm in (0.5, 100.0):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], optax.EmptyState())
        got = [torch.tensor(g) for g in grads]
        toptim.clip_by_global_norm(got, max_norm)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("weight_decay", [0.5, 0.0])
def test_trainer_update_matches_optax_adamw(jax_model, weight_decay):
    """Two optimizer updates of the Trainer on the same given gradients as
    the JAX package's optax chain (clip at 1.0, then AdamW with its decay
    mask), lr 1e-3. The gradients are equal on both sides, so Adam's sign
    sensitivity does not arise and the parameters agree to float rounding:
    rtol 4e-7 (3 float32 ulps of each value) plus atol 1e-7, 1e-4 of one
    update (optax takes Adam's bias corrections in float32, where
    1 - 0.999**2 keeps ~3e-5 relative error; torch in float64). At weight
    decay 0.5 a decayed parameter moves by lr·wd·|p| = 5e-4·|p| per step;
    each decayed tensor is checked to move by more than 10x the tolerance
    against optax without decay, so decay that is dropped, misgrouped or
    folded into the gradient fails."""
    params, state = jax_model
    rng = np.random.RandomState(7)
    steps = [jax.tree.map(lambda x: rng.normal(0, 0.1, np.shape(x)).astype(
        np.float32), params) for _ in range(2)]
    txs = [jax_make_tx(params, learning_rate=1e-3, weight_decay=wd,
                       max_grad_norm=1.0) for wd in (weight_decay, 0.0)]
    jps = [jax.tree.map(jnp.asarray, params)] * 2
    opt_states = [tx.init(jps[0]) for tx in txs]
    tt = Trainer(PCFG, _port_model(params, state), learning_rate=1e-3,
                 weight_decay=weight_decay, max_grad_norm=1.0, device="cpu",
                 use_kernels=False)
    plist = dict(tt.model.named_parameters())
    for g in steps:
        for i, tx in enumerate(txs):
            updates, opt_states[i] = tx.update(jax.tree.map(jnp.asarray, g),
                                               opt_states[i], jps[i])
            jps[i] = optax.apply_updates(jps[i], updates)
        tgrads = state_dict_from_jax(g, state, PCFG)
        for name, p in plist.items():
            p.grad = tgrads[name].clone()
        norm = toptim.clip_by_global_norm([p.grad for p in plist.values()],
                                          tt.max_grad_norm)
        assert norm.item() > 1.0  # the clip scales these gradients
        tt.optimizer.step()
    want, want_no_decay = (
        state_dict_from_jax(jax.tree.map(np.asarray, jp), state, PCFG)
        for jp in jps)
    mask = dict(toptim.decay_mask(plist.items()))
    for name, p in plist.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=4e-7, atol=1e-7, err_msg=name)
        decay = np.abs(want[name].numpy() - want_no_decay[name].numpy()).max()
        if weight_decay and mask[name]:
            assert decay > 10 * (4e-7 * np.abs(want[name].numpy()).max()
                                 + 1e-7), name
        else:
            assert decay == 0.0, name


# ---------------------------------------------------------------- trainer
@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_matches_jax_trainer(jax_model, accum):
    """Three steps at dropout 0 from the same weights against the JAX
    Trainer(use_pallas=True), warmup 1, weight decay 0.01, clip 1.0.

    Tolerances: the loss at every step within 1e-5. Parameters: Adam's step
    is lr·m̂/(√v̂+eps), so where a gradient is near zero its sign (which two
    float summation orders may disagree on) decides a move of up to lr per
    step; every element is held within twice the summed learning rates
    (lr is kept small for that), and 99.9% of them within 1e-6. BN running
    statistics within 5e-5."""
    params, state = jax_model
    batches = [_batch(10 + i) for i in range(3)]
    kw = dict(learning_rate=1e-5, warmup_steps=1, total_steps=10,
              weight_decay=0.01, max_grad_norm=1.0, grad_accum_steps=accum)
    jt = JaxTrainer(CFG, jax.tree.map(jnp.asarray, params),
                    jax.tree.map(jnp.asarray, state), use_pallas=True, **kw)
    want_loss = [float(jt.train_step(b)) for b in batches]
    tt = Trainer(PCFG, _port_model(params, state), use_kernels=True,
                 device="cpu", **kw)
    got_loss = [float(tt.train_step(b)) for b in batches]
    np.testing.assert_allclose(got_loss, want_loss, atol=1e-5)
    assert tt.step == 3
    want = state_dict_from_jax(jax.tree.map(np.asarray, jt.train_state.params),
                               jax.tree.map(np.asarray, jt.train_state.state),
                               PCFG)
    lr_sum = sum(tt.schedule(i) for i in range(3))
    diffs = []
    for name, p in tt.model.named_parameters():
        d = np.abs(p.detach().numpy() - want[name].numpy())
        assert d.max() <= 2 * lr_sum, (name, d.max())
        diffs.append(d.ravel())
    assert (np.concatenate(diffs) > 1e-6).mean() < 1e-3
    for name, buf in tt.model.named_buffers():
        if "running_" in name:
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                       atol=5e-5, err_msg=name)


def test_trainer_fit_and_device_rules(jax_model, monkeypatch):
    params, state = jax_model
    tt = Trainer(PCFG, _port_model(params, state), learning_rate=1e-3,
                 device="cpu", use_kernels=False)
    seen = []
    summary = tt.fit(iter([_batch(i) for i in range(5)]), max_steps=3,
                     logging_steps=1, save_steps=2,
                     save_fn=lambda step, tr: seen.append(step),
                     log_fn=lambda rec: seen.append(rec["step"]))
    assert summary["steps"] == 3 and np.isfinite(summary["final_loss"])
    assert seen == [1, 2, 2, 3]
    with pytest.raises(ValueError, match="microbatches"):
        Trainer(PCFG, _port_model(params, state), device="cpu",
                grad_accum_steps=3).train_step(_batch(0))
    with pytest.raises(ValueError, match="gelu"):
        Trainer(PCFG.replace(hidden_act="relu"), _port_model(params, state),
                device="cpu", use_kernels=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(PCFG, _port_model(params, state))


def test_fit_dispatch_matches_jax_fit(jax_model):
    """``fit`` returns the JAX ``fit``'s keys, ``dispatch`` among them with
    the JAX ``StepTimer`` summary's keys; four steps after a warm-up window
    of two leave two timed steps on both sides."""
    params, state = jax_model
    batches = [_batch(20 + i) for i in range(4)]
    kw = dict(learning_rate=1e-5, warmup_steps=1, total_steps=10)
    jt = JaxTrainer(CFG, jax.tree.map(jnp.asarray, params),
                    jax.tree.map(jnp.asarray, state), use_pallas=True, **kw)
    want = jt.fit(iter(batches), max_steps=4, logging_steps=0)
    tt = Trainer(PCFG, _port_model(params, state), use_kernels=True,
                 device="cpu", **kw)
    with one_intra_op_thread():
        got = tt.fit(iter(batches), max_steps=4, logging_steps=0)
    assert set(got) == set(want)
    assert set(got["dispatch"]) == set(want["dispatch"])
    assert got["dispatch"]["steps"] == want["dispatch"]["steps"] == 2
    assert not got["dispatch"]["includes_warmup"]
    assert got["dispatch"]["p95_s"] >= got["dispatch"]["p50_s"] > 0
    np.testing.assert_allclose(got["final_loss"], want["final_loss"], atol=1e-5)


def test_fit_takes_no_batch_past_max_steps(jax_model):
    """A second ``fit`` on the same stream starts at the next batch (the
    traced first steps of ``cli/train``), and a ``fit`` already at its
    ``max_steps`` takes none: step k trains on batch k."""
    params, state = jax_model
    taken = []

    def stream():
        for i in range(6):
            taken.append(i)
            yield _batch(30 + i)

    tt = Trainer(PCFG, _port_model(params, state), learning_rate=1e-3,
                 device="cpu", use_kernels=False)
    it = stream()
    with one_intra_op_thread():
        tt.fit(it, max_steps=2, logging_steps=0)
        tt.fit(it, max_steps=2, logging_steps=0)
        assert taken == [0, 1] and tt.step == 2
        tt.fit(it, max_steps=4, logging_steps=0)
    assert taken == [0, 1, 2, 3] and tt.step == 4
