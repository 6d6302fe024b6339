"""The port's layers (realise_tpu_torch/ops) against the JAX package's, f32.

Weights and inputs are made with numpy from a seed and handed to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realise_tpu.config import config_for
from realise_tpu.ops.bert import bert_model, init_bert_model
from realise_tpu.ops.fusion import gate_fusion, masked_mean_pool
from realise_tpu.ops.gru import gru_last_hidden
from realise_tpu.ops.resnet import char_resnet, init_char_resnet
from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.models.convert import (
    bert_state_dict,
    char_resnet_state_dict,
)
from realise_tpu_torch.ops import bert as tbert
from realise_tpu_torch.ops import fusion as tfusion
from realise_tpu_torch.ops import gru as tgru
from realise_tpu_torch.ops import resnet as tresnet

TOL = 2e-5
CFG = config_for("bert-pho2-res-arch3", vocab_size=40, hidden_size=24,
                 num_hidden_layers=2, num_attention_heads=3,
                 intermediate_size=48, max_seq_length=12,
                 max_position_embeddings=16)
PCFG = RealiseConfig.from_dict(CFG.to_dict())


def _randomize(tree, rng, scale=0.1):
    """Every leaf of a JAX param tree made random (biases and LN included),
    as numpy."""
    return jax.tree.map(
        lambda x: np.asarray(x) + rng.normal(0, scale, np.shape(x)).astype(np.float32),
        tree)


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def bert_pair():
    rng = np.random.RandomState(0)
    params = _randomize(init_bert_model(jax.random.PRNGKey(0), CFG, 2), rng)
    model = tbert.BertModel(PCFG, 2)
    model.load_state_dict(bert_state_dict(params, 2))
    return params, model


@pytest.mark.parametrize("kernels", [False, True])
def test_bert_stack_matches_bert_model(bert_pair, kernels):
    """input_ids + padded rows; the kernel route runs the plain kernel
    versions on the CPU against JAX's interpret-mode Pallas kernels."""
    params, model = bert_pair
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 40, (3, 10))
    mask = np.ones((3, 10), np.int32)
    mask[1, 6:] = 0
    mask[2, 3:] = 0
    want = bert_model(params, CFG, input_ids=jnp.asarray(ids),
                      attention_mask=jnp.asarray(mask), use_pallas=kernels)
    got = model(input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask),
                use_kernels=kernels)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL)


def test_bert_stack_inputs_embeds_zero_positions(bert_pair):
    params, model = bert_pair
    rng = np.random.RandomState(2)
    emb = rng.normal(0, 1, (2, 9, 24)).astype(np.float32)
    mask = np.ones((2, 9), np.int32)
    mask[0, 4:] = 0
    pos = np.zeros((2, 9), np.int64)
    types = rng.randint(0, 2, (2, 9))
    want = bert_model(params, CFG, inputs_embeds=jnp.asarray(emb),
                      attention_mask=jnp.asarray(mask),
                      position_ids=jnp.asarray(pos),
                      token_type_ids=jnp.asarray(types))
    got = model(inputs_embeds=torch.tensor(emb),
                attention_mask=torch.tensor(mask),
                position_ids=torch.tensor(pos), token_type_ids=torch.tensor(types))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL)


def test_attention_bias_matches():
    from realise_tpu.ops.bert import attention_bias_from_mask

    mask = np.array([[1, 1, 0], [1, 0, 0]], np.int32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(attention_bias_from_mask(jnp.asarray(mask), jdt)
                          .astype(jnp.float32))
        got = _np(tbert.attention_bias_from_mask(torch.tensor(mask), tdt))
        np.testing.assert_array_equal(got, want)


def test_gru_matches_gru_last_hidden_incl_length_zero():
    rng = np.random.RandomState(3)
    d, h, n, p = 12, 16, 7, 5
    w_ih = rng.normal(0, 0.3, (d, 3 * h)).astype(np.float32)
    w_hh = rng.normal(0, 0.3, (h, 3 * h)).astype(np.float32)
    b_ih = rng.normal(0, 0.1, (3 * h,)).astype(np.float32)
    b_hh = rng.normal(0, 0.1, (3 * h,)).astype(np.float32)
    x = rng.normal(0, 1, (n, p, d)).astype(np.float32)
    lens = np.array([0, 1, 5, 3, 0, 2, 4], np.int32)
    want = gru_last_hidden({"w_ih": w_ih, "w_hh": w_hh, "b_ih": b_ih,
                            "b_hh": b_hh}, jnp.asarray(x), jnp.asarray(lens))
    got = tgru.gru_last_hidden(torch.tensor(w_ih.T), torch.tensor(w_hh.T),
                               torch.tensor(b_ih), torch.tensor(b_hh),
                               torch.tensor(x), torch.tensor(lens))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL)
    assert not _np(got)[[0, 4]].any()  # length 0 → the zero state


def test_char_resnet_eval_matches():
    """Eval-mode CharResNet with non-trivial BN statistics, NCHW/OIHW in the
    port vs NHWC/HWIO in JAX."""
    rng = np.random.RandomState(4)
    hidden, fonts = 24, 2
    params, state = init_char_resnet(jax.random.PRNGKey(1), fonts, "resnet",
                                     hidden)
    params = _randomize(params, rng)
    state = jax.tree.map(
        lambda x: np.abs(np.asarray(x) + rng.normal(0, 0.2, np.shape(x))
                         ).astype(np.float32), state)
    x = (rng.rand(5, fonts, 32, 32) > 0.5).astype(np.float32)
    want, _ = char_resnet(params, state, jnp.asarray(x.transpose(0, 2, 3, 1)),
                          train=False, variant="resnet", hidden_size=hidden)

    net = tresnet.CharResNet(fonts, hidden)
    net.load_state_dict(char_resnet_state_dict(params, state))
    with torch.no_grad():
        got = net(torch.tensor(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("softmax_gate", [False, True])
def test_gate_fusion_matches_with_gates(softmax_gate):
    rng = np.random.RandomState(5)
    h = 8
    streams = [rng.normal(0, 1, (2, 6, h)).astype(np.float32) for _ in range(3)]
    mask = np.ones((2, 6), np.int32)
    mask[1, 2:] = 0
    w = rng.normal(0, 0.3, (4 * h, 3)).astype(np.float32)
    b = rng.normal(0, 0.1, (3,)).astype(np.float32)
    want, want_g = gate_fusion({"gate_net": {"kernel": w, "bias": b}},
                               [jnp.asarray(s) for s in streams],
                               jnp.asarray(mask), softmax_gate=softmax_gate,
                               return_gates=True)
    got, got_g = tfusion.gate_fusion(
        torch.tensor(w.T), torch.tensor(b), [torch.tensor(s) for s in streams],
        torch.tensor(mask), softmax_gate=softmax_gate, return_gates=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(_np(got_g), np.asarray(want_g), atol=TOL)


def test_masked_mean_pool_matches():
    rng = np.random.RandomState(6)
    x = rng.normal(0, 1, (3, 5, 4)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]], np.int32)
    want = masked_mean_pool(jnp.asarray(x), jnp.asarray(mask))
    got = tfusion.masked_mean_pool(torch.tensor(x), torch.tensor(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)
