"""The port's arch3 model (realise_tpu_torch/models) against apply_realise.

JAX weights are carried across with state_dict_from_jax; batches are made
with numpy from a seed. f32 throughout, logits within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realise_tpu.config import MODEL_PRESETS, PHO2_VOCAB_SIZE, config_for
from realise_tpu.models.realise import (
    apply_realise,
    init_realise,
    precompute_inference_tables,
)
from realise_tpu.models.torch_import import import_realise_state_dict, overlay_params
from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.models import realise as trealise
from realise_tpu_torch.models.convert import state_dict_from_jax
from realise_tpu_torch.training import checkpoint as tckpt
from torch_port_fixtures import live_glyph_features, live_glyph_rows

TOL = 1e-4
V, B, S = 80, 2, 10
CFG = config_for("bert-pho2-res-arch3", vocab_size=V, hidden_size=24,
                 num_hidden_layers=2, num_attention_heads=3,
                 intermediate_size=48, max_position_embeddings=32,
                 pho_num_layers=1, out_num_layers=2, num_fonts=2)
PCFG = RealiseConfig.from_dict(CFG.to_dict())
DERIVED = ("res_uniq_images_nhwc", "res_uniq_images", "res_uniq_inverse",
           "pho_vocab_idx", "pho_vocab_lens", "pho_uniq_idx", "pho_uniq_lens",
           "pho_uniq_inverse")


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def pair():
    """JAX (params, state) with every parameter random, and the port model
    holding the same weights, its glyph features live on every row."""
    rng = np.random.RandomState(0)
    glyphs = (rng.rand(V, 2, 32, 32) > 0.5).astype(np.float32)
    params, state = init_realise(jax.random.PRNGKey(0), CFG, glyphs=glyphs)
    params = live_glyph_features(jax.tree.map(
        lambda x: np.asarray(x) + rng.normal(0, 0.05, np.shape(x)).astype(np.float32),
        params))
    state = dict(jax.tree.map(np.asarray, state))
    state["resnet"] = jax.tree.map(
        lambda x: np.abs(x + rng.normal(0, 0.2, x.shape)).astype(np.float32),
        state["resnet"])
    model = trealise.Realise(PCFG)
    model.load_state_dict(state_dict_from_jax(params, state, PCFG))
    assert live_glyph_rows(model) == V
    return params, state, model.eval()


def _batch(seed=1):
    rng = np.random.RandomState(seed)
    masks = np.ones((B, S), np.int32)
    masks[1, 6:] = 0
    return {"src_idx": rng.randint(0, V, (B, S)).astype(np.int32),
            "masks": masks,
            "pho_idx": rng.randint(1, PHO2_VOCAB_SIZE,
                                   (B, S, CFG.pho2_max_len)).astype(np.int32),
            "pho_lens": rng.randint(0, CFG.pho2_max_len + 1, (B, S)).astype(np.int32)}


def _vocab_pho(seed=2):
    rng = np.random.RandomState(seed)
    return (rng.randint(1, PHO2_VOCAB_SIZE, (V, CFG.pho2_max_len)).astype(np.int32),
            rng.randint(0, CFG.pho2_max_len + 1, (V,)).astype(np.int32))


def _port_batch(batch):
    return {k: torch.as_tensor(v, dtype=torch.long) for k, v in batch.items()}


def test_state_dict_covers_every_leaf(pair):
    """The converted dict loads strictly and accounts for every element of
    every JAX leaf the arch3 forward reads."""
    params, state, _ = pair
    sd = state_dict_from_jax(params, state, PCFG)
    trealise.Realise(PCFG).load_state_dict(sd, strict=True)
    jax_leaves = jax.tree.leaves(params) + jax.tree.leaves(
        {k: v for k, v in state.items() if k not in DERIVED})
    assert sum(np.size(x) for x in jax_leaves) == sum(
        t.numel() for k, t in sd.items() if not k.endswith("num_batches_tracked"))


def test_round_trip_through_torch_import(pair):
    """port state dict → import_realise_state_dict + overlay_params (the JAX
    package's own importer) gives back the same arrays."""
    params, state, model = pair
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    imported_p, imported_s = import_realise_state_dict(sd, CFG)
    base_p, base_s = init_realise(jax.random.PRNGKey(7), CFG)
    got_p = overlay_params(jax.tree.map(np.asarray, base_p), imported_p)
    got_s = overlay_params(jax.tree.map(np.asarray, base_s), imported_s)
    jax.tree.map(np.testing.assert_array_equal, got_p, params)
    jax.tree.map(np.testing.assert_array_equal, got_s["resnet"], state["resnet"])
    np.testing.assert_array_equal(got_s["char_images"], state["char_images"])


@pytest.mark.parametrize("with_tables", [False, True])
@pytest.mark.parametrize("kernels", [False, True])
def test_forward_matches_apply_realise(pair, kernels, with_tables):
    """The whole tiny arch3 forward; ``kernels`` pairs use_pallas (interpret)
    with use_kernels (the plain kernel versions on the CPU)."""
    params, state, model = pair
    batch = _batch()
    jtables = ttables = None
    if with_tables:
        idx, lens = _vocab_pho()
        jtables = precompute_inference_tables(params, state, CFG, idx, lens)
        ttables = trealise.precompute_inference_tables(model, idx, lens)
    want = apply_realise(params, state, {k: jnp.asarray(v) for k, v in batch.items()},
                         CFG, use_pallas=kernels, return_gates=True,
                         inference_tables=jtables)
    with torch.inference_mode():
        got = model(_port_batch(batch), tables=ttables, use_kernels=kernels,
                    return_gates=True)
    np.testing.assert_allclose(_np(got["logits"]), np.asarray(want["logits"]),
                               atol=TOL)
    np.testing.assert_allclose(_np(got["gates"]), np.asarray(want["gates"]),
                               atol=TOL)


def test_inference_tables_match(pair):
    params, state, model = pair
    idx, lens = _vocab_pho()
    want = precompute_inference_tables(params, state, CFG, idx, lens,
                                       batch_size=32)
    got = trealise.precompute_inference_tables(model, idx, lens, batch_size=32)
    assert set(got) == set(want) == {"res", "pho"}
    for k in want:
        assert tuple(got[k].shape) == (V, CFG.hidden_size)
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), atol=TOL)


def test_golden_checkpoint_matches_apply_realise():
    """The committed JAX golden checkpoint, restored by the JAX package and
    converted, gives apply_realise's logits."""
    import os

    from realise_tpu.training.checkpoint import load_checkpoint, load_config

    ckpt = os.path.join(os.path.dirname(__file__), "golden", "ckpt_arch3",
                        "saved_ckpt-3")
    cfg = load_config(ckpt)
    restored = load_checkpoint(ckpt)
    params, state = restored["params"], restored["state"]
    pcfg = RealiseConfig.load(ckpt)
    model = trealise.Realise(pcfg)
    model.load_state_dict(state_dict_from_jax(params, state, pcfg))
    rng = np.random.RandomState(3)
    batch = {"src_idx": rng.randint(0, cfg.vocab_size, (3, 12)).astype(np.int32),
             "masks": np.ones((3, 12), np.int32),
             "pho_idx": rng.randint(1, PHO2_VOCAB_SIZE, (3, 12, 8)).astype(np.int32),
             "pho_lens": rng.randint(0, 9, (3, 12)).astype(np.int32)}
    batch["masks"][2, 5:] = 0
    want = apply_realise(jax.tree.map(jnp.asarray, params),
                         jax.tree.map(jnp.asarray, state),
                         {k: jnp.asarray(v) for k, v in batch.items()}, cfg)
    with torch.inference_mode():
        got = model.eval()(_port_batch(batch))
    np.testing.assert_allclose(_np(got["logits"]), np.asarray(want["logits"]),
                               atol=TOL)


def test_port_checkpoint_round_trip(pair, tmp_path):
    _, _, model = pair
    path = tckpt.save_checkpoint(str(tmp_path), 5, model.state_dict(), PCFG)
    assert tckpt.list_checkpoints(str(tmp_path)) == [(5, path)]
    assert tckpt.load_config(path) == PCFG
    back = trealise.Realise(tckpt.load_config(path))
    back.load_state_dict(tckpt.load_checkpoint(path))
    batch = _port_batch(_batch(seed=4))
    with torch.inference_mode():
        np.testing.assert_array_equal(_np(back(batch)["logits"]),
                                      _np(model(batch)["logits"]))


def test_unported_configs_raise():
    """build_model builds every preset of MODEL_PRESETS, a pretraining stage
    as RealisePretrain; Realise refuses a pretraining config, naming
    RealisePretrain."""
    for model_type in MODEL_PRESETS:
        cfg = RealiseConfig.from_dict(config_for(
            model_type, vocab_size=V, hidden_size=24, num_hidden_layers=1,
            num_attention_heads=3, intermediate_size=48,
            pho_num_layers=1).to_dict())
        model = trealise.build_model(cfg)
        pretrain = cfg.fusion == "pretrain"
        assert type(model) is (trealise.RealisePretrain if pretrain
                               else trealise.Realise), model_type
        if pretrain:
            with pytest.raises(ValueError, match="RealisePretrain"):
                trealise.Realise(cfg)
