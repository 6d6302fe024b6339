"""Every fine-tuning preset of the port against the JAX package's.

The twelve configs: the fine-tuning presets of config.MODEL_PRESETS but
arch3 (bert, the four merged ones, arch2, arch3-mlm and arch4; arch3 is
tests/test_torch_model.py's) and the four ablation overrides on arch3 as
the CLIs set them (--with_pho no, --with_res no, --fusion sum,
--image_model_type 1). Each is built tiny (one semantic
layer, one pho layer, the preset's output block cut to one layer or none),
with every JAX parameter random from a numpy seed, carried across with
state_dict_from_jax. Logits, gates and the (V, H) tables agree within 1e-4
in float32 (the arch3 tests' limit). The train step of each config is
tests/test_torch_presets_train.py's, the CLIs and the Corrector
tests/test_torch_presets_cli.py's; both build on the configs and helpers
here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realise_tpu.cli.common import add_common_args as j_add_common_args
from realise_tpu.cli.common import build_config as j_build_config
from realise_tpu.config import PHO2_VOCAB_SIZE, config_for
from realise_tpu.models.realise import (
    apply_realise,
    init_realise,
    precompute_inference_tables,
)
from realise_tpu.models.torch_import import import_realise_state_dict, overlay_params
from realise_tpu_torch.cli.common import add_common_args, build_config
from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.models import realise as trealise
from realise_tpu_torch.models.convert import state_dict_from_jax
from torch_port_fixtures import live_glyph_features

V, B, S, P = 80, 2, 10, 8
TOL = 1e-4
TINY = dict(vocab_size=V, hidden_size=24, num_hidden_layers=1,
            num_attention_heads=3, intermediate_size=48,
            max_position_embeddings=32, max_seq_length=32, pho_num_layers=1)
ARCH3 = "bert-pho2-res-arch3"
# name → (model_type, the overrides build_config sets for the CLI flags).
CONFIGS = {
    "bert": ("bert", {}),
    "bert-pho1": ("bert-pho1", {}),
    "bert-pho2": ("bert-pho2", {}),
    "bert-pho1-res": ("bert-pho1-res", {}),
    "bert-pho2-res": ("bert-pho2-res", {}),
    "bert-pho2-res-arch2": ("bert-pho2-res-arch2", {}),
    "bert-pho2-res-arch3-mlm": ("bert-pho2-res-arch3-mlm", {}),
    "bert-pho2-res-arch4": ("bert-pho2-res-arch4", {}),
    "with_pho=no": (ARCH3, {"pho_encoder": "none"}),
    "with_res=no": (ARCH3, {"res_encoder": "none"}),
    "fusion=sum": (ARCH3, {"fusion": "sum"}),
    "image_model_type=1": (ARCH3, {"res_encoder": "resnet1"}),
}
FLAGS = {
    "with_pho=no": ["--with_pho", "no"],
    "with_res=no": ["--with_res", "no"],
    "fusion=sum": ["--fusion", "sum"],
    "image_model_type=1": ["--image_model_type", "1"],
}
# One config per new wiring runs the JAX side's Pallas kernels (interpret
# mode) against the port's kernel route (their plain versions on the CPU).
PALLAS = ("bert-pho2-res", "bert-pho2-res-arch2", "bert-pho2-res-arch3-mlm",
          "image_model_type=1", "with_pho=no")
DERIVED = ("res_uniq_images_nhwc", "res_uniq_images", "res_uniq_inverse",
           "pho_vocab_idx", "pho_vocab_lens", "pho_uniq_idx", "pho_uniq_lens",
           "pho_uniq_inverse")


def jax_config(name, **kw):
    model_type, overrides = CONFIGS[name]
    base = config_for(model_type)
    out = min(base.out_num_layers, 1)
    return config_for(model_type, **dict(TINY, out_num_layers=out, **overrides,
                                         **kw))


def _np(t):
    return t.detach().float().numpy()


def vocab_tables(seed=2):
    """Random (V, P) pinyin ids + (V,) lengths and (V, 3) pho1 ids: the
    featurizer's tables for this test's vocab."""
    rng = np.random.RandomState(seed)
    return (rng.randint(1, PHO2_VOCAB_SIZE, (V, P)).astype(np.int32),
            rng.randint(0, P + 1, (V,)).astype(np.int32),
            rng.randint(0, 65, (V, 3)).astype(np.int32))


def make_batch(seed, b, s, targets=False):
    """src/masks (+ targets), with the pinyin features a featurizer would
    gather from the vocab tables."""
    rng = np.random.RandomState(seed)
    masks = np.ones((b, s), np.int32)
    masks[1, s // 2:] = 0
    src = rng.randint(0, V, (b, s)).astype(np.int32)
    idx, lens, pho1 = vocab_tables()
    batch = {"src_idx": src, "masks": masks, "pho_idx": idx[src],
             "pho_lens": lens[src], "pho1_idx": pho1[src]}
    if targets:
        loss_masks = masks.copy()
        loss_masks[:, 0] = 0
        batch.update(tgt_idx=rng.randint(0, V, (b, s)).astype(np.int32),
                     loss_masks=loss_masks)
    return batch


def _t(batch):
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.long)
            for k, v in batch.items()}


class Pair:
    """A JAX (params, state) with every parameter random, and the port model
    of the same weights."""

    def __init__(self, name):
        self.name = name
        self.cfg = jax_config(name)
        self.pcfg = RealiseConfig.from_dict(self.cfg.to_dict())
        rng = np.random.RandomState(sum(map(ord, name)))
        glyphs = (rng.rand(V, self.cfg.num_fonts, 32, 32) > 0.5).astype(np.float32)
        glyphs[rng.rand(V) < 0.6] = 0.0  # shared zero images: the dedup runs
        idx, lens, _ = vocab_tables()
        params, state = init_realise(
            jax.random.PRNGKey(0), self.cfg,
            glyphs=glyphs if self.cfg.with_res else None)
        self.params = live_glyph_features(jax.tree.map(
            lambda x: np.asarray(x)
            + rng.normal(0, 0.05, np.shape(x)).astype(np.float32), params))
        state = dict(jax.tree.map(np.asarray, state))
        if "resnet" in state:
            state["resnet"] = jax.tree.map(
                lambda x: np.abs(x + rng.normal(0, 0.2, x.shape)).astype(np.float32),
                state["resnet"])
        self.state = state
        # The same state with the pinyin tables: the JAX factorized GRU.
        self.fstate = init_realise(jax.random.PRNGKey(0), self.cfg,
                                   pho_tables=(idx, lens))[1]
        self.fstate.update(state)
        self.fstate = dict(self.fstate)

    def model(self):
        m = trealise.Realise(self.pcfg)
        m.load_state_dict(state_dict_from_jax(self.params, self.state,
                                              self.pcfg))
        idx, lens, _ = vocab_tables()
        m.install_pho_vocab_tables(idx, lens)
        return m


_PAIRS = {}


@pytest.fixture(params=list(CONFIGS))
def pair(request):
    if request.param not in _PAIRS:
        _PAIRS[request.param] = Pair(request.param)
    return _PAIRS[request.param]


def test_config_wiring(pair):
    """The depth per config (the encoder stacks the kernels carry), the
    parts each preset has, and glyph features that are not zero and differ
    from glyph to glyph (the other tests read them)."""
    cfg, m = pair.pcfg, pair.model()
    if cfg.with_res:
        with torch.inference_mode():
            feats = _np(m.res_features(torch.arange(V)))
        assert (np.abs(feats).sum(1) > 0).all()
        assert len(np.unique(feats.round(4), axis=0)) > V // 4
    stacks = [m.bert] + [getattr(m, n) for n in ("pho_model", "output_block")
                         if getattr(m, n, None) is not None]
    assert sum(len(s.encoder.layer) for s in stacks) == (
        1 + cfg.with_pho + cfg.out_num_layers)
    names = {k.split(".")[0] for k in m.state_dict()}
    assert ("char_images_multifonts" in names) == cfg.with_res
    assert ("resnet_layernorm" in names) == (cfg.with_res
                                             and cfg.fusion != "merged")
    assert ("integrate" in names) == (cfg.fusion in ("merged", "concat"))
    assert ("gate_net" in names) == (cfg.fusion in ("gate", "softmax_gate"))
    assert ("cls" in names) == (cfg.head == "mlm")
    assert ("pho_gru" in names) == (cfg.pho_encoder == "pho2")


def test_state_dict_covers_every_leaf(pair):
    """The converted dict loads strictly and accounts for every element of
    every JAX leaf."""
    sd = state_dict_from_jax(pair.params, pair.state, pair.pcfg)
    trealise.Realise(pair.pcfg).load_state_dict(sd, strict=True)
    leaves = jax.tree.leaves(pair.params) + jax.tree.leaves(
        {k: v for k, v in pair.state.items() if k not in DERIVED})
    assert sum(np.size(x) for x in leaves) == sum(
        t.numel() for k, t in sd.items() if not k.endswith("num_batches_tracked"))


def test_round_trip_through_torch_import(pair):
    """port state dict → the JAX package's import_realise_state_dict +
    overlay_params gives back the same arrays."""
    sd = {k: v.numpy() for k, v in pair.model().state_dict().items()}
    imported_p, imported_s = import_realise_state_dict(sd, pair.cfg)
    base_p, base_s = init_realise(jax.random.PRNGKey(7), pair.cfg)
    got_p = overlay_params(jax.tree.map(np.asarray, base_p), imported_p)
    jax.tree.map(np.testing.assert_array_equal, got_p, pair.params)
    if pair.cfg.with_res:
        got_s = overlay_params(jax.tree.map(np.asarray, base_s), imported_s)
        jax.tree.map(np.testing.assert_array_equal, got_s["resnet"],
                     pair.state["resnet"])
        np.testing.assert_array_equal(got_s["char_images"],
                                      pair.state["char_images"])


@pytest.mark.parametrize("with_tables", [False, True])
def test_forward_matches_apply_realise(pair, with_tables):
    """Logits (and gates) of the deterministic forward, per token or from
    the inference tables."""
    m = pair.model()
    batch = make_batch(1, B, S)
    jtables = ttables = None
    if with_tables:
        idx, lens, _ = vocab_tables()
        jtables = precompute_inference_tables(pair.params, pair.state,
                                              pair.cfg, idx, lens)
        ttables = trealise.precompute_inference_tables(m, idx, lens)
    want = apply_realise(pair.params, pair.state,
                         {k: jnp.asarray(v) for k, v in batch.items()},
                         pair.cfg, return_gates=True, inference_tables=jtables)
    with torch.inference_mode():
        got = m(_t(batch), tables=ttables, return_gates=True)
    np.testing.assert_allclose(_np(got["logits"]), np.asarray(want["logits"]),
                               atol=TOL)
    assert ("gates" in got) == ("gates" in want)
    if "gates" in want:
        assert got["gates"].shape[-1] == pair.cfg.num_streams
        np.testing.assert_allclose(_np(got["gates"]), np.asarray(want["gates"]),
                                   atol=TOL)


def test_inference_tables_match(pair):
    """The 'res' table (raw features, either variant) for a glyph stream and
    the 'pho' table for pho2 only, as the JAX package builds them."""
    idx, lens, _ = vocab_tables()
    want = precompute_inference_tables(pair.params, pair.state, pair.cfg,
                                       idx, lens, batch_size=32)
    got = trealise.precompute_inference_tables(pair.model(), idx, lens,
                                               batch_size=32)
    assert set(got) == set(want)
    assert ("res" in got) == pair.cfg.with_res
    assert ("pho" in got) == (pair.cfg.pho_encoder == "pho2")
    for k in want:
        assert tuple(got[k].shape) == (V, pair.cfg.hidden_size)
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), atol=TOL)


@pytest.mark.parametrize("name", PALLAS)
def test_kernel_route_matches_pallas(name):
    """The port's kernel route against apply_realise(use_pallas=True) (the
    Pallas kernels in interpret mode), once per new wiring."""
    if name not in _PAIRS:
        _PAIRS[name] = Pair(name)
    pair = _PAIRS[name]
    batch = make_batch(4, B, S)
    want = apply_realise(pair.params, pair.state,
                         {k: jnp.asarray(v) for k, v in batch.items()},
                         pair.cfg, use_pallas=True, return_gates=True)
    model = pair.model()
    with torch.inference_mode():
        got = model(_t(batch), use_kernels=True, return_gates=True)
    np.testing.assert_allclose(_np(got["logits"]), np.asarray(want["logits"]),
                               atol=TOL)
    if "gates" in want:
        np.testing.assert_allclose(_np(got["gates"]), np.asarray(want["gates"]),
                                   atol=TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("extra", [[], ["--resfonts", "font1", "--tiny"]])
def test_build_config_matches_jax(name, extra):
    """cli/common.build_config of the port equals the JAX package's for each
    config's flags (a merged preset's one font overridden by --resfonts,
    as the JAX package does)."""
    import argparse

    model_type = CONFIGS[name][0]
    argv = (["--model_type", model_type, "--output_dir", "x"]
            + FLAGS.get(name, []) + extra)
    ours = build_config(add_common_args(argparse.ArgumentParser())
                        .parse_args(argv), 21128)
    theirs = j_build_config(j_add_common_args(argparse.ArgumentParser())
                            .parse_args(argv), 21128)
    assert ours.to_dict() == theirs.to_dict()
    with torch.device("meta"):
        assert type(trealise.build_model(ours)) is trealise.Realise
