"""The pretraining stages of the port (RealisePretrain, the pretraining
Trainer, their weights and the merge) against the JAX package's.

The three stages (pho2-pretrain, res-pretrain, pho2-res-pretrain) are built
tiny (one pho layer, H=24), every JAX parameter and BatchNorm statistic
random from a numpy seed, the CharResNet's glyph features live
(live_glyph_features), and carried across with state_dict_from_jax. In
float32 at dropout 0 a train step agrees with jax.value_and_grad of
apply_pretrain within phase 8's limits of chip_smoke.py (the loss sum within
1e-5 relative, each gradient within 1.5e-3 of its largest |value|, the
BatchNorm running statistics within 1e-5), and the deterministic logits
within 1e-4 (the arch3 tests' limit). The BatchNorm statistics take 2e-5 of
their value on top of 1e-5: res-pretrain's per-token conv reaches the JAX
package's unweighted batch variance (``x32.var``, accumulated in float32),
the port accumulates in float64 (ops/resnet.batch_norm_train), and with the
glyph features live a channel's variance reaches ~13 (the worst statistic
of 30 reads 3.5e-5 apart at 2.24). The CLIs are
tests/test_torch_pretrain_cli.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ref
from realise_tpu.config import PHO2_VOCAB_SIZE, config_for
from realise_tpu.data.dataset import synthetic_dataset as j_synthetic_dataset
from realise_tpu.data.features import Featurizer as JFeaturizer
from realise_tpu.models.realise import apply_pretrain, init_pretrain, init_realise
from realise_tpu.models.torch_import import (
    import_checkpoint_dir as j_import_checkpoint_dir,
    import_realise_state_dict,
    merge_torch_state_dicts as j_merge_torch_state_dicts,
    overlay_params,
)
from realise_tpu.text.tokenizer import WordPieceTokenizer as JTokenizer
from realise_tpu.training.merge import graft_mlm_head_from_hf as j_graft
from realise_tpu.training.merge import merge_params
from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.data.dataset import synthetic_dataset
from realise_tpu_torch.data.features import Featurizer
from realise_tpu_torch.models import realise as trealise
from realise_tpu_torch.models import torch_import as timport
from realise_tpu_torch.models.convert import state_dict_from_jax
from realise_tpu_torch.text.tokenizer import WordPieceTokenizer
from realise_tpu_torch.text.vocab import build_synthetic_vocab, vocab_to_dict
from realise_tpu_torch.training import checkpoint as tckpt
from realise_tpu_torch.training.merge import graft_mlm_head_from_hf, merge_state_dicts
from torch_port_fixtures import live_glyph_features, live_glyph_rows

V, P = 80, 8
LOGIT_TOL, LOSS_REL, GRAD_REL, BN_ATOL, BN_RTOL = 1e-4, 1e-5, 1.5e-3, 1e-5, 2e-5
TINY = dict(vocab_size=V, hidden_size=24, num_hidden_layers=1,
            num_attention_heads=3, intermediate_size=48, pho_num_layers=1,
            max_position_embeddings=32, max_seq_length=32, num_fonts=2)
STAGES = ("pho2-pretrain", "res-pretrain", "pho2-res-pretrain")
# The train batch: more token slots than the JAX package's padded pinyin
# and glyph tables have rows (128), so that both packages factorize.
TB, TS = 6, 24
DERIVED = ("res_uniq_images_nhwc", "res_uniq_images", "res_uniq_inverse",
           "pho_vocab_idx", "pho_vocab_lens", "pho_uniq_idx", "pho_uniq_lens",
           "pho_uniq_inverse")


def _np(t):
    return t.detach().float().numpy()


def vocab_tables(seed=2):
    rng = np.random.RandomState(seed)
    return (rng.randint(1, PHO2_VOCAB_SIZE, (V, P)).astype(np.int32),
            rng.randint(0, P + 1, (V,)).astype(np.int32))


def make_batch(name, seed, b, s):
    """A featurized batch: the sequence stages' ids (inputs = targets, as
    featurize_pho_pretrain makes them) with their pinyin and a loss mask;
    res-pretrain's (N,) char ids."""
    rng = np.random.RandomState(seed)
    if name == "res-pretrain":
        return {"char_idx": rng.randint(0, V, (b * s,)).astype(np.int32)}
    masks = np.ones((b, s), np.int32)
    masks[1, s // 2:] = 0
    src = rng.randint(0, V, (b, s)).astype(np.int32)
    idx, lens = vocab_tables()
    loss_masks = masks * (rng.rand(b, s) < 0.7)
    loss_masks[:, 0] = 0
    return {"src_idx": src, "tgt_idx": src.copy(), "masks": masks,
            "loss_masks": loss_masks.astype(np.int32),
            "pho_idx": idx[src], "pho_lens": lens[src]}


def _t(batch):
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.long)
            for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


class Stage:
    """A JAX (params, state) of one stage with every parameter random, the
    pinyin tables installed (its factorized GRU), and the port model of the
    same weights."""

    def __init__(self, name, **kw):
        self.name = name
        self.cfg = config_for(name, **dict(TINY, **kw))
        self.pcfg = RealiseConfig.from_dict(self.cfg.to_dict())
        rng = np.random.RandomState(sum(map(ord, name)))
        glyphs = (rng.rand(V, self.cfg.num_fonts, 32, 32) > 0.5).astype(np.float32)
        glyphs[rng.rand(V) < 0.6] = 0.0  # shared zero images: the dedup runs
        params, state = init_pretrain(
            jax.random.PRNGKey(0), self.cfg,
            glyphs=glyphs if self.cfg.with_res else None,
            pho_tables=vocab_tables() if self.cfg.with_pho else None)
        self.params = live_glyph_features(jax.tree.map(
            lambda x: np.asarray(x)
            + rng.normal(0, 0.05, np.shape(x)).astype(np.float32), params))
        state = dict(jax.tree.map(np.asarray, state))
        if "resnet" in state:
            state["resnet"] = jax.tree.map(
                lambda x: np.abs(x + rng.normal(0, 0.2, x.shape)).astype(np.float32),
                state["resnet"])
        self.state = state

    def model(self, cfg=None):
        pcfg = self.pcfg if cfg is None else RealiseConfig.from_dict(cfg.to_dict())
        m = trealise.RealisePretrain(pcfg)
        m.load_state_dict(state_dict_from_jax(self.params, self.state, pcfg))
        m.install_pho_vocab_tables(*vocab_tables())
        return m


_STAGES = {}


@pytest.fixture(params=STAGES)
def stage(request):
    if request.param not in _STAGES:
        _STAGES[request.param] = Stage(request.param)
    return _STAGES[request.param]


def test_state_dict_and_round_trip(stage):
    """The converted dict loads strictly into RealisePretrain under the
    reference's names, accounts for every element of every JAX leaf, holds
    live glyph features, and the JAX package's import_realise_state_dict +
    overlay_params gives every leaf back."""
    sd = state_dict_from_jax(stage.params, stage.state, stage.pcfg)
    m = trealise.build_model(stage.pcfg)
    assert type(m) is trealise.RealisePretrain
    m.load_state_dict(sd, strict=True)
    names = {k.split(".")[0] for k in sd}
    want = {"pho2-pretrain": {"pho_embeddings", "pho_gru", "pho_model", "cls2"},
            "res-pretrain": {"char_images_multifonts", "resnet", "cls3"},
            "pho2-res-pretrain": {"pho_embeddings", "pho_gru", "pho_res_model",
                                  "char_images_multifonts", "resnet", "cls2"}}
    assert names == want[stage.name]
    leaves = jax.tree.leaves(stage.params) + jax.tree.leaves(
        {k: v for k, v in stage.state.items() if k not in DERIVED})
    assert sum(np.size(x) for x in leaves) == sum(
        t.numel() for k, t in sd.items() if not k.endswith("num_batches_tracked"))
    if stage.cfg.with_res:
        assert live_glyph_rows(m) == V
    imported_p, imported_s = import_realise_state_dict(
        {k: v.numpy() for k, v in sd.items()}, stage.cfg)
    base_p, base_s = init_pretrain(jax.random.PRNGKey(7), stage.cfg)
    got_p = overlay_params(jax.tree.map(np.asarray, base_p), imported_p)
    jax.tree.map(np.testing.assert_array_equal, got_p, stage.params)
    if stage.cfg.with_res:
        jax.tree.map(np.testing.assert_array_equal, imported_s["resnet"],
                     stage.state["resnet"])
        np.testing.assert_array_equal(imported_s["char_images"],
                                      stage.state["char_images"])


def test_checkpoint_round_trip(stage, tmp_path):
    """A stage's port checkpoint: load_config + build_model give back a
    RealisePretrain of the same config, and load_checkpoint its bits."""
    model = stage.model()
    path = tckpt.save_checkpoint(str(tmp_path), 3, model.state_dict(),
                                 stage.pcfg)
    cfg = tckpt.load_config(path)
    assert cfg == stage.pcfg
    back = trealise.build_model(cfg)
    assert type(back) is trealise.RealisePretrain
    back.load_state_dict(tckpt.load_checkpoint(path))
    want = model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in back.state_dict().items())


def test_forward_matches_apply_pretrain(stage):
    """The deterministic logits, loss sum and count."""
    batch = make_batch(stage.name, 1, 2, 10)
    want = apply_pretrain(stage.params, stage.state, _j(batch), stage.cfg)
    with torch.inference_mode():
        got = stage.model()(_t(batch))
    np.testing.assert_allclose(_np(got["logits"]), np.asarray(want["logits"]),
                               atol=LOGIT_TOL)
    assert got["loss_count"].item() == float(want["loss_count"])
    np.testing.assert_allclose(got["loss_sum"].item(), float(want["loss_sum"]),
                               rtol=LOSS_REL)


def _port_step(m, batch, per_token=False, use_kernels=False):
    """One training-mode forward + backward of the mean loss on the
    Trainer's route (the conv over the batch's own glyph rows) or per
    token: (loss sum, count, {name: grad}, {name: BN statistic})."""
    m.train()
    m.zero_grad(set_to_none=True)
    batch = dict(batch)
    if not per_token and "src_idx" in batch:
        batch.update(m.conv_rows(batch["src_idx"]))
    out = m(_t(batch), use_kernels=use_kernels,
            generator=torch.Generator().manual_seed(1), per_token=per_token)
    (out["loss_sum"] / out["loss_count"]).backward()
    grads = {n: p.grad.clone() for n, p in m.named_parameters()}
    bn = {n: b.clone() for n, b in m.named_buffers() if "running_" in n}
    return out["loss_sum"].item(), out["loss_count"].item(), grads, bn


def _assert_grads_close(got, want):
    """Each gradient within GRAD_REL of its largest |value|, floored at
    1e-4 of the largest over all tensors (phase 8's rule)."""
    floor = 1e-4 * max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        err = float(np.abs(_np(got[name]) - w).max())
        assert err <= GRAD_REL * max(float(np.abs(w).max()), floor), (name, err)


@pytest.mark.parametrize("name,use_kernels", [(n, n == "pho2-pretrain")
                                              for n in STAGES])
def test_train_step_matches_jax_grad(name, use_kernels):
    """One train step at dropout 0 on the Trainer's route (the factorized
    GRU, the conv over the batch's own glyph rows; pho2-pretrain through the
    train kernels' route, whose plain versions run on the CPU) against
    jax.value_and_grad of apply_pretrain(train=True) with the pinyin tables
    installed (its factorized GRU and full-table conv): the loss sum and
    count, every gradient of the mean loss and the BatchNorm running
    statistics after the step."""
    if name not in _STAGES:
        _STAGES[name] = Stage(name)
    stage = _STAGES[name]
    cfg = stage.cfg.replace(hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0)
    batch = make_batch(name, 3, TB, TS)

    def loss(p):
        out = apply_pretrain(p, stage.state, _j(batch), cfg,
                             deterministic=False, rng=jax.random.PRNGKey(3),
                             train=True)
        return out["loss"], (out["loss_sum"], out["loss_count"], out["state"])

    (_, (ls, lc, new_state)), grads = jax.value_and_grad(loss, has_aux=True)(
        jax.tree.map(jnp.asarray, stage.params))
    pcfg = RealiseConfig.from_dict(cfg.to_dict())
    got_ls, got_lc, got_g, got_bn = _port_step(stage.model(cfg), batch,
                                               use_kernels=use_kernels)
    assert got_lc == float(lc)
    np.testing.assert_allclose(got_ls, float(ls), rtol=LOSS_REL)
    want = state_dict_from_jax(jax.tree.map(np.asarray, grads), stage.state, pcfg)
    _assert_grads_close(got_g, {n: want[n].numpy() for n in got_g})
    want_state = state_dict_from_jax(stage.params,
                                     jax.tree.map(np.asarray, new_state), pcfg)
    for bname, buf in got_bn.items():
        np.testing.assert_allclose(buf.numpy(), want_state[bname].numpy(),
                                   atol=BN_ATOL, rtol=BN_RTOL, err_msg=bname)


@pytest.mark.parametrize("name", ["pho2-pretrain", "pho2-res-pretrain"])
def test_factorized_matches_per_token(name):
    """The factorized streams (the GRU over the distinct pinyin rows, the
    conv over the batch's distinct glyph rows with occurrence-weighted
    BatchNorm) against the per-token streams: the loss, every gradient and
    the BatchNorm running statistics."""
    if name not in _STAGES:
        _STAGES[name] = Stage(name)
    stage = _STAGES[name]
    cfg = stage.cfg.replace(hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0)
    batch = make_batch(name, 5, TB, TS)
    m = stage.model(cfg)
    assert m.pho_uniq_idx.shape[0] < TB * TS
    fac = _port_step(m, batch)
    m = stage.model(cfg)
    tok = _port_step(m, batch, per_token=True)
    assert fac[1] == tok[1]
    np.testing.assert_allclose(fac[0], tok[0], rtol=LOSS_REL)
    _assert_grads_close(fac[2], {n: _np(g) for n, g in tok[2].items()})
    for bname, buf in tok[3].items():
        np.testing.assert_allclose(_np(fac[3][bname]), _np(buf), atol=BN_ATOL,
                                   err_msg=bname)


def test_kernel_route_matches_pallas():
    """pho2-pretrain's kernel route (the plain kernel versions on the CPU)
    against apply_pretrain(use_pallas=True), the Pallas kernels in
    interpret mode."""
    if "pho2-pretrain" not in _STAGES:
        _STAGES["pho2-pretrain"] = Stage("pho2-pretrain")
    stage = _STAGES["pho2-pretrain"]
    batch = make_batch(stage.name, 4, 2, 10)
    want = apply_pretrain(stage.params, stage.state, _j(batch), stage.cfg,
                          use_pallas=True)
    model = stage.model()
    with torch.inference_mode():
        got = model(_t(batch), use_kernels=True)
    np.testing.assert_allclose(_np(got["logits"]), np.asarray(want["logits"]),
                               atol=LOGIT_TOL)


@pytest.fixture(scope="module")
def small_vocab():
    return build_synthetic_vocab(size=300)


def test_pho_pretrain_features_match_jax(small_vocab):
    """featurize_pho_pretrain and cjk_token_mask equal the JAX package's
    arrays: inputs are the target ids, the loss covers the Chinese chars,
    the pinyin regathered for the new src_idx."""
    cfg = config_for("pho2-pretrain", vocab_size=len(small_vocab),
                     max_seq_length=24)
    tok = WordPieceTokenizer(vocab_to_dict(small_vocab))
    jtok = JTokenizer(vocab_to_dict(small_vocab))
    data = synthetic_dataset(tok, num_examples=6, seed=3)
    assert data == j_synthetic_dataset(jtok, num_examples=6, seed=3)
    ours_f = Featurizer(tok, RealiseConfig.from_dict(cfg.to_dict()))
    theirs_f = JFeaturizer(jtok, cfg)
    np.testing.assert_array_equal(ours_f.cjk_token_mask(),
                                  theirs_f.cjk_token_mask())
    assert ours_f.cjk_token_mask() is ours_f.cjk_token_mask()
    ours = ours_f.device_batch(ours_f.featurize_pho_pretrain(data))
    theirs = theirs_f.device_batch(theirs_f.featurize_pho_pretrain(data))
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k], v, err_msg=k)
    assert ours["loss_masks"].sum() > 0
    assert Featurizer.device_batch({"char_idx": np.arange(3)}).keys() == {"char_idx"}


def _replica(name, cfg):
    """The reference's module (tests/torch_ref.py) with random weights and
    BatchNorm statistics, in eval mode."""
    if name == "bert-pho2-res-arch3":
        m = torch_ref.TorchArch3(cfg, PHO2_VOCAB_SIZE)
        m.tie_cls_weight()
    elif name == "pho2-pretrain":
        m = torch_ref.TorchPho2Pretrain(cfg, PHO2_VOCAB_SIZE)
    elif name == "pho2-res-pretrain":
        m = torch_ref.TorchPho2ResPretrain(cfg, PHO2_VOCAB_SIZE)
    else:
        m = torch_ref.TorchResPretrain(cfg)
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for n, t in m.state_dict().items():
            if t.is_floating_point():
                noise = torch.randn(t.shape, generator=gen) * 0.05
                t.copy_((t + noise).abs() if "running_var" in n else t + noise)
        if name == "pho2-res-pretrain":
            m.char_images.weight.copy_(
                (torch.rand(m.char_images.weight.shape, generator=gen) > 0.5).float())
        if name in ("res-pretrain", "bert-pho2-res-arch3"):
            m.char_images_multifonts.copy_(
                (torch.rand(m.char_images_multifonts.shape, generator=gen) > 0.5).float())
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.bias.add_(1.0)  # live glyph features
    return m.eval()


@pytest.mark.parametrize("name", STAGES + ("bert-pho2-res-arch3",))
def test_reference_bin_loads(name, tmp_path):
    """A pytorch_model.bin of the reference's module as a DDP run saves it
    (``module.``, the CharResNet as ``char_resent.``, Pho2ResPretrain's
    single-font ``char_images.weight`` and ``pho_res_model``,
    ``cls2``/``cls3``; the pho BERT's and the output block's unread word
    embeddings and poolers, arch3's tied classifier weight) loads into the
    port's model, reads to the JAX importer's arrays, and its logits are the
    reference module's. Before the pretraining stages the port's reader
    refused arch3's bin too, on the unread word embeddings."""
    cfg = config_for(name, **dict(TINY, num_fonts=1))
    pcfg = RealiseConfig.from_dict(cfg.to_dict())
    ref = _replica(name, cfg)
    sd = {"module." + ("char_resent." + k[len("resnet."):]
                       if k.startswith("resnet.") else k): v
          for k, v in ref.state_dict().items()}
    torch.save(sd, str(tmp_path / "pytorch_model.bin"))
    got = timport.import_checkpoint_dir(str(tmp_path), pcfg)
    model = trealise.build_model(pcfg)
    model.load_state_dict(got, strict=True)
    if cfg.with_res:
        assert live_glyph_rows(model) == V
    theirs_p, _ = j_import_checkpoint_dir(str(tmp_path), cfg)
    ours_p, _ = import_realise_state_dict(
        {k: v.numpy() for k, v in got.items()}, cfg)
    jax.tree.map(np.testing.assert_array_equal, ours_p, theirs_p)
    rng = np.random.RandomState(6)
    if name == "res-pretrain":
        char_idx = torch.as_tensor(rng.randint(0, V, (12,)))
        with torch.inference_mode():
            _, want = ref(char_idx)
            out = model({"char_idx": char_idx})
    else:
        batch = make_batch(name, 6, 2, 10)
        batch["pho_lens"] = np.maximum(batch["pho_lens"], 1)  # pack_padded
        tb = _t(batch)
        with torch.inference_mode():
            want = ref(tb)[1]
            out = model(tb, per_token=True)
    np.testing.assert_allclose(_np(out["logits"]), _np(want), atol=LOGIT_TOL)


def _jax_parts(seed, **kw):
    """JAX base (arch3), pho2-pretrain and res-pretrain (params, state) of
    one config, every parameter random."""
    rng = np.random.RandomState(seed)
    glyphs = (rng.rand(V, 2, 32, 32) > 0.5).astype(np.float32)

    def noisy(tree):
        return jax.tree.map(lambda x: np.asarray(x) + rng.normal(
            0, 0.05, np.shape(x)).astype(np.float32), tree)

    cfgs = {n: config_for(n, **dict(TINY, **kw)) for n in
            ("bert-pho2-res-arch3", "pho2-pretrain", "res-pretrain")}
    out = {}
    for i, (n, cfg) in enumerate(cfgs.items()):
        init = init_realise if n.startswith("bert") else init_pretrain
        p, s = init(jax.random.PRNGKey(i), cfg,
                    glyphs=glyphs if cfg.with_res else None)
        s = dict(jax.tree.map(np.asarray, s))
        if "resnet" in s:
            s["resnet"] = jax.tree.map(lambda x: np.abs(noisy(x)), s["resnet"])
        out[n] = (cfg, noisy(p), s)
    return out


@pytest.mark.parametrize("keep", [False, True])
def test_merge_state_dicts_matches_merge_params(keep):
    """merge_state_dicts on port state dicts equals merge_params on the JAX
    trees, converted, under both position-embedding settings: the pho
    subtree (its position embeddings unless ``keep``) and the CharResNet with
    its BatchNorm statistics from the stages, the rest (glyphs included)
    from the base, no pretraining head."""
    parts = _jax_parts(0)
    (bcfg, bp, bs), (pcfg_j, pp, ps), (rcfg, rp, rs) = parts.values()
    mp, ms = merge_params(bp, bs, pho_params=pp, res_params=rp, res_state=rs,
                          keep_base_position_embeddings=keep)
    bcfg_t = RealiseConfig.from_dict(bcfg.to_dict())
    want = state_dict_from_jax(mp, ms, bcfg_t)
    sd = {n: state_dict_from_jax(p, s, RealiseConfig.from_dict(c.to_dict()))
          for n, (c, p, s) in parts.items()}
    got = merge_state_dicts(sd["bert-pho2-res-arch3"], pho=sd["pho2-pretrain"],
                            res=sd["res-pretrain"],
                            keep_base_position_embeddings=keep)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    pos = "pho_model.embeddings.position_embeddings.weight"
    src = "bert-pho2-res-arch3" if keep else "pho2-pretrain"
    assert got[pos] is sd[src][pos]
    assert got["resnet.res_block1.residual_function.1.running_var"] is \
        sd["res-pretrain"]["resnet.res_block1.residual_function.1.running_var"]
    assert got["char_images_multifonts"] is sd["bert-pho2-res-arch3"]["char_images_multifonts"]
    trealise.Realise(bcfg_t).load_state_dict(got, strict=True)
    # A stage without the subtree changes nothing (merge_params's rule).
    assert merge_state_dicts(sd["bert-pho2-res-arch3"],
                             pho=sd["res-pretrain"]) == sd["bert-pho2-res-arch3"]


def test_merge_refuses_other_fonts():
    """A res stage of other fonts than the base's: the merged state dict
    does not load (conv1's input channels), as in torch; nothing reshapes."""
    base = _jax_parts(1)
    other = _jax_parts(1, num_fonts=3)
    cfg, p, s = base["bert-pho2-res-arch3"]
    pcfg = RealiseConfig.from_dict(cfg.to_dict())
    rcfg, rp, rs = other["res-pretrain"]
    merged = merge_state_dicts(
        state_dict_from_jax(p, s, pcfg),
        res=state_dict_from_jax(rp, rs, RealiseConfig.from_dict(rcfg.to_dict())))
    with pytest.raises(RuntimeError, match="size mismatch"):
        trealise.Realise(pcfg).load_state_dict(merged)


@pytest.mark.parametrize("sec_version", [0, 1])
def test_merge_torch_state_dicts_matches_jax(sec_version):
    """merge.py on the reference's dicts, the port's and the JAX package's:
    the same keys and arrays, a top-level position_embeddings.* and the
    single-font char_images.weight deleted, the nested ones kept."""
    rng = np.random.RandomState(sec_version)

    def t(*shape):
        return torch.as_tensor(rng.rand(*shape).astype(np.float32))

    base = {"embeddings.word_embeddings.weight": t(V, 4),
            "position_embeddings.weight": t(8, 4), "pho_gru.bias_ih_l0": t(12)}
    pho = {"pho_gru.bias_ih_l0": t(12), "cls2.predictions.bias": t(V),
           "pho_model.embeddings.position_embeddings.weight": t(8, 4)}
    res = {"resnet.res_block1.residual_function.0.weight": t(2, 1, 3, 3),
           "char_images.weight": t(V, 1024), "cls3.weight": t(V, 4)}
    got = timport.merge_torch_state_dicts(base, pho, res, sec_version)
    want = j_merge_torch_state_dicts(
        *({k: v.numpy() for k, v in d.items()} for d in (base, pho, res)),
        sec_version=sec_version)
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert ("char_resent.res_block1.residual_function.0.weight" in got) == \
        (sec_version == 1)
    assert "pho_model.embeddings.position_embeddings.weight" in got


def test_graft_mlm_head_matches_jax():
    """graft_mlm_head_from_hf: an arch3-mlm state dict's cls.predictions.*
    from a HF BERT's, the decoder's bias where only that one is saved; the
    JAX package's graft gives the same head."""
    cfg = config_for("bert-pho2-res-arch3-mlm", **TINY)
    pcfg = RealiseConfig.from_dict(cfg.to_dict())
    rng = np.random.RandomState(4)
    p, s = init_realise(jax.random.PRNGKey(0), cfg)
    p = jax.tree.map(np.asarray, p)
    h = cfg.hidden_size
    hf = {"cls.predictions.transform.dense.weight": rng.rand(h, h),
          "cls.predictions.transform.dense.bias": rng.rand(h),
          "cls.predictions.transform.LayerNorm.weight": rng.rand(h),
          "cls.predictions.transform.LayerNorm.bias": rng.rand(h),
          "cls.predictions.decoder.weight": rng.rand(V, h),
          "cls.predictions.decoder.bias": rng.rand(V)}
    hf = {k: v.astype(np.float32) for k, v in hf.items()}
    want = state_dict_from_jax(j_graft(p, hf), jax.tree.map(np.asarray, s), pcfg)
    got = graft_mlm_head_from_hf(state_dict_from_jax(p, s, pcfg),
                                 {k: torch.as_tensor(v) for k, v in hf.items()})
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
