"""Reference weights into the port (realise_tpu_torch/models/torch_import.py)
against the JAX package's importer: the same keys and arrays from
``load_torch_bin`` + ``normalize_state_dict``, and a ``pytorch_model.bin``
under the reference's names giving the JAX package's logits (f32, 1e-5)."""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realise_tpu.config import PHO2_VOCAB_SIZE, config_for
from realise_tpu.models.realise import apply_realise, init_realise
from realise_tpu.models.torch_import import import_checkpoint_dir as jax_import_dir
from realise_tpu.models.torch_import import load_torch_bin as jax_load_bin
from realise_tpu.models.torch_import import normalize_state_dict as jax_normalize
from realise_tpu.models.torch_import import overlay_params
from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.models import torch_import as timport
from realise_tpu_torch.models.realise import Realise

LOGIT_TOL = 1e-5
V, B, S = 80, 2, 10
CFG = config_for("bert-pho2-res-arch3", vocab_size=V, hidden_size=24,
                 num_hidden_layers=2, num_attention_heads=3,
                 intermediate_size=48, max_position_embeddings=32,
                 pho_num_layers=1, out_num_layers=2, num_fonts=2)
PCFG = RealiseConfig.from_dict(CFG.to_dict())


@pytest.fixture(scope="module")
def model():
    """A port model with every parameter and BN statistic random."""
    gen = torch.Generator().manual_seed(3)
    m = Realise(PCFG, generator=gen)
    rng = np.random.RandomState(3)
    m.install_glyphs((rng.rand(V, 2, 32, 32) > 0.5).astype(np.float32))
    with torch.no_grad():
        for name, t in m.state_dict().items():
            if t.is_floating_point() and name != "char_images_multifonts":
                t.add_(torch.as_tensor(rng.normal(0, 0.05, tuple(t.shape)),
                                       dtype=t.dtype))
            if "running_var" in name:
                t.abs_()
    return m.eval()


def reference_state_dict(model):
    """The model's weights as the reference saves them from a DDP run after
    merge.py: ``module.``-prefixed, ``resnet.`` renamed ``char_resent.``,
    with the tied classifier weight, the BERT poolers and the position-id
    buffer the arch3 forward does not read."""
    sd = {}
    for k, v in model.state_dict().items():
        if k.startswith("resnet."):
            k = "char_resent." + k[len("resnet."):]
        sd["module." + k] = v.clone()
    h = PCFG.hidden_size
    sd["module.classifier.weight"] = \
        model.bert.embeddings.word_embeddings.weight.detach().clone()
    for stack in ("bert", "pho_model", "output_block"):
        sd[f"module.{stack}.pooler.dense.weight"] = torch.zeros(h, h)
        sd[f"module.{stack}.pooler.dense.bias"] = torch.zeros(h)
    sd["module.bert.embeddings.position_ids"] = torch.arange(
        PCFG.max_position_embeddings)[None]
    return sd


@pytest.fixture(scope="module")
def bin_dir(model, tmp_path_factory):
    root = tmp_path_factory.mktemp("reference_bin")
    torch.save(reference_state_dict(model), str(root / "pytorch_model.bin"))
    return str(root)


def test_load_and_normalize_match_jax(bin_dir):
    path = os.path.join(bin_dir, "pytorch_model.bin")
    ours = timport.normalize_state_dict(timport.load_torch_bin(path))
    theirs = jax_normalize(jax_load_bin(path))
    assert list(ours) == list(theirs)
    assert any(k.startswith("resnet.") for k in ours)
    assert not any(k.startswith(("module.", "char_resent.")) for k in ours)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_import_gives_the_model_back(model, bin_dir, caplog):
    """Every key the model has comes back with its bits; the entries the
    forward does not read are set aside by name in the log."""
    with caplog.at_level(logging.INFO, logger="realise_tpu_torch"):
        sd = timport.import_checkpoint_dir(bin_dir, PCFG)
    want = model.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    assert "classifier.weight" in caplog.text
    assert "bert.pooler.dense.weight" in caplog.text


def _batch(seed=1):
    rng = np.random.RandomState(seed)
    masks = np.ones((B, S), np.int32)
    masks[1, 6:] = 0
    return {"src_idx": rng.randint(0, V, (B, S)).astype(np.int32),
            "masks": masks,
            "pho_idx": rng.randint(1, PHO2_VOCAB_SIZE,
                                   (B, S, CFG.pho2_max_len)).astype(np.int32),
            "pho_lens": rng.randint(0, CFG.pho2_max_len + 1,
                                    (B, S)).astype(np.int32)}


@pytest.mark.parametrize("kernels", [False, True])
def test_reference_bin_logits_match_jax(bin_dir, kernels):
    """The bin through the port's importer and the port's forward against
    the same bin through the JAX package's ``import_checkpoint_dir`` (onto
    a fresh init) and ``apply_realise``; ``kernels`` pairs use_pallas
    (interpret) with the kernels' plain versions on the CPU."""
    m = Realise(PCFG, generator=torch.Generator().manual_seed(9))
    m.load_state_dict(timport.import_checkpoint_dir(bin_dir, PCFG))
    batch = _batch()
    with torch.inference_mode():
        got = m.eval()({k: torch.as_tensor(v, dtype=torch.long)
                        for k, v in batch.items()},
                       use_kernels=kernels)["logits"].numpy()
    imported_p, imported_s = jax_import_dir(bin_dir, CFG)
    base_p, base_s = init_realise(jax.random.PRNGKey(7), CFG)
    params = overlay_params(jax.tree.map(np.asarray, base_p), imported_p)
    state = overlay_params(jax.tree.map(np.asarray, base_s), imported_s)
    want = np.asarray(apply_realise(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state),
        {k: jnp.asarray(v) for k, v in batch.items()}, CFG,
        use_pallas=kernels)["logits"])
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL)


@pytest.mark.parametrize("edit, named", [
    (lambda sd: sd.pop("module.gate_net.bias"), "missing: gate_net.bias"),
    (lambda sd: sd.__setitem__("module.extra_head.weight", torch.zeros(2)),
     "unexpected: extra_head.weight"),
    (lambda sd: sd.__setitem__("module.classifier.bias", torch.zeros(V + 1)),
     "misshapen: classifier.bias"),
], ids=["missing", "unexpected", "misshapen"])
def test_a_key_that_does_not_fit_is_named(model, tmp_path, edit, named):
    sd = reference_state_dict(model)
    edit(sd)
    torch.save(sd, str(tmp_path / "pytorch_model.bin"))
    with pytest.raises(ValueError, match=named):
        timport.import_checkpoint_dir(str(tmp_path), PCFG)
