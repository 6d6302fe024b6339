"""Carry JAX weights across: the JAX package's (params, state) → a port state dict.

The inverse of ``realise_tpu/models/torch_import.py`` for every preset's
tree: the fine-tuning presets' (``_build_realise`` of the JAX package,
models/realise.py:276-327) and the pretraining stages' (``_build_pretrain``,
:966-988). It takes the nested dicts of numpy arrays that the JAX package's
``load_checkpoint`` returns and imports nothing of JAX:

* encoder layers stacked along a leading axis are unstacked into
  ``encoder.layer.{i}.*``;
* dense kernels (in, out) transpose to torch's (out, in) weights, GRU
  (D, 3H) kernels to (3H, D), conv kernels HWIO to OIHW;
* BatchNorm running statistics move from the state tree to
  ``running_mean``/``running_var``, and the glyph tensor
  ``state['char_images']`` becomes ``char_images_multifonts``;
* each part goes where the preset has it: the pho tree (pho1: the 65-symbol
  table and the BERT; pho2: the GRU too) to ``pho_*``, the CharResNet of
  either variant with ``resnet_layernorm`` where the tree has one (not the
  merged presets), ``fusion.gate_net`` or ``fusion.integrate``, and the head
  to ``classifier.bias`` (tied) or ``cls.predictions.*`` (MLM: the
  decoder's (H, V) kernel becomes its (V, H) weight, its bias
  ``cls.predictions.bias``);
* a pretraining stage has no semantic BERT; its pho BERT is ``pho_model``
  (``pho2-pretrain``) or ``pho_res_model`` (``pho2-res-pretrain``), its MLM
  head ``cls2.predictions.*`` and ``res-pretrain``'s linear head
  ``head.classifier`` is ``cls3``.

The deduplicated tables in the state (``res_uniq_*``, ``pho_*``) are derived
from the glyphs and the vocabulary; the port derives its own
(``Realise.install_glyphs``, ``install_pho_vocab_tables``), so they are not
converted.

:func:`seeded_weights` makes a whole model's weights from a numpy seed alone,
the same on every machine and torch version: the JAX package reads them with
its own importer, and the full-width tests and ``chip_smoke.py`` hold both
packages to each other on them.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from realise_tpu_torch.config import PHO2_VOCAB_SIZE, RealiseConfig
from realise_tpu_torch.models.realise import build_model


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x))  # a copy: restored arrays may be read-only


def _linear(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _layer_norm(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def bert_state_dict(p: Mapping, num_layers: int,
                    prefix: str = "") -> Dict[str, torch.Tensor]:
    """One JAX BERT stack (embeddings + stacked encoder) → ``BertModel`` names."""
    sd: Dict[str, torch.Tensor] = {}
    emb = p["embeddings"]
    if "word_embeddings" in emb:
        sd[f"{prefix}embeddings.word_embeddings.weight"] = _t(
            emb["word_embeddings"]["embedding"])
    sd[f"{prefix}embeddings.position_embeddings.weight"] = _t(
        emb["position_embeddings"]["embedding"])
    sd[f"{prefix}embeddings.token_type_embeddings.weight"] = _t(
        emb["token_type_embeddings"]["embedding"])
    _layer_norm(sd, f"{prefix}embeddings.LayerNorm", emb["layer_norm"])
    att, ffn = p["encoder"]["attention"], p["encoder"]["ffn"]
    for i in range(num_layers):
        lp = f"{prefix}encoder.layer.{i}."

        def layer(leaves):  # layer i of the stacked (L, ...) leaves
            return {k: np.asarray(v)[i] for k, v in leaves.items()}

        _linear(sd, lp + "attention.self.query", layer(att["query"]))
        _linear(sd, lp + "attention.self.key", layer(att["key"]))
        _linear(sd, lp + "attention.self.value", layer(att["value"]))
        _linear(sd, lp + "attention.output.dense", layer(att["output"]))
        _layer_norm(sd, lp + "attention.output.LayerNorm",
                    layer(att["layer_norm"]))
        _linear(sd, lp + "intermediate.dense", layer(ffn["intermediate"]))
        _linear(sd, lp + "output.dense", layer(ffn["output"]))
        _layer_norm(sd, lp + "output.LayerNorm", layer(ffn["layer_norm"]))
    return sd


def _conv(x) -> torch.Tensor:
    return _t(np.transpose(np.asarray(x), (3, 2, 0, 1)))  # HWIO → OIHW


def _bn(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping, s: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def char_resnet_state_dict(params: Mapping, state: Mapping,
                           prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX CharResNet (params, BN state) → ``CharResNet`` names."""
    sd: Dict[str, torch.Tensor] = {}
    for name in sorted(params):  # blockK → res_blockK
        bp, p, s = f"{prefix}res_{name}.", params[name], state[name]
        sd[bp + "residual_function.0.weight"] = _conv(p["conv1"]["kernel"])
        _bn(sd, bp + "residual_function.1", p["bn1"], s["bn1"])
        sd[bp + "residual_function.3.weight"] = _conv(p["conv2"]["kernel"])
        _bn(sd, bp + "residual_function.4", p["bn2"], s["bn2"])
        if "shortcut_conv" in p:
            sd[bp + "shortcut.0.weight"] = _conv(p["shortcut_conv"]["kernel"])
            _bn(sd, bp + "shortcut.1", p["shortcut_bn"], s["shortcut_bn"])
    return sd


def state_dict_from_jax(params: Mapping[str, Any], state: Mapping[str, Any],
                        cfg: RealiseConfig) -> Dict[str, torch.Tensor]:
    """JAX (params, state) of any preset → a state dict for
    ``build_model(cfg)`` (``Realise`` or ``RealisePretrain``)."""
    pretrain = cfg.fusion == "pretrain"
    sd: Dict[str, torch.Tensor] = {}
    if not pretrain:
        sd.update(bert_state_dict(params["bert"], cfg.num_hidden_layers,
                                  "bert."))

    if "pho" in params:
        pho = params["pho"]
        sd["pho_embeddings.weight"] = _t(pho["embeddings"]["embedding"])
        if "gru" in pho:
            gru = pho["gru"]
            sd["pho_gru.weight_ih_l0"] = _t(np.asarray(gru["w_ih"]).T)
            sd["pho_gru.weight_hh_l0"] = _t(np.asarray(gru["w_hh"]).T)
            sd["pho_gru.bias_ih_l0"] = _t(gru["b_ih"])
            sd["pho_gru.bias_hh_l0"] = _t(gru["b_hh"])
        pho_bert = ("pho_res_model." if pretrain and cfg.with_res
                    else "pho_model.")
        sd.update(bert_state_dict(pho["model"], cfg.pho_num_layers, pho_bert))

    if "res" in params:
        sd.update(char_resnet_state_dict(params["res"]["resnet"],
                                         state["resnet"], "resnet."))
        if "layer_norm" in params["res"]:
            _layer_norm(sd, "resnet_layernorm", params["res"]["layer_norm"])
        sd["char_images_multifonts"] = _t(state["char_images"])

    for name, p in params.get("fusion", {}).items():  # gate_net | integrate
        _linear(sd, name, p)
    if cfg.out_num_layers > 0:
        sd.update(bert_state_dict(params["output_block"], cfg.out_num_layers,
                                  "output_block."))
    head = params["head"]
    if cfg.head == "linear":
        _linear(sd, "cls3", head["classifier"])
    elif cfg.head == "mlm":
        pre = "cls2.predictions." if pretrain else "cls.predictions."
        _linear(sd, pre + "transform.dense", head["transform"])
        _layer_norm(sd, pre + "transform.LayerNorm", head["layer_norm"])
        sd[pre + "decoder.weight"] = _t(np.asarray(head["decoder"]["kernel"]).T)
        sd[pre + "bias"] = _t(head["decoder"]["bias"])
    else:
        sd["classifier.bias"] = _t(head["bias"])
    return sd


# The spread of seeded_weights' dense weights, biases and offsets: the tests'
# recipe (the JAX init's 0.02 plus N(0, 0.05) noise) without the init.
SEEDED_STD = 0.05


def seeded_weights(cfg: RealiseConfig, seed: int
                   ) -> Tuple[Dict[str, torch.Tensor], Tuple[np.ndarray, np.ndarray]]:
    """Every tensor of ``build_model(cfg)``'s state dict, and (V, P) pinyin
    ids + (V,) lengths for the vocab rows, drawn from
    ``numpy.random.RandomState(seed)`` in the state dict's order (legacy
    ``RandomState`` streams are fixed across numpy versions):

    * dense, embedding and GRU weights, their biases, the tied head's bias:
      N(0, 0.05); LayerNorm scales 1 + N(0, 0.05), offsets N(0, 0.05);
    * convolutions: He normal, N(0, 2 / fan_in);
    * BatchNorm scales 1 + N(0, 0.05) and offsets 1 + N(0, 0.05), running
      means N(0, 0.1) and variances 1 + |N(0, 0.2)|: the +1 on the offsets
      keeps every glyph row's CharResNet features nonzero (the tests'
      ``live_glyph_features``), else the ReLUs could zero a row whole;
    * the glyph tensor ``char_images_multifonts``: independent 0/1 pixels,
      so no two rows share a glyph;
    * the pinyin tables: ids in [1, 33), lengths in [0, pho2_max_len].

    Returned as CPU float32 tensors that share the numpy arrays' memory."""
    rng = np.random.RandomState(seed)
    with torch.device("meta"):
        model = build_model(cfg)
    modules = dict(model.named_modules())
    sd: Dict[str, torch.Tensor] = {}
    for key, meta in model.state_dict().items():
        mod_name, _, leaf = key.rpartition(".")
        mod, shape = modules[mod_name], tuple(meta.shape)
        if leaf == "num_batches_tracked":
            sd[key] = torch.tensor(0, dtype=torch.long)
            continue
        if key == "char_images_multifonts":
            x = rng.randint(0, 2, shape, dtype=np.uint8)
        elif isinstance(mod, nn.Conv2d):
            x = rng.normal(0.0, (2.0 / np.prod(shape[1:])) ** 0.5, shape)
        elif isinstance(mod, nn.BatchNorm2d):
            if leaf == "running_mean":
                x = rng.normal(0.0, 0.1, shape)
            elif leaf == "running_var":
                x = 1.0 + np.abs(rng.normal(0.0, 0.2, shape))
            else:  # the scale and the offset
                x = 1.0 + rng.normal(0.0, SEEDED_STD, shape)
        elif isinstance(mod, nn.LayerNorm) and leaf == "weight":
            x = 1.0 + rng.normal(0.0, SEEDED_STD, shape)
        else:
            x = rng.normal(0.0, SEEDED_STD, shape)
        sd[key] = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    v, p = cfg.vocab_size, cfg.pho2_max_len
    pho_idx = rng.randint(1, PHO2_VOCAB_SIZE, (v, p)).astype(np.int32)
    pho_lens = rng.randint(0, p + 1, (v,)).astype(np.int32)
    return sd, (pho_idx, pho_lens)
