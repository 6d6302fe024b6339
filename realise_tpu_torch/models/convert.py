"""Carry JAX weights across: the JAX package's (params, state) → a port state dict.

The inverse of ``realise_tpu/models/torch_import.py`` for the arch3 wiring.
It takes the nested dicts of numpy arrays that the JAX package's
``load_checkpoint`` returns and imports nothing of JAX:

* encoder layers stacked along a leading axis are unstacked into
  ``encoder.layer.{i}.*``;
* dense kernels (in, out) transpose to torch's (out, in) weights, GRU
  (D, 3H) kernels to (3H, D), conv kernels HWIO to OIHW;
* BatchNorm running statistics move from the state tree to
  ``running_mean``/``running_var``, and the glyph tensor
  ``state['char_images']`` becomes ``char_images_multifonts``.

The deduplicated tables in the state (``res_uniq_*``, ``pho_*``) are derived
from the glyphs and the vocabulary; the port derives its own
(``Realise.install_glyphs``, ``install_pho_vocab_tables``), so they are not
converted.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from realise_tpu_torch.config import RealiseConfig


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
    """JAX arch3 (params, state) → a state dict for ``Realise(cfg)``."""
    sd: Dict[str, torch.Tensor] = {}
    sd.update(bert_state_dict(params["bert"], cfg.num_hidden_layers, "bert."))

    pho = params["pho"]
    sd["pho_embeddings.weight"] = _t(pho["embeddings"]["embedding"])
    gru = pho["gru"]
    sd["pho_gru.weight_ih_l0"] = _t(np.asarray(gru["w_ih"]).T)
    sd["pho_gru.weight_hh_l0"] = _t(np.asarray(gru["w_hh"]).T)
    sd["pho_gru.bias_ih_l0"] = _t(gru["b_ih"])
    sd["pho_gru.bias_hh_l0"] = _t(gru["b_hh"])
    sd.update(bert_state_dict(pho["model"], cfg.pho_num_layers, "pho_model."))

    sd.update(char_resnet_state_dict(params["res"]["resnet"], state["resnet"],
                                     "resnet."))
    _layer_norm(sd, "resnet_layernorm", params["res"]["layer_norm"])
    sd["char_images_multifonts"] = _t(state["char_images"])

    _linear(sd, "gate_net", params["fusion"]["gate_net"])
    if cfg.out_num_layers > 0:
        sd.update(bert_state_dict(params["output_block"], cfg.out_num_layers,
                                  "output_block."))
    sd["classifier.bias"] = _t(params["head"]["bias"])
    return sd
