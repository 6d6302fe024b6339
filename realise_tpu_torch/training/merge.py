"""Checkpoint composition: the pretrained pho and glyph encoders overlaid on a
base model (the port of ``realise_tpu.training.merge``; reference:
merge.py:5-38).

The reference overlays the phonetic-pretrain and glyph-pretrain state dicts
on the BERT state dict and then deletes the top-level
``position_embeddings.*`` and ``char_images.*`` keys. Only the single-font
``char_images.weight`` ever matches: the pho BERT's position embeddings are
nested under ``pho_model.embeddings.*`` and the multifont glyphs are named
``char_images_multifonts``, so both survive the reference's merge. The
JAX package does the same surgery on its pytrees (``merge_params``); here it
is done on port state dicts, key by key, with the same effect. The bits of
every tensor are kept: a merged checkpoint loads the same tensors as a
model overlaid with ``cli/train --pho_ckpt --res_ckpt``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

# The keys of the pho subtree of the JAX package's params (embeddings, GRU,
# pho BERT): the pho BERT is ``pho_model`` in every model but
# Pho2ResPretrain, whose reference name is ``pho_res_model``.
_PHO = ("pho_embeddings.", "pho_gru.", "pho_model.")
_PHO_RES_BERT = "pho_res_model."
_PHO_POSITIONS = "pho_model.embeddings.position_embeddings.weight"
_MLM_HEAD = "cls.predictions."

StateDict = Dict[str, torch.Tensor]


def merge_state_dicts(base: Mapping[str, torch.Tensor],
                      pho: Optional[Mapping[str, torch.Tensor]] = None,
                      res: Optional[Mapping[str, torch.Tensor]] = None,
                      keep_base_position_embeddings: bool = False) -> StateDict:
    """``base`` with the pretraining stages' encoders grafted in (the
    tensors are not copied):

    * ``pho``: a ``pho2-pretrain`` (or ``pho2-res-pretrain``) state dict:
      its whole pho subtree (``pho_embeddings``, ``pho_gru``, the pho BERT
      with its position embeddings, ``pho_res_model`` read as
      ``pho_model``) replaces the base's. ``keep_base_position_embeddings``
      keeps the base's pho BERT position embeddings instead, what the
      reference's filter meant to do and does not (merge.py:26-34);
    * ``res``: a ``res-pretrain`` state dict: its CharResNet (weights, BN
      parameters and running statistics) replaces the base's.

    The glyph tensor and the pretraining heads (``cls2``, ``cls3``) never
    reach the result. A stage without the subtree changes nothing (the JAX
    package's ``merge_params``, training/merge.py:28-71)."""
    out = dict(base)
    if pho is not None:
        subtree = {("pho_model." + k[len(_PHO_RES_BERT):]
                    if k.startswith(_PHO_RES_BERT) else k): v
                   for k, v in pho.items()}
        subtree = {k: v for k, v in subtree.items() if k.startswith(_PHO)}
        if subtree:
            if (keep_base_position_embeddings and _PHO_POSITIONS in out
                    and _PHO_POSITIONS in subtree):
                subtree[_PHO_POSITIONS] = out[_PHO_POSITIONS]
            out = {k: v for k, v in out.items() if not k.startswith(_PHO)}
            out.update(subtree)
    if res is not None:
        subtree = {k: v for k, v in res.items() if k.startswith("resnet.")}
        if subtree:
            out = {k: v for k, v in out.items() if not k.startswith("resnet.")}
            out.update(subtree)
    return out


def graft_mlm_head_from_hf(state_dict: Mapping[str, torch.Tensor],
                           hf_state_dict: Mapping[str, torch.Tensor]) -> StateDict:
    """An MLM head (``cls.predictions.*``) initialized from a HF BERT's
    pretrained one (reference: utils/add_mlm_to_weights.py:4-9,
    add_trans_to_weights.py:4-9; ``graft_mlm_head_from_hf`` of the JAX
    package): the transform, its LayerNorm, the decoder and the bias (the
    decoder's where only that one is saved, zeros where neither is)."""
    out = {k: v for k, v in state_dict.items() if not k.startswith(_MLM_HEAD)}
    for name in ("transform.dense.weight", "transform.dense.bias",
                 "transform.LayerNorm.weight", "transform.LayerNorm.bias",
                 "decoder.weight"):
        out[_MLM_HEAD + name] = hf_state_dict[_MLM_HEAD + name]
    decoder = hf_state_dict[_MLM_HEAD + "decoder.weight"]
    bias = hf_state_dict.get(_MLM_HEAD + "bias",
                             hf_state_dict.get(_MLM_HEAD + "decoder.bias"))
    out[_MLM_HEAD + "bias"] = (torch.zeros(decoder.shape[0], dtype=decoder.dtype)
                               if bias is None else bias)
    return out
