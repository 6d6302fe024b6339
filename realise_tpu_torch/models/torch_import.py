"""Reference weights: a ``pytorch_model.bin`` of the reference's ReaLiSe, or
of one of its pretraining stages, into a port state dict (the port of
``load_torch_bin``, ``normalize_state_dict``, ``import_checkpoint_dir`` and
``merge_torch_state_dicts`` of ``realise_tpu/models/torch_import.py``).

The port's modules carry the reference's parameter names, so importing is a
matter of spelling: strip DDP's ``module.`` wrapper, undo merge.py's
``char_resent.`` rename (merge.py:10-15), read the merged presets' shared
pho BERT ``pho_res_model.*`` (src/models.py:265,404) as the port's
``pho_model.*`` (Pho2ResPretrain's keeps its name, src/models.py:1194), an
MLM head's ``cls.predictions.decoder.bias`` (``cls2.`` for the pretraining
head) as ``cls.predictions.bias`` where only the first is saved (the JAX
importer's rule, torch_import.py:189-191) and a single-font
``char_images.weight`` (V, 1024) (Pho2ResPretrain, src/models.py:1180) as
``char_images_multifonts`` (V, 1, 32, 32), and set aside the entries that
the reference saves and the forward does not read:

* ``classifier.weight``: the classifier is tied to the word embeddings
  (src/models.py), so the tensor is the embedding table again;
* ``*.pooler.dense.*``: the BERT pooler, unused by the token classifier;
* ``*.embeddings.position_ids``: the position buffer of newer transformers;
* the word embeddings of the stacks that run on ``inputs_embeds`` (the pho
  BERT, ``pho_res_model``, the output block): the reference builds them as
  whole BertModels, whose word table the forward never reads;
* ``cls.predictions.decoder.bias`` beside ``cls.predictions.bias`` (or
  ``cls2.``): transformers saves the bias twice, the decoder's being the
  same tensor.

Each one set aside is logged by name. Every other key must be one of the
port model's and every key of the port model must be present, with its
shape; otherwise the import raises naming each missing, unexpected or
misshapen key.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict, Mapping, Optional

import torch

from realise_tpu_torch.config import RealiseConfig

logger = logging.getLogger("realise_tpu_torch")

BIN_FILE = "pytorch_model.bin"
_UNREAD = re.compile(r"^(classifier\.weight|(.+\.)?pooler\.dense\.(weight|bias)"
                     r"|(.+\.)?embeddings\.position_ids"
                     r"|(pho_model|pho_res_model|output_block)\.embeddings"
                     r"\.word_embeddings\.weight"
                     r"|cls2?\.predictions\.decoder\.bias)$")
_MLM_HEADS = ("cls.predictions.", "cls2.predictions.")


def load_torch_bin(path: str) -> Dict[str, torch.Tensor]:
    """A ``pytorch_model.bin`` as CPU tensors."""
    return torch.load(path, map_location="cpu", weights_only=True)


def normalize_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Strip DDP's ``module.`` prefix, map merge.py's ``char_resent.`` back
    to ``resnet.`` and the merged presets' ``pho_res_model.`` to
    ``pho_model.``, and name an MLM decoder's bias ``cls.predictions.bias``
    (``cls2.``) when that key is absent."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        for old, new in (("char_resent.", "resnet."),
                         ("pho_res_model.", "pho_model.")):
            if k.startswith(old):
                k = new + k[len(old):]
        out[k] = v
    for head in _MLM_HEADS:
        if head + "decoder.bias" in out and head + "bias" not in out:
            out[head + "bias"] = out.pop(head + "decoder.bias")
    return out


def _spell_as_model(sd: Dict[str, torch.Tensor],
                    want: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The two spellings that depend on the model: Pho2ResPretrain's pho
    BERT keeps the name ``pho_res_model``, and a single-font
    ``char_images.weight`` becomes ``char_images_multifonts``."""
    if any(k.startswith("pho_res_model.") for k in want):
        sd = {("pho_res_model." + k[len("pho_model."):]
               if k.startswith("pho_model.") else k): v for k, v in sd.items()}
    if "char_images.weight" in sd and "char_images_multifonts" not in sd:
        sd = dict(sd)
        flat = sd.pop("char_images.weight")
        sd["char_images_multifonts"] = flat.reshape(flat.shape[0], 1, 32, 32)
    return sd


def _fit_to_model(sd: Mapping[str, torch.Tensor],
                  cfg: RealiseConfig) -> Dict[str, torch.Tensor]:
    """A normalized reference state dict → the state dict of
    ``build_model(cfg)``, checked key for key and shape for shape against
    it."""
    from realise_tpu_torch.models.realise import build_model

    with torch.device("meta"):
        want = build_model(cfg).state_dict()
    sd = _spell_as_model(dict(sd), want)
    unread = sorted(k for k in sd if k not in want and _UNREAD.match(k))
    if unread:
        logger.info("reference weights: %d entries the forward does not "
                    "read are set aside: %s", len(unread), ", ".join(unread))
    out = {k: v for k, v in sd.items() if k not in unread}
    missing = sorted(set(want) - set(out))
    unexpected = sorted(set(out) - set(want))
    misshapen = sorted(f"{k} {tuple(out[k].shape)} (model {tuple(want[k].shape)})"
                       for k in set(out) & set(want)
                       if out[k].shape != want[k].shape)
    if missing or unexpected or misshapen:
        raise ValueError(
            "reference weights do not fit the model: "
            + "; ".join(f"{what}: {', '.join(keys)}" for what, keys in
                        (("missing", missing), ("unexpected", unexpected),
                         ("misshapen", misshapen)) if keys))
    return out


def import_checkpoint_dir(path: str, cfg: RealiseConfig) -> Dict[str, torch.Tensor]:
    """``{path}/pytorch_model.bin`` → a state dict for ``build_model(cfg)``
    (``model.load_state_dict`` re-derives the glyph dedup tables; the
    pinyin tables come from the featurizer, ``install_pho_vocab_tables``)."""
    return _fit_to_model(
        normalize_state_dict(load_torch_bin(os.path.join(path, BIN_FILE))), cfg)


def merge_torch_state_dicts(
    bert_sd: Mapping[str, torch.Tensor],
    pho_sd: Optional[Mapping[str, torch.Tensor]] = None,
    res_sd: Optional[Mapping[str, torch.Tensor]] = None,
    sec_version: int = 0,
) -> Dict[str, torch.Tensor]:
    """merge.py's composition of the reference's state dicts (reference:
    merge.py:5-38; ``merge_torch_state_dicts`` of the JAX package): the
    pho-pretrain and res-pretrain dicts overlaid on the base dict, later
    wins, the res dict's ``resnet.`` keys first renamed ``char_resent.``
    with ``sec_version=1`` (merge.py:10-15); then the TOP-LEVEL
    ``position_embeddings.*`` and ``char_images.*`` keys are deleted.
    Replicated as the reference filters: the pho BERT's position embeddings
    are nested (``pho_model.embeddings.*``) and survive, and so do a
    multifont res-pretrain's glyphs (``char_images_multifonts``, no dot);
    only a single-font ``char_images.weight`` goes. The result reads with
    :func:`normalize_state_dict` like the released merged checkpoints."""
    merged: Dict[str, torch.Tensor] = dict(bert_sd)
    if pho_sd is not None:
        merged.update(pho_sd)
    if res_sd is not None:
        if sec_version == 1:
            res_sd = {("char_resent." + k[len("resnet."):]
                       if k.startswith("resnet.") else k): v
                      for k, v in res_sd.items()}
        merged.update(res_sd)
    return {k: v for k, v in merged.items()
            if not k.startswith(("position_embeddings.", "char_images."))}
