"""Reference weights: a ``pytorch_model.bin`` of the reference's ReaLiSe into
a port state dict (the port of ``load_torch_bin``, ``normalize_state_dict``
and ``import_checkpoint_dir`` of ``realise_tpu/models/torch_import.py``).

The port's modules carry the reference's parameter names, so importing is a
matter of spelling: strip DDP's ``module.`` wrapper, undo merge.py's
``char_resent.`` rename (merge.py:10-15), read the merged presets' shared
pho BERT ``pho_res_model.*`` (src/models.py:265,404) as the port's
``pho_model.*`` and an MLM head's ``cls.predictions.decoder.bias`` as
``cls.predictions.bias`` where only the first is saved (the JAX importer's
rule, torch_import.py:189-191), and set aside the entries that the
reference saves and the forward does not read:

* ``classifier.weight``: the classifier is tied to the word embeddings
  (src/models.py), so the tensor is the embedding table again;
* ``*.pooler.dense.*``: the BERT pooler, unused by the token classifier;
* ``*.embeddings.position_ids``: the position buffer of newer transformers;
* ``cls.predictions.decoder.bias`` beside ``cls.predictions.bias``:
  transformers saves the bias twice, the decoder's being the same tensor.

Each one set aside is logged by name. Every other key must be one of the
port model's and every key of the port model must be present, with its
shape; otherwise the import raises naming each missing, unexpected or
misshapen key.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict, Mapping

import torch

from realise_tpu_torch.config import RealiseConfig

logger = logging.getLogger("realise_tpu_torch")

BIN_FILE = "pytorch_model.bin"
_UNREAD = re.compile(r"^(classifier\.weight|(.+\.)?pooler\.dense\.(weight|bias)"
                     r"|(.+\.)?embeddings\.position_ids"
                     r"|cls\.predictions\.decoder\.bias)$")
_MLM_BIAS, _MLM_DECODER_BIAS = "cls.predictions.bias", "cls.predictions.decoder.bias"


def load_torch_bin(path: str) -> Dict[str, torch.Tensor]:
    """A ``pytorch_model.bin`` as CPU tensors."""
    return torch.load(path, map_location="cpu", weights_only=True)


def normalize_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Strip DDP's ``module.`` prefix, map merge.py's ``char_resent.`` back
    to ``resnet.`` and the merged presets' ``pho_res_model.`` to
    ``pho_model.``, and name an MLM decoder's bias ``cls.predictions.bias``
    when that key is absent."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        for old, new in (("char_resent.", "resnet."),
                         ("pho_res_model.", "pho_model.")):
            if k.startswith(old):
                k = new + k[len(old):]
        out[k] = v
    if _MLM_DECODER_BIAS in out and _MLM_BIAS not in out:
        out[_MLM_BIAS] = out.pop(_MLM_DECODER_BIAS)
    return out


def _fit_to_model(sd: Mapping[str, torch.Tensor],
                  cfg: RealiseConfig) -> Dict[str, torch.Tensor]:
    """A normalized reference state dict → the state dict of ``Realise(cfg)``,
    checked key for key and shape for shape against it."""
    from realise_tpu_torch.models.realise import Realise

    with torch.device("meta"):
        want = Realise(cfg).state_dict()
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
    """``{path}/pytorch_model.bin`` → a state dict for ``Realise(cfg)``
    (``model.load_state_dict`` re-derives the glyph dedup tables; the
    pinyin tables come from the featurizer, ``install_pho_vocab_tables``)."""
    return _fit_to_model(
        normalize_state_dict(load_torch_bin(os.path.join(path, BIN_FILE))), cfg)
