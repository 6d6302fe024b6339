"""Model / run configuration (the port's own copy of ``realise_tpu.config``).

One dataclass replaces the reference's BertConfig + the ad-hoc attributes the
runners graft onto it at startup (reference: src/run.py:421-425 copies
``image_model_type, num_fonts, with_pho, with_res, fusion`` onto the config so
they persist into checkpoint config.json). The whole 9-model zoo of the
reference (src/run.py:40-51) is expressed as presets over this single config —
the reference's own ablation model (src/models_abla.py:33-299) demonstrates the
zoo is one architecture behind flags.

Serialization is plain JSON next to checkpoints, mirroring the reference's
``config.json`` (+ ``training_args.bin``) convention.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict

# Pinyin alphabet sizes are fixed by the converters
# (reference: src/utils.py:11-16 → 65 symbols; src/utils.py:61-67 → 33 symbols).
PHO1_VOCAB_SIZE = 65
PHO2_VOCAB_SIZE = 33
# Max chars of a tone-first pinyin string ("2zhuang" = 7) + headroom, padded
# to a fixed width so featurized batches are static-shape (XLA requirement).
PHO2_MAX_LEN = 8

GLYPH_SIZE = 32  # 32x32 rasters (reference: src/models.py:703 font_size=32)


@dataclass
class RealiseConfig:
    """Architecture + featurization config for the unified ReaLiSe model."""

    # ---- BERT backbone (reference: transformers/configuration_bert.py:52-140)
    vocab_size: int = 21128
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12

    # ---- multimodal architecture ------------------------------------------
    # Which model of the reference zoo this config expresses; informational —
    # the wiring below is what the model actually reads.
    model_type: str = "bert-pho2-res-arch3"

    # Phonetic stream: "none" | "pho1" (initial/final/tone embedding sum,
    # src/models.py:75-161) | "pho2" (char-level pinyin GRU, src/models.py:661-672).
    pho_encoder: str = "pho2"
    pho_num_layers: int = 4          # pinyin transformer depth (src/models.py:670-672)

    # Graphic stream: "none" | "resnet" (CharResNet, src/char_cnn.py:35-55) |
    # "resnet1" (CharResNet1, src/char_cnn.py:57-74; --image_model_type 1).
    res_encoder: str = "resnet"
    num_fonts: int = 3               # glyph channels (src/models.py:678)
    use_traditional_font: bool = True

    # Stream fusion:
    #   "baseline"  — semantic only (SpellBert, src/models.py:32-73)
    #   "merged"    — pho(+res summed) second stream, concat+linear integrate
    #                 (SpellBertPho1/2[,Res], src/models.py:75-511)
    #   "concat"    — concat(sem,pho,res) + linear (arch2, src/models.py:513-649)
    #   "gate"      — per-token 3-way sigmoid gate (arch3, src/models.py:689,840-850)
    #   "softmax_gate" — softmax over the 3 gates (arch4, src/models.py:1144-1148)
    #   "sum"       — plain sum of streams (ablation, src/models_abla.py:246-279)
    fusion: str = "gate"

    out_num_layers: int = 3          # output block depth (src/models.py:691-693)
    # Every zoo model with an output block passes position_ids=zeros to it —
    # unconditional in the reference (src/models.py:144,232,363,494,632,853).
    zero_out_positions: bool = True

    # Correction head: "linear_tied" (classifier tied to word embeddings,
    # src/models.py:700-701) | "mlm" (BertOnlyMLMHead, src/models.py:912,1009).
    head: str = "linear_tied"

    # ---- featurization ----------------------------------------------------
    max_seq_length: int = 128        # fixed-shape sequences (run.py:304)
    pho2_max_len: int = PHO2_MAX_LEN
    glyph_size: int = GLYPH_SIZE

    # ---- numerics ---------------------------------------------------------
    dtype: str = "float32"           # activation dtype ("bfloat16" to serve)
    param_dtype: str = "float32"
    remat: bool = False              # read by the JAX package's trainer only

    extras: Dict[str, Any] = field(default_factory=dict)

    # -----------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def with_pho(self) -> bool:
        return self.pho_encoder != "none"

    @property
    def with_res(self) -> bool:
        return self.res_encoder != "none"

    @property
    def num_streams(self) -> int:
        return 1 + int(self.with_pho) + int(self.with_res)

    def replace(self, **kw) -> "RealiseConfig":
        return dataclasses.replace(self, **kw)

    # ---- JSON round-trip --------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RealiseConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        extras = {k: v for k, v in d.items() if k not in known}
        cfg = cls(**kwargs)
        cfg.extras.update(extras)
        return cfg

    def save(self, directory: str, name: str = "config.json") -> str:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, name)
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_json())
        return path

    @classmethod
    def load(cls, directory_or_file: str) -> "RealiseConfig":
        path = directory_or_file
        if os.path.isdir(path):
            path = os.path.join(path, "config.json")
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))


def _preset(**kw) -> Dict[str, Any]:
    return kw


# The reference model zoo (src/run.py:40-51) as config presets.
MODEL_PRESETS: Dict[str, Dict[str, Any]] = {
    "bert": _preset(
        pho_encoder="none", res_encoder="none", fusion="baseline",
        out_num_layers=0),
    "bert-pho1": _preset(
        pho_encoder="pho1", res_encoder="none", fusion="merged",
        out_num_layers=2),
    "bert-pho2": _preset(
        pho_encoder="pho2", res_encoder="none", fusion="merged",
        out_num_layers=2),
    "bert-pho1-res": _preset(
        pho_encoder="pho1", res_encoder="resnet", fusion="merged",
        out_num_layers=2, num_fonts=1, use_traditional_font=False),
    "bert-pho2-res": _preset(
        pho_encoder="pho2", res_encoder="resnet", fusion="merged",
        out_num_layers=2, num_fonts=1, use_traditional_font=False),
    "bert-pho2-res-arch2": _preset(
        pho_encoder="pho2", res_encoder="resnet", fusion="concat",
        out_num_layers=2, num_fonts=1, use_traditional_font=False),
    "bert-pho2-res-arch3": _preset(
        pho_encoder="pho2", res_encoder="resnet", fusion="gate",
        out_num_layers=3, zero_out_positions=True),
    "bert-pho2-res-arch3-mlm": _preset(
        pho_encoder="pho2", res_encoder="resnet", fusion="gate",
        out_num_layers=3, zero_out_positions=True, head="mlm"),
    "bert-pho2-res-arch4": _preset(
        pho_encoder="pho2", res_encoder="resnet", fusion="softmax_gate",
        out_num_layers=3, zero_out_positions=True),
    # Pretraining stages (src/models.py:1286-1347, 1349-1488, 1174-1284).
    "pho2-pretrain": _preset(
        pho_encoder="pho2", res_encoder="none", fusion="pretrain",
        head="mlm", out_num_layers=0),
    "res-pretrain": _preset(
        pho_encoder="none", res_encoder="resnet", fusion="pretrain",
        head="linear", out_num_layers=0),
    "pho2-res-pretrain": _preset(
        pho_encoder="pho2", res_encoder="resnet", fusion="pretrain",
        head="mlm", out_num_layers=0),
}


def config_for(model_type: str, **overrides) -> RealiseConfig:
    """Build the config for a reference ``--model_type`` string.

    The ablation switches of src/models_abla.py (``with_pho/with_res/fusion``)
    are expressed via ``overrides`` (e.g. ``pho_encoder='none'`` or
    ``fusion='sum'``) on top of the arch3 preset.
    """
    if model_type not in MODEL_PRESETS:
        raise KeyError(
            f"unknown model_type {model_type!r}; known: {sorted(MODEL_PRESETS)}")
    kw = dict(MODEL_PRESETS[model_type])
    kw["model_type"] = model_type
    kw.update(overrides)
    cfg = RealiseConfig(**kw)
    if cfg.fusion == "merged" and not (cfg.with_pho or cfg.with_res):
        # Would reach concat_fusion with a None stream deep inside
        # apply_realise — fail here with a config error instead.
        raise ValueError(
            f"{model_type!r} with fusion='merged' needs at least one of the "
            f"pho/res streams (got pho_encoder={cfg.pho_encoder!r}, "
            f"res_encoder={cfg.res_encoder!r}); use fusion='baseline' for "
            f"a semantic-only model")
    return cfg
