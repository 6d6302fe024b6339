"""Operations and bytes of the model's work, counted from shapes, and the
published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at its full
700 W limit): 989 TFLOP/s in bf16, 3.35 TB/s of HBM.

The counts are the algorithm's, not an implementation's:

* an encoder layer's forward is its weight products (q, k, v, the output
  projection, the two FFN products: 2 * m * (4 H^2 + 2 H I) FLOPs over m
  token rows) plus attention (q.k^T and p.v: 4 * S^2 * H per sequence);
  its backward is twice its forward, with nothing recomputed;
* bytes: each input read once and each output written once (activations
  and weights in bf16; in the backward the weight gradients in float32);
* a model's forward per sentence of L tokens ([CLS] and [SEP] included):
  its encoder layers at that length, the gate (2 * 4H * 3 per token) and
  the tied head (2 * H * V per token). The GRU and the CharResNet depend
  only on the token id and are left out: how much of their work a step
  needs depends on how many distinct tokens it holds, not on the model.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def encoder_layers(cfg: Dict) -> int:
    n = cfg["num_hidden_layers"] + cfg["out_num_layers"]
    if cfg["pho_encoder"] != "none":
        n += cfg["pho_num_layers"]
    return n


def layer_forward_flops(tokens: int, seq_sq: int, cfg: Dict) -> float:
    """FLOPs of one encoder layer over ``tokens`` rows whose sequences'
    squared lengths sum to ``seq_sq``."""
    h, i = cfg["hidden_size"], cfg["intermediate_size"]
    return 2.0 * tokens * (4 * h * h + 2 * h * i) + 4.0 * h * seq_sq


def layer_weights(cfg: Dict) -> int:
    h, i = cfg["hidden_size"], cfg["intermediate_size"]
    return 4 * h * h + 2 * h * i


def layer_least_seconds(b: int, s: int, cfg: Dict,
                        train: bool) -> Tuple[float, str]:
    """(least seconds, 'operations' or 'bytes') of one encoder layer at a
    padded (b, s) block: forward, or forward plus backward."""
    h, m, w = cfg["hidden_size"], b * s, layer_weights(cfg)
    flops = layer_forward_flops(m, b * s * s, cfg)
    nbytes = 2 * 2 * m * h + 2 * w
    if train:
        flops *= 3.0
        nbytes += 3 * 2 * m * h + 2 * w + 4 * w
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def encoder_least_seconds(shapes: Iterable[Tuple[int, int]], cfg: Dict,
                          train: bool) -> float:
    """Least seconds of every encoder layer at each step's (b, s)."""
    n = encoder_layers(cfg)
    return sum(n * layer_least_seconds(b, s, cfg, train)[0] for b, s in shapes)


def model_forward_flops(lengths: Iterable[int], cfg: Dict) -> float:
    """Forward FLOPs of sentences of the given token counts."""
    h, v = cfg["hidden_size"], cfg["vocab_size"]
    tokens = seq_sq = 0
    for n in lengths:
        tokens += n
        seq_sq += n * n
    flops = encoder_layers(cfg) * layer_forward_flops(tokens, seq_sq, cfg)
    flops += 2.0 * h * v * tokens
    if cfg["fusion"] in ("gate", "softmax_gate"):
        streams = 1 + (cfg["pho_encoder"] != "none") + (cfg["res_encoder"] != "none")
        flops += 2.0 * (streams + 1) * h * streams * tokens
    return flops
