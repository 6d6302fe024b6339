"""The served model's share of the card's bf16 peak: the analytic forward
FLOPs of the real tokens of every sentence answered in the traced window
(``benchmark/roofline.py``: attention at each sentence's own length), over
the window's seconds times 989 TFLOP/s."""

from benchmark import roofline


def read(obs):
    if not obs.get("serve") or not obs["sentences"]:
        return None
    flops = roofline.model_forward_flops(obs["sentence_tokens"], obs["cfg"])
    return 100.0 * flops / (obs["trace"].window_s * roofline.PEAK_BF16_FLOPS)
