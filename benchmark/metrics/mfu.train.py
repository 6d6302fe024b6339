"""The whole training step's share of the card's bf16 peak: the analytic
FLOPs of the real tokens' forward and backward (three times the forward,
attention at each sentence's own length; ``benchmark/roofline.py``) of the
steps in the traced window, over the window's seconds times 989 TFLOP/s."""

from benchmark import roofline


def read(obs):
    if not obs.get("train") or not obs["steps"]:
        return None
    flops = 3.0 * roofline.model_forward_flops(obs["sentence_tokens"],
                                               obs["cfg"])
    return 100.0 * flops / (obs["trace"].window_s * roofline.PEAK_BF16_FLOPS)
