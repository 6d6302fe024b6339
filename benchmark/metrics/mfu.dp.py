"""The data-parallel step's share of the cards' bf16 peak: the analytic
FLOPs of the real tokens' forward and backward of every global batch in the
traced window (``benchmark/roofline.py``), over the window's seconds (the
ranks' mean) times the ranks times 989 TFLOP/s."""

from benchmark import roofline


def read(obs):
    if not obs.get("dp") or not obs["steps"]:
        return None
    flops = 3.0 * roofline.model_forward_flops(obs["sentence_tokens"],
                                               obs["cfg"])
    peak = obs["ranks"] * roofline.PEAK_BF16_FLOPS
    return 100.0 * flops / (obs["trace"].window_s * peak)
