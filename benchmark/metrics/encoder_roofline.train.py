"""The encoder layers' least time over their device time, in the traced
training window: for each step, every encoder layer's forward and backward
at the step's padded (batch, bucket) from ``benchmark/roofline.py`` (the
backward twice the forward, nothing recomputed), summed; over the device
seconds of the kernels listed under ``benchmark/kernels/encoder_train/``."""

import os

from benchmark import roofline
from benchmark.harness import kernel_groups


def read(obs):
    if not obs.get("train") or not obs["steps"]:
        return None
    functions = kernel_groups(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))["encoder_train"]
    seconds = obs["trace"].group_seconds(functions)
    if seconds <= 0:
        return None
    least = roofline.encoder_least_seconds(obs["step_shapes"], obs["cfg"],
                                           train=True)
    return 100.0 * least / seconds
