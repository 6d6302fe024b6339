"""The encoder layers' least forward time over their device time, in the
traced serving window: every encoder layer at each device step's padded
(rows, bucket) from ``benchmark/roofline.py``, summed, over the device
seconds of the kernels listed under ``benchmark/kernels/encoder_forward/``."""

import os

from benchmark import roofline
from benchmark.harness import kernel_groups


def read(obs):
    if not obs.get("serve") or not obs["step_shapes"]:
        return None
    functions = kernel_groups(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))["encoder_forward"]
    seconds = obs["trace"].group_seconds(functions)
    if seconds <= 0:
        return None
    least = roofline.encoder_least_seconds(obs["step_shapes"], obs["cfg"],
                                           train=False)
    return 100.0 * least / seconds
