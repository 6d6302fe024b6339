"""Helpers the port's tests share (tests/test_torch_*.py)."""

import contextlib

import numpy as np
import torch


def live_glyph_features(params):
    """Shift every CharResNet BatchNorm bias of a JAX params tree by +1: at
    the tests' widths (1-6 channels a block) the ReLUs otherwise zero the
    features of most glyph rows (all of them at some seeds), and the glyph
    stream would be tested on zeros."""
    for block in params.get("res", {}).get("resnet", {}).values():
        for name, p in block.items():
            if "bn" in name:
                p["bias"] = p["bias"] + 1.0
    return params


def live_glyph_rows(model) -> int:
    """How many vocab rows of a port model's glyph stream have nonzero
    CharResNet features (eval mode, the running statistics)."""
    was_training = model.training
    model.eval()
    with torch.inference_mode():
        ids = torch.arange(model.char_images_multifonts.shape[0],
                           device=model.char_images_multifonts.device)
        feats = model.res_features(ids).float()
    model.train(was_training)
    return int((feats.abs().sum(1) > 0).sum())


@contextlib.contextmanager
def one_intra_op_thread():
    """Run the enclosed tiny-model work on one intra-op thread. At the
    tests' widths one thread is about as fast as eight alone, and many
    times faster while the test workers share the CPU, each with its own
    threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
