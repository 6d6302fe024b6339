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
    CharResNet features (eval mode, the running statistics), 1024 rows at a
    time (the published vocab's 21128 at once would hold gigabytes of
    activations)."""
    was_training = model.training
    model.eval()
    live = 0
    with torch.inference_mode():
        ids = torch.arange(model.char_images_multifonts.shape[0],
                           device=model.char_images_multifonts.device)
        for part in ids.split(1024):
            feats = model.res_features(part).float()
            live += int((feats.abs().sum(1) > 0).sum())
    model.train(was_training)
    return live


def jax_weights(sd, cfg):
    """A port state dict → the JAX package's (params, state), through its own
    importer (``import_realise_state_dict`` + ``overlay_params``) onto the
    structure of its init (``jax.eval_shape``, so nothing is initialised):
    every leaf of that structure must come from ``sd``."""
    import jax

    from realise_tpu.models.realise import _build_realise
    from realise_tpu.models.torch_import import (import_realise_state_dict,
                                                 overlay_params)

    base = jax.eval_shape(lambda key: _build_realise(key, cfg),
                          jax.random.PRNGKey(0))
    imported = import_realise_state_dict(
        {k: v.numpy() for k, v in sd.items()}, cfg)
    params, state = (overlay_params(b, i) for b, i in zip(base, imported))
    assert jax.tree.structure(params) == jax.tree.structure(base[0])
    missing = [leaf for leaf in jax.tree.leaves((params, state))
               if isinstance(leaf, jax.ShapeDtypeStruct)]
    assert not missing, f"{len(missing)} leaves not in the state dict"
    return params, state


@contextlib.contextmanager
def intra_op_threads(n: int):
    """Run the enclosed work on ``n`` torch intra-op threads: the test
    workers share the CPU, each with its own threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def one_intra_op_thread():
    """Tiny-model work on one intra-op thread: at the tests' widths one
    thread is about as fast as eight alone, and many times faster while the
    test workers share the CPU."""
    return intra_op_threads(1)
