"""The benchmark's plain reference of the ReaLiSe model: float32 PyTorch,
TF32 off, no kernel, no cache, no batching trick of the program.

It imports nothing of ``realise_tpu_torch``, ``realise_tpu`` or JAX. It is
handed the benchmark's own seeded weights and inputs (``benchmark/inputs.py``)
and works out again whatever the program derives from them: the vocabulary's
pinyin ids, the glyph features, the GRU states, the dropout masks (the
counter hash, from the same seed the program's trainer is given) and the
optimizer's arithmetic.

* :mod:`text`: the synthetic vocabulary and the tone-first pinyin ids, read
  from the raw pinyin table both sides read;
* :mod:`dropout`: the counter-hash masks of the training step;
* :mod:`model`: the forward pass (training and eval), the loss, and an fp8
  variant of every product, the control;
* :mod:`optim`: the global-norm clip and AdamW;
* :mod:`compare`: the numbers that decide ``correct``.

A configuration whose model has a part :mod:`model` lacks names its own
class, a subclass in a module of its own, under ``reference_class``;
:func:`reference_class` is the one place that reads the key.
"""

import importlib

DEFAULT_REFERENCE = "benchmark.reference.model:Reference"


def reference_class(cfg):
    """The reference class of a configuration: its file's
    ``reference_class``, ``"<module under benchmark/>:<class>"`` (the
    default :class:`benchmark.reference.model.Reference`). The class takes
    ``(cfg, weights, pho_ids, pho_lens, precision=)`` and has ``forward``
    as that one does."""
    spec = cfg.get("reference_class", DEFAULT_REFERENCE)
    module, _, name = spec.partition(":")
    if not module.startswith("benchmark.") or not name:
        raise ValueError(f"reference_class {spec!r} is not "
                         "'benchmark.<module>:<class>'")
    return getattr(importlib.import_module(module), name)
