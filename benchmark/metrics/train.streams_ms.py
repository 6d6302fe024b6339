"""CUDA-event milliseconds per step of the model's ``glyph`` and ``gru``
spans: the CharResNet over the step's distinct glyph rows with its
LayerNorm, and the factorized pinyin GRU (forward only; their backward is
inside the ``backward`` span)."""


def read(obs):
    if not obs.get("train") or not obs["steps"]:
        return None
    spans = obs["span_ms"]
    if "glyph" not in spans and "gru" not in spans:
        return None
    return spans.get("glyph", 0.0) + spans.get("gru", 0.0)
