"""CUDA-event milliseconds per step of the Trainer's ``prep`` and ``upload``
spans: the step's preamble (learning rate, ``model.train()``,
``zero_grad``) and the batch's split, glyph-row count and blocking copies
to the card."""

NAMES = ("prep", "upload")


def read(obs):
    if not obs.get("train") or not obs["steps"]:
        return None
    spans = obs["span_ms"]
    if not any(name in spans for name in NAMES):
        return None
    return sum(spans.get(name, 0.0) for name in NAMES)
