"""CUDA-event milliseconds per step of the train kernels' backward spans,
``encoder.attn_bwd`` and ``encoder.ffn_bwd``: every encoder layer's
attention and FFN backward (inside the ``backward`` span)."""

NAMES = ("encoder.attn_bwd", "encoder.ffn_bwd")


def read(obs):
    if not obs.get("train") or not obs["steps"]:
        return None
    spans = obs["span_ms"]
    if not any(name in spans for name in NAMES):
        return None
    return sum(spans.get(name, 0.0) for name in NAMES)
