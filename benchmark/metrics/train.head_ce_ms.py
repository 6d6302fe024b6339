"""CUDA-event milliseconds per step of the model's ``head+ce`` span: the
tied head's product (the logits) and the masked cross-entropy's forward.
Its backward is not in it."""


def read(obs):
    if not obs.get("train") or not obs["steps"]:
        return None
    return obs["span_ms"].get("head+ce")
