"""CUDA-event milliseconds per step of the Trainer's ``input`` span: the
time the card stalled while ``fit`` waited in ``next()`` for the batch
(about 0 where the queued work hid the wait)."""


def read(obs):
    if not obs.get("train") or not obs["steps"]:
        return None
    return obs["span_ms"].get("input")
