"""CUDA-event milliseconds per step of the Trainer's ``clip+adamw`` span
(the division by the count, the global-norm clip and AdamW)."""


def read(obs):
    if not obs.get("train") or not obs["steps"]:
        return None
    return obs["span_ms"].get("clip+adamw")
