"""Mean host milliseconds a training step waited in ``next()`` on the
prefetched stream (the benchmark's iterator around the stream it hands to
``Trainer.fit``), over the traced window's steps."""


def read(obs):
    if not obs.get("train") or not obs["steps"]:
        return None
    return obs["input_wait_ms"]
