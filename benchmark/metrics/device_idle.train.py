"""Share of the traced training window in which no operation ran on the
card (``torch.profiler``: kernels, copies, sets)."""


def read(obs):
    if not obs.get("train"):
        return None
    t = obs["trace"]
    return 100.0 * (1.0 - t.busy_s / t.window_s)
