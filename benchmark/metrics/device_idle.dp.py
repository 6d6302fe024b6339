"""Share of the traced data-parallel window in which no operation ran on a
card, the mean over the ranks (each rank's own ``torch.profiler`` trace;
each rank's value is on rank 0's standard error)."""


def read(obs):
    if not obs.get("dp"):
        return None
    t = obs["trace"]
    return 100.0 * (1.0 - t.busy_s / t.window_s)
