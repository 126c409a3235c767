"""``device_idle.train``: the share (%) of the traced training window in
which no operation ran on the device (``torch.profiler``'s device events,
their union)."""


def read(run):
    if run.facts.get("kind") != "train" or run.trace is None:
        return None
    t = run.trace
    if t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
