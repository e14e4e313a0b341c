"""device_idle_share: 100 * (1 - the union of the card's busy intervals
in ``torch.profiler`` / the traced stretch's length)."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * t.idle_share
