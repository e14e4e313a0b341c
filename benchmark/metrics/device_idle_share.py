"""device_idle_share: 100 * (1 - the union of the card's busy intervals
in ``torch.profiler`` / the traced stretch's length). On several cards
every rank profiles its own card over the same turns; the busy seconds
are the mean over the cards (NCCL's kernels count as busy) and the
stretch is rank 0's."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * t.idle_share
