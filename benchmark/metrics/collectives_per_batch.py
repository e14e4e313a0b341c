"""collectives_per_batch: the collectives one rank ran per batch of the
sharded engines, from the program's counters ``coll.calls`` over
``mih.sharded_batches`` (``verticut_tpu_torch.utils.timer.counters``),
read on rank 0: the ranks of a plane run the same collectives in
lockstep. A collective counts once where it is called, whatever it
moves; a batch counts once however often the engine re-runs part of it,
and its re-runs' collectives count to it. The counters add up the whole
process: warm-up, window and traced stretch, and the collectives of a
build that has any (the inline build has none). A program without the
counters, or without sharded batches (one card), reads nothing."""


def read(run):
    from verticut_tpu_torch.utils import timer
    counters = getattr(timer, "counters", None)
    if counters is None:
        return None
    c = counters()
    batches = c.get("mih.sharded_batches", 0)
    return c.get("coll.calls", 0) / batches if batches else None
