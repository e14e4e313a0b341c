"""collective_mb_per_batch: megabytes (10^6 B) one rank handed to the
collectives per batch of the sharded engines: the program's counters
``coll.bytes`` (each collective's input, from its shape) over
``mih.sharded_batches``, read on rank 0, over the same stretch as
``collectives_per_batch``. An all-gather over D ranks moves D times its
input into every rank: the reading is what one rank sends. A program
without the counters, or without sharded batches, reads nothing."""


def read(run):
    from verticut_tpu_torch.utils import timer
    counters = getattr(timer, "counters", None)
    if counters is None:
        return None
    c = counters()
    batches = c.get("mih.sharded_batches", 0)
    return c.get("coll.bytes", 0) / 1e6 / batches if batches else None
