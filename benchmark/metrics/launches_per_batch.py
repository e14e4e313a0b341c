"""launches_per_batch: kernels that ran on the card in the traced
stretch (``torch.profiler``'s device records, copies and fills left
out), per batch finalized in it. On several cards: rank 0's card, NCCL's
kernels among them."""


def read(run):
    t = run.trace
    if t is None or not t.launches or not t.batches:
        return None
    return t.launches / t.batches
