"""scan_rows_per_batch: query rows the scan tier ran (the budget of each
tier that ran, fallback re-runs' tiers too) per client batch, from the
program's counters ``mih.scan_budget_rows`` over ``mih.batches``
(``verticut_tpu_torch.utils.timer.counters``). A pipeline adds its
counts at its end, all at once, and a fallback re-run adds no batch. The
counters add up every pipeline of the process, so the reading covers
the warm-up batches, the window and the traced stretch, all of the
cell's traffic. A program without the counters reads nothing, and so do the sharded
engines (several cards), which count no client batches."""


def read(run):
    from verticut_tpu_torch.utils import timer
    counters = getattr(timer, "counters", None)
    if counters is None:
        return None
    c = counters()
    batches = c.get("mih.batches", 0)
    return c.get("mih.scan_budget_rows", 0) / batches if batches else None
