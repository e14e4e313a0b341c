"""peak_bytes_per_code: ``torch.cuda.max_memory_allocated()`` over set-up
and window, read by the benchmark when the window closes, over the corpus
size. On several cards: the sum over the ranks of each card's
``max_memory_allocated()``, read when the window closes, over the corpus
size: what the deployment's cards pay per code. Each card's peak holds
whatever that card held at once, and the program's sharded builds take
the whole corpus on every rank, so the corpus each rank made counts on
its card."""


def read(run):
    return run.peak_bytes / run.n_codes if run.peak_bytes else None
