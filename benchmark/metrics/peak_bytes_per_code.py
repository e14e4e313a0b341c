"""peak_bytes_per_code: ``torch.cuda.max_memory_allocated()`` over set-up
and window, read by the benchmark when the window closes, over the corpus
size."""


def read(run):
    return run.peak_bytes / run.n_codes if run.peak_bytes else None
