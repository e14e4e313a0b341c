"""queries_per_s: queries whose answers ``mih_search_finalize`` returned
inside the window, over the seconds from the first timed dispatch to the
last of those answers (host clock)."""


def read(run):
    w = run.window
    return w.queries / w.span_s if w.batches else None
