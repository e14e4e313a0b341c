"""queries_per_s: queries whose answers ``mih_search_finalize`` returned
inside the window, over the seconds from the first timed dispatch to the
last of those answers (host clock). On several cards (a configuration
with a ``mesh``): rank 0's clock, from its first timed call to the last
answer inside the window, of the sharded search every rank makes in
lockstep."""


def read(run):
    w = run.window
    return w.queries / w.span_s if w.batches else None
