"""cands_per_query: the mean, over the window's answered queries, of the
``n_cands`` each result returns: the program's own count of candidates
the radius step scored. On several cards: rank 0's whole results, whose
counts the sharded engines sum over the (table, shard) plane."""


def read(run):
    w = run.window
    return w.cands / w.queries if w.queries else None
