"""cands_per_query: the mean, over the window's answered queries, of the
``n_cands`` each result returns: the program's own count of candidates
the radius step scored."""


def read(run):
    w = run.window
    return w.cands / w.queries if w.queries else None
