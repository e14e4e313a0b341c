"""build_s: seconds of ``build_index`` over the cell's corpus, ending in
``torch.cuda.synchronize()`` (host clock)."""


def read(run):
    return run.build_s
