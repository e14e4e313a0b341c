"""build_s: seconds of ``build_index`` over the cell's corpus, ending in
``torch.cuda.synchronize()`` (host clock). On several cards: the
program's sharded build, the largest of the ranks' times."""


def read(run):
    return run.build_s
