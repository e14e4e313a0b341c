"""setup_s: seconds from process start to the first timed dispatch (host
clock): the corpus made on the card, the index built, the kernels built
or loaded, the warm-up batches. On several cards: from the parent
process's start to rank 0's first timed call, so starting the ranks
counts too."""


def read(run):
    return run.setup_s
