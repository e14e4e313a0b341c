"""setup_s: seconds from process start to the first timed dispatch (host
clock): the corpus made on the card, the index built, the kernels built
or loaded, the warm-up batches."""


def read(run):
    return run.setup_s
