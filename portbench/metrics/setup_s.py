"""setup_s: seconds from the process's start to the first timed batch's
send: imports, the card's context, the collection made, the index built,
kernels built or loaded, the warm-up batches."""


def read(rec):
    return rec.setup_s
