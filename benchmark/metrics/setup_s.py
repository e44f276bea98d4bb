"""Seconds from the process's start to the window's: imports, the corpus,
the weights, the pipeline's boot with its indexes, and the warm-up."""


def read(rec):
    return rec.setup_s
