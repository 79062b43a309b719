"""The training step's share of the bf16 peak: the model FLOPs of the
window's micro steps (the layers' forward three times under full remat,
the head's twice) over the window."""

from retrieval_bench import readers


def read(rec):
    return readers.mfu(rec)
