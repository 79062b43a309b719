"""The serving step's share of the bf16 peak: the model FLOPs of the tokens
the window's requests hold (no rung padding), over the window."""

from retrieval_bench import readers


def read(rec):
    return readers.mfu(rec)
