"""The text path's retrievals against their bandwidth bound."""

from retrieval_bench import readers


def read(rec):
    return readers.retrieval_roofline(rec)
