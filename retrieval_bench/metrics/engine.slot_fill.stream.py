"""The share of the engine's job slots that real rows needed, over the
stream window's tiles: the sum of ``jobs_real`` over the sum of
``jobs_slab`` (rows times jobs a query, padded rows included) of the
port's ``engine.copy_out`` records."""

from retrieval_bench.metrics import program_spans


def read(rec):
    return program_spans.slot_fill(rec)
