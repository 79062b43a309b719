"""% of the traced stream window in which the device is idle while one of
the port's ``engine.*`` spans (plan, launch, read, certify, fallback,
copy out) is open."""

from retrieval_bench.metrics import program_spans


def read(rec):
    return program_spans.idle_share(
        rec, lambda name: name.startswith("engine."))
