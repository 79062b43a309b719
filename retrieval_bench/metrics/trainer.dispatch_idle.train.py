"""% of the traced training window in which the device is idle while the
Trainer's ``train.forward`` or ``train.backward`` span is open: the host
dispatching the step slower than the device runs it."""

from retrieval_bench.metrics import program_spans


def read(rec):
    return program_spans.idle_share(
        rec, lambda name: name in ("train.forward", "train.backward"))
