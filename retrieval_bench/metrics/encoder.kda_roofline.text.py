"""Kimi Delta Attention's recurrence against its roofline: the least time
the window's replayed tiles need in their KDA layers, as % of the device
time of the kernels whose names hold ``kda_``. For each ``encoder.graph``
record wholly inside the window, with its real positions (``tokens``) and
the configuration's widths (``archs/kimi_linear.py``), each KDA layer
needs max(``kda_ops`` / 989 TFLOP/s, ``kda_bytes`` / 3.35 TB/s): the work
any implementation must do for the tile's real tokens. None where the
port keeps no such records, a record carries no ``tokens``, or no ``kda_``
kernel ran."""

from retrieval_bench import flops
from retrieval_bench.archs import kimi_linear
from retrieval_bench.metrics import program_spans


def read(rec):
    graphs = program_spans.records(rec, "encoder.graph".__eq__)
    if graphs is None:
        return None
    tr, m = rec["trace"], rec["model"]
    w0, w1 = tr.window
    least = 0.0
    for _, a, b, _, _, attrs in graphs:
        if not (w0 <= a and b <= w1):
            continue
        tokens = attrs.get("tokens")
        if tokens is None:
            return None
        least += kimi_linear.kda_layers(m) * max(
            kimi_linear.kda_ops(m, tokens) / flops.BF16_OPS_PER_S,
            kimi_linear.kda_bytes(m, tokens) / flops.HBM_BYTES_PER_S)
    kernel_ns = sum(min(b, w1) - max(a, w0) for a, b, name, _ in tr.device
                    if "kda_" in name and a < w1 and b > w0)
    if kernel_ns <= 0:
        return None
    return 100.0 * least / (kernel_ns / 1e9)
