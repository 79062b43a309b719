"""% of the traced window's device busy time spent in Kimi Delta
Attention's kernels (names holding ``kda_``). None where no such kernel
ran."""

from retrieval_bench import trace


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    w0, w1 = tr.window
    kda = [d for d in tr.device if "kda_" in d[2]]
    busy = sum(b - a for a, b in trace.merged(tr.device, w0, w1))
    if not kda or busy <= 0:
        return None
    return 100.0 * sum(b - a for a, b in trace.merged(kda, w0, w1)) / busy
