"""% of the traced window's device busy time spent in the routed-expert
layer's kernels (names holding ``moe_``: route, the two grouped products,
the combine). None where no such kernel ran."""

from retrieval_bench import trace


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    w0, w1 = tr.window
    moe = [d for d in tr.device if "moe_" in d[2]]
    busy = sum(b - a for a, b in trace.merged(tr.device, w0, w1))
    if not moe or busy <= 0:
        return None
    return 100.0 * sum(b - a for a, b in trace.merged(moe, w0, w1)) / busy
