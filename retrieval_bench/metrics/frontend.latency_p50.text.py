"""The median latency of the window's text requests in ms, each from when
it was due until its top-k reached the client: ``text_p50_ms`` read per
layer, in a cell whose host-bound text broker makes it too unsteady from
run to run to bound end to end. Read in the traced run, whose profiler
adds host work."""


def read(rec):
    return rec.get("text_p50_ms")
