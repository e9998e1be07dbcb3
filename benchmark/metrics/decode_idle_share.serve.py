"""decode_idle_share.serve: the device's idle time (outside the union of the
trace's device events) inside the program's ``decode`` spans of the traced
song window, on the trace's clock, as a share of the window."""

from benchmark import program_trace


def read(ctx):
    w = program_trace.load(ctx)
    return w.idle_share(w.named("decode", "track")) if w else None
