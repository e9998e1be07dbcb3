"""pipeline_idle_share.serve: the device's idle time inside the program's
``track`` spans but outside their ``decode`` spans (the host's numpy and the
copies between the stages), on the trace's clock, as a share of the traced
song window."""

from benchmark import program_trace


def read(ctx):
    w = program_trace.load(ctx)
    if w is None:
        return None
    track, decode = w.idle_us(w.named("track")), w.idle_us(w.named("decode", "track"))
    return None if track is None else 100.0 * (track - decode) / 1e6 / ctx["window_s"]
