"""syncs_per_song.serve: the program's ``d2h_syncs`` counter (copies from the
card its host waits on) inside ``track`` spans of the traced song window,
over the songs."""

from benchmark import program_trace


def read(ctx):
    w = program_trace.load(ctx)
    return w.per_span("d2h_syncs", "track") if w else None
