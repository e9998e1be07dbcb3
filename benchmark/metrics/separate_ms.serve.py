"""separate_ms.serve: the program's ``track.separate`` spans (HPSS on the card,
with the song's upload and both stems' downloads) in the traced song window,
in ms a song (a ``track`` span)."""

from benchmark import program_trace


def read(ctx):
    w = program_trace.load(ctx)
    return w.mean_ms("track.separate", "track") if w else None
