"""h2d_bytes_per_song.serve: the program's ``h2d_bytes`` counter (bytes its
host sends to the card) inside ``track`` spans of the traced song window,
over the songs: the song and its two stems, float32."""

from benchmark import program_trace


def read(ctx):
    w = program_trace.load(ctx)
    return w.per_span("h2d_bytes", "track") if w else None
