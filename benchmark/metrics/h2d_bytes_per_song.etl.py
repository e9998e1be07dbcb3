"""h2d_bytes_per_song.etl: the program's ``h2d_bytes`` counter inside
``record`` spans of the traced ETL window, over the records: the 44.1 kHz
song, float32, and its two 16 kHz streams going up again to the log-VQT."""

from benchmark import program_trace


def read(ctx):
    w = program_trace.load(ctx)
    return w.per_span("h2d_bytes", "record") if w else None
