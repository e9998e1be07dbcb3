"""segments_per_song.etl: the program's ``spleeter.segments`` counter (the
song's segments of 512 frames, each net's batch) inside ``record`` spans of
the traced ETL window, over the records: 3 for a 30 s song. Nothing for a
program that has no such counter."""

from benchmark import program_trace


def read(ctx):
    try:
        from zeronotesamba_torch.utils import profiling
    except ImportError:
        return None
    if "segments" not in profiling.totals("spleeter."):
        return None
    w = program_trace.load(ctx)
    return w.per_span("spleeter.segments", "record") if w else None
