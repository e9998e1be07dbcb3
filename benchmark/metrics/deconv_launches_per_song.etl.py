"""deconv_launches_per_song.etl: the program's ``spleeter.deconv_launch``
counter (the decoder kernel's launches a song, csrc/deconv_fprop.cu: one a
net and decoder block, 24 a song on a card) inside ``record`` spans of the
traced ETL window, over the records. Nothing for a program that has no such
counter."""

from benchmark import program_trace


def read(ctx):
    try:
        from zeronotesamba_torch.utils import profiling
    except ImportError:
        return None
    if "deconv_launch" not in profiling.totals("spleeter."):
        return None
    w = program_trace.load(ctx)
    return w.per_span("spleeter.deconv_launch", "record") if w else None
