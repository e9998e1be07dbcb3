"""conv_launches_per_song.serve: the program's ``conv_launch.fprop`` counter
(launches of the encoders' conv kernel) inside ``track`` spans of the traced
song window, over the songs. Nothing for a program that has no such counter."""

from benchmark import program_trace


def read(ctx):
    try:
        from zeronotesamba_torch.utils import profiling
    except ImportError:
        return None
    if "fprop" not in profiling.totals("conv_launch."):
        return None
    w = program_trace.load(ctx)
    return w.per_span("conv_launch.fprop", "track") if w else None
