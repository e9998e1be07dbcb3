"""dbn_device_per_song.serve: the program's ``dbn.device`` counter (DBN
decodes whose Viterbi forward pass ran on the card) inside ``track`` spans
of the traced song window, over the songs. Nothing for a program that has
no such counter."""

from benchmark import program_trace


def read(ctx):
    try:
        from zeronotesamba_torch.utils import profiling
    except ImportError:
        return None
    if "device" not in profiling.totals("dbn."):
        return None
    w = program_trace.load(ctx)
    return w.per_span("dbn.device", "track") if w else None
