"""decode_ms.serve: the program's ``decode`` spans (the host DBN: its numpy,
the Viterbi and the beat picking) inside ``track`` spans of the traced song
window, in ms a song."""

from benchmark import program_trace


def read(ctx):
    w = program_trace.load(ctx)
    return w.mean_ms("decode", "track") if w else None
