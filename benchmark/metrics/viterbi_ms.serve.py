"""viterbi_ms.serve: the program's ``decode.viterbi`` spans (the native C++
Viterbi inside the DBN decode) in the traced song window, in ms a song."""

from benchmark import program_trace


def read(ctx):
    w = program_trace.load(ctx)
    return w.mean_ms("decode.viterbi", "track") if w else None
