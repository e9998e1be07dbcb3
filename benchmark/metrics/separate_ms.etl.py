"""separate_ms.etl: the program's ``record.separate`` spans (Spleeter: the
song's upload, the STFT, the four nets, the masks and inverse STFTs, the
resample, both streams' download) inside ``record`` spans of the traced ETL
window, in ms a record."""

from benchmark import program_trace


def read(ctx):
    w = program_trace.load(ctx)
    return w.mean_ms("record.separate", "record") if w else None
