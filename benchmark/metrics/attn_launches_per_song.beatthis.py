"""attn_launches_per_song.beatthis: the program's attention calls (its
``attn_launch.freq``, ``attn_launch.time`` and ``attn_launch.global``
counters) inside ``track`` spans of the traced song window, over the songs.
Nothing for a program that has no such counters."""

from benchmark import program_trace

KINDS = ("freq", "time", "global")


def read(ctx):
    try:
        from zeronotesamba_torch.utils import profiling
    except ImportError:
        return None
    if not set(KINDS) & set(profiling.totals("attn_launch.")):
        return None
    w = program_trace.load(ctx)
    per_song = [w.per_span(f"attn_launch.{kind}", "track") for kind in KINDS] if w else [None]
    return None if None in per_song else sum(per_song)
