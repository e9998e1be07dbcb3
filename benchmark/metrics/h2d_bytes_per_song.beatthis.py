"""h2d_bytes_per_song.beatthis: as h2d_bytes_per_song.serve reads it, in the
Beat This! song window: the ``h2d_bytes`` counter inside ``track`` spans, over
the songs: the mix, float32, once."""

from benchmark import harness

read = harness.load_module(harness.HERE / "metrics" / "h2d_bytes_per_song.serve.py").read
