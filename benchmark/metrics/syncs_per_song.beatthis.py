"""syncs_per_song.beatthis: as syncs_per_song.serve reads it, in the Beat
This! song window: the ``d2h_syncs`` counter inside ``track`` spans, over the
songs: the logits and the log-mel."""

from benchmark import harness

read = harness.load_module(harness.HERE / "metrics" / "syncs_per_song.serve.py").read
