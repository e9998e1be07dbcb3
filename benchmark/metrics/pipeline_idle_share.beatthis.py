"""pipeline_idle_share.beatthis: as pipeline_idle_share.serve reads it, in the
Beat This! song window: the device's idle time inside ``track`` spans but
outside their ``decode`` spans (the mix's pageable upload, the host's numpy
around the chunks, the download), as a share of the traced window."""

from benchmark import harness

read = harness.load_module(harness.HERE / "metrics" / "pipeline_idle_share.serve.py").read
