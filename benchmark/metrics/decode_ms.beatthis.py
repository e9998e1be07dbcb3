"""decode_ms.beatthis: as decode_ms.serve reads it, in the Beat This! song
window: the program's ``decode`` spans (the peak picking on the host,
``decode.peaks`` inside) inside ``track`` spans, in ms a song."""

from benchmark import harness

read = harness.load_module(harness.HERE / "metrics" / "decode_ms.serve.py").read
