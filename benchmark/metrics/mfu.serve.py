"""mfu.serve: the songs' encoder FLOPs (the twin forward at the frozen count, 414,036,224
a frame a stream), over the traced window, as a share of one
card's float32 peak (67 TFLOP/s)."""

from benchmark.harness import mfu as read  # noqa: F401
