"""mfu.beatthis: the songs' Beat This! forward FLOPs (every chunk of every song
tracked in the traced window, at the frozen count of
``reference/beat_this.forward_flops``, 134.71 GFLOP a 1,500-frame chunk),
over the traced window, as a share of one card's float32 peak (67 TFLOP/s)."""

from benchmark.harness import mfu as read  # noqa: F401
