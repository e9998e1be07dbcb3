"""mfu.finetune: the window's train steps (three forwards each) and validation forwards
at the frozen count, over the traced window, as a share of one
card's float32 peak (67 TFLOP/s)."""

from benchmark.harness import mfu as read  # noqa: F401
