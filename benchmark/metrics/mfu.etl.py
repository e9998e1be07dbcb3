"""mfu.etl: the four U-Nets' FLOPs on every segment of every record built in
the traced window (the frozen count of ``reference/spleeter.spleeter_flops``,
146.36 GFLOP a 30 s song's three segments), over the traced window, as a
share of one card's float32 peak (67 TFLOP/s)."""

from benchmark.harness import mfu as read  # noqa: F401
