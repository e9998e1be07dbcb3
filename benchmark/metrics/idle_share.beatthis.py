"""idle_share.beatthis: the device's idle share of the traced Beat This! song
window: 1 - (the union of its kernels', copies' and sets' spans) / (the window's seconds)."""

from benchmark.harness import idle_share as read  # noqa: F401
