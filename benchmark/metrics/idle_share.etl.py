"""idle_share.etl: the device's idle share of the traced ETL window: 1 - (the
union of its kernels', copies' and sets' spans) / (the window's seconds)."""

from benchmark.harness import idle_share as read  # noqa: F401
