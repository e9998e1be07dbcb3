"""Share one forward pass's piecewise decisions with another, for comparing
a train step's gradients across two devices.

The encoder is piecewise linear: each max-pool window routes its gradient to
one input, and each ReLU passes or blocks its own. Two float32 evaluations
(the card's cuDNN and the CPU's convs) agree on those decisions except where
a window's two largest inputs, or a ReLU input and 0, lie within rounding of
each other. Near the NT-Xent plateau the weight gradients are sums that
cancel heavily, so one such flip moves a tensor's gradient by up to about 1e-2
of its largest entry. ``PiecewiseDecisions.record`` keeps one run's argmaxes
and signs; ``replay`` makes another run take them, so both backward passes
follow the same linear piece and their gradients differ by rounding alone.
The forward values differ only by rounding too: a replayed window's value is
an input within rounding of the window's maximum.

The wrappers patch ``torch.nn.functional.max_pool2d`` and ``relu``, which the
encoder looks up at each call, for the duration of the context only.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Tuple

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def _patched(max_pool2d, relu) -> Iterator[None]:
    saved = F.max_pool2d, F.relu
    F.max_pool2d, F.relu = max_pool2d, relu
    try:
        yield
    finally:
        F.max_pool2d, F.relu = saved


class PiecewiseDecisions:
    """The max-pool argmaxes and ReLU signs of the forward passes run inside
    ``record()``, in call order, kept on the CPU."""

    def __init__(self):
        self.log: List[Tuple[str, torch.Tensor]] = []

    @contextlib.contextmanager
    def record(self) -> Iterator["PiecewiseDecisions"]:
        pool, relu = F.max_pool2d, F.relu

        def max_pool2d(h, kernel_size, stride=None, **kw):
            out, idx = pool(h, kernel_size, stride, return_indices=True, **kw)
            self.log.append(("pool", idx.cpu()))
            return out

        def relu_(h, inplace=False):
            self.log.append(("relu", (h > 0).cpu()))
            return relu(h, inplace)

        with _patched(max_pool2d, relu_):
            yield self

    @contextlib.contextmanager
    def replay(self) -> Iterator["PiecewiseDecisions"]:
        """Run the same forward passes with the recorded decisions: each pool
        takes the recorded input of its window, each ReLU the recorded sign."""
        calls = iter(self.log)

        def take(kind: str, h: torch.Tensor) -> torch.Tensor:
            got, decision = next(calls)
            if got != kind:
                raise RuntimeError(f"replay expected a {got} call, the forward made a {kind} call")
            return decision.to(h.device)

        def max_pool2d(h, kernel_size, stride=None, **kw):
            idx = take("pool", h)
            return h.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)

        def relu_(h, inplace=False):
            return torch.where(take("relu", h), h, torch.zeros((), dtype=h.dtype, device=h.device))

        with _patched(max_pool2d, relu_):
            yield self
        if next(calls, None) is not None:
            raise RuntimeError("replay left recorded decisions unused")

    def differing(self, other: "PiecewiseDecisions") -> int:
        """How many pool windows and ReLUs decided otherwise in ``other``."""
        if [k for k, _ in self.log] != [k for k, _ in other.log]:
            raise ValueError("the two records come from different forward passes")
        return int(sum((a != b).sum() for (_, a), (_, b) in zip(self.log, other.log)))
