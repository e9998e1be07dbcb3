"""wgrad_launches_per_step.finetune: the program's ``conv_launch.wgrad`` counter
(weight gradients of the encoders' convs by the port's kernel) inside the
``epoch.step`` spans of the traced fine-tune window that lie outside the
benchmark's ``val_pass`` spans (the train steps), over those spans. Nothing
for a program that has no such counter."""

from benchmark import program_trace

COUNTER = "conv_launch.wgrad"


def read(ctx):
    try:
        from zeronotesamba_torch.utils import profiling
    except ImportError:
        return None
    if "wgrad" not in profiling.totals("conv_launch."):
        return None
    w = program_trace.load(ctx)
    if w is None:
        return None
    passes = [(a, b) for n, a, b in ctx["spans"].spans if n == "val_pass"]
    steps = {i for i, s in enumerate(w.spans) if s.name == "epoch.step" and s.end is not None
             and not any(a <= s.start and s.end <= b for a, b in passes)}
    if not steps:
        return None

    def in_step(i):
        while i >= 0 and i not in steps:
            i = w.spans[i].parent
        return i >= 0

    return sum(c.n for c in w.counts if c.name == COUNTER and in_step(c.span)) / len(steps)
