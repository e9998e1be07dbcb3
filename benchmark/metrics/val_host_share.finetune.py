"""val_host_share.finetune: the program's ``decode`` (the host DBN) and
``score`` (the beat metrics) spans inside the benchmark's ``val_pass`` spans,
as a share of the traced fine-tune window; the rest of ``val_share.finetune``
is the validation forward and its copies."""

from benchmark import program_trace


def read(ctx):
    w = program_trace.load(ctx)
    if w is None:
        return None
    passes = [(a, b) for n, a, b in ctx["spans"].spans if n == "val_pass"]
    host = sum(s.end - s.start for name in ("decode", "score") for s in w.named(name)
               if any(a <= s.start and s.end <= b for a, b in passes))
    return 100.0 * host / ctx["window_s"] if passes else None
