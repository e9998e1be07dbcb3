"""val_share.finetune: the share of the traced zerons fine-tune window spent in its validation
passes (the benchmark's spans around ``run_epoch(train=False, score=True)``:
the forward, the DBN decode and the scoring of every song)."""

from benchmark.harness import span_share


def read(ctx):
    return span_share(ctx, "val_pass")
