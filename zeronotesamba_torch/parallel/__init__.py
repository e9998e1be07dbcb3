"""Parallelism over torch.distributed: the mesh over data, time and model
axes, the rank launcher, the halo exchange and the channel gathers of the
sharded convs, and the multichip dry run."""
