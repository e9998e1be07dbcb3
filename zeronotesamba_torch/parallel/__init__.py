"""Data parallelism over torch.distributed: the mesh and the rank launcher."""
