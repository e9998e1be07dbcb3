"""Hand-written Hopper kernels (csrc/), how they are built, and their wrappers."""
