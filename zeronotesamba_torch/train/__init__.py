"""Optimizer rules, the supervised engine and checkpoints."""
