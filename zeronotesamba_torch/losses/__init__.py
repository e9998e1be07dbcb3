"""Masked BCE and NT-Xent."""
