"""Encoder family and weight carry-over."""
