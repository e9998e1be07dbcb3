"""Experiment drivers."""
