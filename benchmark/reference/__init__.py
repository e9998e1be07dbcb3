"""The benchmark's plain reference: torch and numpy only, and nothing of the
program it judges. Each module recomputes one stage from the inputs the
benchmark made itself (songs, weights, seeds)."""
