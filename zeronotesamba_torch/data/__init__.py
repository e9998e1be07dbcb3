"""Audio I/O, separation, stems and synthetic fixtures."""
