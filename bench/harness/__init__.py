"""The benchmark's general code: finding a cell's files by name, drawing
inputs from the seed, the closed loops, the profiler's reading, the FLOP
counts and the comparison that decides ``correct``."""
