"""Data pipeline: synthetic generators, point clouds, graph samplers, recsys batches."""
