"""Flash attention (forward): the hand-written CUDA kernel, its plain version
and the naive oracle."""
