"""``repro_torch`` — the PyTorch/CUDA port of ProHD (the ``repro`` package's
counterpart on an NVIDIA H100).

Module layout mirrors ``repro`` so each counterpart is found by path::

    core/exact.py          plain PyTorch exact scans (the kernel's plain version)
    core/tile_bounds.py    projection prune tables
    core/projections.py    centroid + PCA directions
    core/selection.py      α-extreme selection
    core/bounds.py         §II-E additive bound
    core/projected.py      1-D projected Hausdorff
    core/prohd.py          Alg. 3
    core/variants.py       partial / chamfer reductions
    core/fp_margin.py      the pinned fp32 margins
    kernels/hausdorff/     the hand-written fused min-d² scan (CUDA C++)
    hd/                    the ``set_distance`` front door
    data/pointclouds.py    the paper's synthetic clouds
    interop.py             reference configs and numpy arrays → port objects

Device rule: entry points run on the card unless the caller asks for the
CPU (``device="cpu"`` or CPU tensors); see :mod:`repro_torch.device`.
"""
