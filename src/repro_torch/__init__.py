"""``repro_torch`` — the PyTorch/CUDA port of ProHD and its LM scaffolding
(the ``repro`` package's counterpart on an NVIDIA H100).

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
    core/masked.py         masked exact HD and ProHD on padded clouds, over lanes
    kernels/hausdorff/     the hand-written scans (CUDA C++): the fused
                           min-d² scan, the batched and the multi-query
                           bucket scans
    kernels/flash_attention/  the hand-written flash-attention forward
                           (CUDA C++), its plain version and oracle
    configs/               LMConfig, shape cells and the dense LM configs
    models/                RMSNorm, RoPE, attention, SwiGLU; the dense
                           transformer's prefill_step and serve_step
    hd/                    the ``set_distance``, ``search`` and
                           ``search_batch`` front doors
    index/                 ``SetStore``, the certified cascade search and
                           its batched multi-query form
    serve/                 ``ProHDService`` and the async ``QueryEngine``
    launch/serve.py        the serving driver (``python -m``)
    train/                 heartbeats and retry-with-recovery
    obs/, reliability/     spans and metrics; typed faults and injection
    data/pointclouds.py    the paper's synthetic clouds and the corpus
    data/synth.py          synthetic LM token batches
    interop.py             reference configs, arrays, stores and LM
                           parameters → port objects

Device rule: entry points run on the card unless the caller asks for the
CPU (``device="cpu"`` or CPU tensors); see :mod:`repro_torch.device`.
"""
