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
    configs/               LMConfig, GNNConfig, RecsysConfig, shape cells
                           and the ten arch configs
    models/                RMSNorm, RoPE, attention, SwiGLU; the dense
                           transformer's prefill_step and serve_step;
                           GAT (gnn.py), the recsys zoo (recsys.py),
                           embeddings and retrieval top-k
    sharding/              logical-axis rules and DTensor placements
                           (axes.py), the collectives with a backward
                           (collectives.py)
    hd/                    the ``set_distance``, ``search`` and
                           ``search_batch`` front doors
    index/                 ``SetStore``, the certified cascade search and
                           its batched multi-query form
    serve/                 ``ProHDService`` and the async ``QueryEngine``
    launch/                the serving and training launchers; mesh.py (the
                           production meshes), specs.py (every dry-run
                           cell) and dryrun.py (``python -m``)
    analysis/              the bytes model, the roofline and its
                           counters, the report tables
    train/                 heartbeats and retry-with-recovery
    obs/, reliability/     spans and metrics; typed faults and injection
    data/pointclouds.py    the paper's synthetic clouds and the corpus
    data/synth.py          synthetic LM, GNN and recsys batches
    data/graphs.py         CSR graphs, the fanout sampler, the partitioner
    interop.py             reference configs, arrays, stores and LM, GAT
                           and recsys parameters → port objects

Device rule: entry points run on the card unless the caller asks for the
CPU (``device="cpu"`` or CPU tensors); see :mod:`repro_torch.device`.
"""
