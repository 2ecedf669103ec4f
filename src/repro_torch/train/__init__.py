"""``repro_torch.train`` — training, the counterpart of ``repro.train``.

  * ``optimizer``: the reference's own AdamW, Adafactor and SGD (fp32
    master, factored second moments), over dicts of named tensors, plain
    or DTensors, with the reference's ``state_specs``;
  * ``loop``: ``make_train_step`` (fp32 gradient accumulation over
    microbatches), ``make_explicit_dp_step`` (compressed all-reduce over a
    ``torch.distributed`` group), ``fit`` (async checkpoints,
    restore-and-retry, heartbeat, straggler detection, a drift hook) and
    ``make_set_distance_metric``;
  * ``checkpoint``: atomic per-step directories in the reference's layout
    (the two packages read each other's), bf16 leaves included; DTensor
    trees saved whole and restored onto any mesh (``restore(mesh=,
    specs=)``);
  * ``compression``: int8 with error feedback and PowerSGD;
  * ``fault_tolerance``: ``Heartbeat``, ``HeartbeatMonitor``,
    ``StragglerDetector``, ``run_with_recovery`` (also used by serving).
"""
