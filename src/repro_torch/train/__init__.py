"""``repro_torch.train`` — for now only the fault-tolerance helpers the
serving layer uses (``fault_tolerance.Heartbeat`` and
``run_with_recovery``); the training loop comes with ``models/``."""
