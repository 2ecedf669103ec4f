"""End-to-end training on the PyTorch/CUDA port (the port of
``examples/train_lm.py``): a small GQA transformer LM trained with AdamW,
async checkpoints, a fault-tolerant resume, and ProHD drift monitoring of
the model's own hidden states through the ``repro_torch.hd`` front door (on
the card: ProHD's sweeps on the fused min-d² kernel, and the LM's attention
on the flash kernel).

One failure is injected (``--fail-at``) after a checkpoint: ``fit`` restores
the newest checkpoint and resumes from the step after it.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200]              # on the card
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 12    # plain versions
"""
import argparse
import tempfile

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.data import synth
from repro_torch.data.pointclouds import make_generator
from repro_torch.hd import HDConfig
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.loop import TrainConfig, fit, make_set_distance_metric

SEQ, BATCH = 64, 16


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--drift-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="step of the injected failure (default: the step after the first checkpoint; -1: none)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args()
    dev = torch.device(args.device)
    fail_at = args.ckpt_every + 1 if args.fail_at is None else args.fail_at
    fail_at = fail_at if 0 <= fail_at < args.steps else None

    cfg = LMConfig(
        name="demo-lm", n_layers=4, d_model=args.d_model, n_heads=8, n_kv_heads=2,
        d_ff=4 * args.d_model, vocab=512, dtype=torch.float32, attn_chunk=32, remat=False,
    )
    params = T.init_lm_params(make_generator(0, dev), cfg)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"model: {n_params / 1e6:.1f}M params on {dev}")

    reference_hidden = {}
    # Front-door drift metric: certified ProHD between hidden-state clouds.
    drift_metric = make_set_distance_metric(variant="hausdorff", method="prohd", config=HDConfig(alpha=0.05))
    probe = synth.lm_batch(make_generator(999_983, dev), cfg, BATCH, SEQ)["tokens"][:, :-1]

    def data_iter(start):
        i = start
        while True:
            yield synth.lm_batch(make_generator(1 + i, dev), cfg, BATCH, SEQ)
            i += 1

    def drift_hook(p, info):
        """ProHD between the current hidden states and the step-0 reference set."""
        hidden, _ = T.lm_forward(p, probe, cfg)
        flat = hidden.reshape(-1, cfg.d_model)
        if "ref" not in reference_hidden:
            reference_hidden["ref"] = flat
            return
        res = drift_metric(reference_hidden["ref"], flat)
        print(f"  [drift@{info['step']}] ProHD(hidden_t, hidden_0) = {float(res.value):.4f} "
              f"certified ≥ {float(res.lower):.4f}")

    def log_fn(step, rec):
        print(f"step {step:4d}: loss={rec['loss']:.4f} ce={rec['ce_loss']:.4f} dt={rec['dt'] * 1e3:.0f}ms")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        tc = TrainConfig(steps=args.steps, log_every=max(1, args.steps // 8), ckpt_every=args.ckpt_every,
                         ckpt_dir=ckpt_dir, drift_every=args.drift_every)
        if fail_at is not None:
            print(f"a failure is injected at step {fail_at}; fit resumes from its newest checkpoint")
        params, _, logs = fit(
            params=params,
            optimizer=opt_mod.adamw(lr=3e-4, weight_decay=0.01),
            loss_fn=lambda p, b: T.lm_loss(p, b, cfg),
            data_iter_fn=data_iter,
            cfg=tc,
            drift_hook=drift_hook,
            log_fn=log_fn,
            _fail_at=fail_at,
        )
    print(f"final loss: {logs[-1]['loss']:.4f} (from {logs[0]['loss']:.4f})")


if __name__ == "__main__":
    main()
