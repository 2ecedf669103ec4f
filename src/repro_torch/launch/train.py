"""Training launcher: --arch <id> [--steps N].

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b --device cpu

Counterpart of ``repro/launch/train.py``, with its arguments; every arch
of the registry runs, each family as the reference's launcher runs it:

* an LM arch: its ``smoke_lm_config`` (fp32, 2 layers) on synthetic token
  batches (``data.synth.lm_batch``);
* ``gat-cora``: GAT at its config on random graphs of 512 nodes, 2,048
  edges plus self-loops padded to 4,096, 64 features, 7 classes
  (``data.synth.gnn_batch``), node-classification loss;
* a recsys arch: its ``smoke_recsys_config`` on ``data.synth.recsys_batch``
  of ``--batch`` rows (``--seq`` is the LMs' only).

Step i's batch comes from a generator seeded i, the counterpart of the
reference's ``fold_in(key, i)``; the parameters from a generator seeded
0.  All go through ``train.loop.fit`` with the reference's AdamW (lr 1e-3,
weight decay 0.01): checkpointing with ``--ckpt-dir``, failure recovery,
the straggler detector.  Runs on the card (an LM: kernel 4's fp32 route in
every layer's forward) unless ``--device cpu`` is given.
``--drift-every`` is accepted and, as in the reference (which passes no
``drift_hook`` to ``fit``), has no effect.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--drift-every", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.base import load_arch, smoke_lm_config, smoke_recsys_config
    from repro_torch.data import synth
    from repro_torch.device import resolve_device
    from repro_torch.models import gnn as gnn_mod
    from repro_torch.models import recsys as rec_mod
    from repro_torch.models import transformer as lm_mod
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.loop import TrainConfig, fit

    dev = resolve_device(None, args.device)
    cfg = load_arch(args.arch).config

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    if cfg.family == "lm":
        cfg = smoke_lm_config(cfg)
        model = lm_mod.init_lm_params(gen(0), cfg)

        def loss_fn(p, b):
            return lm_mod.lm_loss(p, b, cfg)

        def make_batch(i):
            return synth.lm_batch(gen(i), cfg, args.batch, args.seq)

    elif cfg.family == "gnn":
        n, e, f, c = 512, 2048, 64, 7
        model = gnn_mod.init_gat_params(gen(0), cfg, f, c)

        def loss_fn(p, b):
            return gnn_mod.gat_node_loss(p, b, cfg)

        def make_batch(i):
            return synth.gnn_batch(gen(i), cfg, n_nodes=n, n_edges=e, d_feat=f, n_classes=c, pad_edges_to=4096)

    else:
        cfg = smoke_recsys_config(cfg)
        init, _, loss, *_ = rec_mod.get_model(cfg)
        model = init(gen(0), cfg)

        def loss_fn(p, b):
            return loss(p, b, cfg)

        def make_batch(i):
            return synth.recsys_batch(gen(i), cfg, args.batch, train=True)

    def data_iter(start):
        i = start
        while True:
            yield make_batch(i)
            i += 1

    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train] arch={args.arch} family={cfg.family} params={n_params/1e6:.2f}M steps={args.steps} "
          f"device={dev}")

    tc = TrainConfig(
        steps=args.steps,
        log_every=max(1, args.steps // 10),
        ckpt_every=max(1, args.steps // 4) if args.ckpt_dir else 0,
        ckpt_dir=args.ckpt_dir,
        drift_every=args.drift_every,
    )
    t0 = time.time()
    _, _, logs = fit(
        params=model,
        optimizer=opt_mod.adamw(lr=1e-3, weight_decay=0.01),
        loss_fn=loss_fn,
        data_iter_fn=data_iter,
        cfg=tc,
        log_fn=lambda s, r: print(f"  step {s:5d}: loss={r['loss']:.4f} dt={r['dt']*1e3:.0f}ms"),
    )
    print(f"[train] done in {time.time()-t0:.1f}s; loss {logs[0]['loss']:.4f} → {logs[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
