"""Training launcher: real (reduced-size) runs with checkpoint and restart.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --steps 100 --batch 8 --seq 128 [--device cpu]

``--reduced`` (always on, as in the JAX package's launcher) swaps in the
smoke config family.  Every arch trains, the encoder-decoder (``--arch
seamless-m4t-medium``) on the stub audio frames ``batch_for`` adds.
Runs on CUDA unless ``--device cpu`` is given.  The initial state is
drawn on the host from ``--seed`` and moved to the device, so a seed
starts from the same state on every device, as the JAX package's keys
do.  Supports periodic checkpointing and restart (the migration cost
path).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.device import resolve_device
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.data import batch_for, to_device
from repro_torch.train.optimizer import AdamWConfig, tree_map
from repro_torch.train.step import TrainConfig, make_train_step, train_state_init


def train_loop(
    cfg,
    steps: int,
    batch_size: int,
    seq_len: int,
    lr: float = 1e-3,
    microbatches: int = 1,
    ckpt_path: str | None = None,
    ckpt_every: int = 0,
    resume: bool = False,
    log_every: int = 10,
    seed: int = 0,
    device=None,
):
    device = resolve_device(device)
    tc = TrainConfig(
        optimizer=AdamWConfig(learning_rate=lr, warmup_steps=max(steps // 10, 1)),
        microbatches=microbatches,
    )
    state = train_state_init(torch.Generator().manual_seed(seed), cfg, tc)
    state = tree_map(lambda t: t.to(device), state)
    start_step = 0
    if resume and ckpt_path:
        state, start_step = restore_checkpoint(ckpt_path, state)
        print(f"resumed from {ckpt_path} at step {start_step}")
    step_fn = make_train_step(cfg, tc)

    losses = []
    t0 = time.perf_counter()
    for step in range(start_step, steps):
        batch = batch_for(
            cfg.vocab_size,
            batch_size,
            seq_len,
            seed=seed,
            step=step,
            frontend=cfg.frontend,
            frontend_len=cfg.frontend_len,
            d_model=cfg.d_model,
        )
        state, metrics = step_fn(state, to_device(batch, device))
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            dt = time.perf_counter() - t0
            print(
                f"step {step:5d}  loss {loss:.4f}  nll {float(metrics['nll']):.4f}"
                f"  grad_norm {float(metrics['grad_norm']):.3f}  ({dt:.1f}s)"
            )
        if ckpt_path and ckpt_every and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_path, state, step + 1)
    return state, losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    print(f"training {cfg.name}: ~{cfg.param_count() / 1e6:.1f}M params")
    _, losses = train_loop(
        cfg,
        steps=args.steps,
        batch_size=args.batch,
        seq_len=args.seq,
        lr=args.lr,
        microbatches=args.microbatches,
        ckpt_path=args.ckpt,
        ckpt_every=args.ckpt_every,
        resume=args.resume,
        seed=args.seed,
        device=device,
    )
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"loss: first10={first:.4f} last10={last:.4f} improved={last < first}")


if __name__ == "__main__":
    main()
