"""Training driver (port of repro.launch.train): data pipeline -> fabric
train step -> checkpoints -> straggler log, on the card unless asked
otherwise.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
        --smoke --steps 50 --batch 8 --seq 64 [--device cpu]

Fault-tolerance wiring:
  * checkpoint every ``--ckpt-every`` steps (async, hash-chained);
  * ``--kill-at N`` simulates a coordinator death after step N: with
    ``--resume`` the driver restores the newest checkpoint, checks its
    chain, and the stateless data pipeline resumes the stream bit-exactly;
  * per-step durations feed the straggler policy (backup-endorsement
    decisions are logged).

The weights are drawn from ``torch.Generator(device).manual_seed(0)``: the
same on every run on one device (not the JAX package's draw, which the
tests carry over with ``convert``).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import base as cfg_base
from repro_torch.data import pipeline
from repro_torch.ft.membership import StragglerPolicy
from repro_torch.models.lm import LM, Batch
from repro_torch.training import optimizer, train_step as ts_lib


def build(arch: str, *, smoke: bool, seq: int, batch: int,
          microbatches: int, lr: float, total_steps: int, device=None):
    """(cfg, model without weights, TrainConfig, DataConfig), as the JAX
    launcher builds them (MoE at capacity factor 2.0); the model on
    ``device`` (the card by default). Every family trains."""
    cfg = cfg_base.get_smoke(arch) if smoke else cfg_base.get(arch)
    model = LM(cfg, vocab_chunk=min(seq, 128), moe_capacity_factor=2.0,
               device=device)
    tcfg = ts_lib.TrainConfig(
        opt=optimizer.AdamWConfig(lr=lr, warmup_steps=max(total_steps // 20,
                                                          5),
                                  total_steps=total_steps),
        microbatches=microbatches,
    )
    dcfg = pipeline.DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch,
        n_prefix=cfg.n_prefix if cfg.frontend == "vision" else 0,
        d_model=cfg.d_model,
        enc_frac=4 if cfg.family == "encdec" else 0,
    )
    return cfg, model, tcfg, dcfg


def device_batch(batch: Batch, device) -> Batch:
    """A pipeline batch (numpy fields) as tensors on ``device``."""
    move = lambda x: None if x is None else torch.from_numpy(
        np.ascontiguousarray(x)).to(device)
    return Batch(tokens=move(batch.tokens), labels=move(batch.labels),
                 prefix_embeds=move(batch.prefix_embeds),
                 enc_embeds=move(batch.enc_embeds))


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--kill-at", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    # A resumed run repeats the straight one bit for bit only on torch's
    # deterministic algorithms: the embedding's backward (an index_put_
    # with accumulate over repeated tokens) is not deterministic on the
    # CPU without them. cuBLAS needs its workspace fixed before CUDA
    # starts for that mode.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return _run(args)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)


def _run(args) -> dict:
    dev = resolve_device(args.device)
    cfg, model, tcfg, dcfg = build(
        args.arch, smoke=args.smoke, seq=args.seq, batch=args.batch,
        microbatches=args.microbatches, lr=args.lr, total_steps=args.steps,
        device=dev,
    )
    step_fn = ts_lib.make_train_step(model, tcfg)

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    state = ts_lib.init_state(model, torch.Generator(dev).manual_seed(0))
    if args.resume and ckpt and ckpt.list_steps():
        state, start = ckpt.restore(state)
        if not ckpt.verify_chain():
            raise RuntimeError("checkpoint chain verification failed")
        print(f"[restore] resumed from step {start} (chain verified)")

    straggler = StragglerPolicy()
    losses = []
    t_start = time.time()
    for step in range(start, args.steps):
        batch = device_batch(pipeline.global_batch_for_step(dcfg, step), dev)
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # waits for the step
        dt = time.time() - t0
        straggler.observe(dt)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms"
                  + (" [backup-candidate]"
                     if straggler.should_backup(dt) else ""))
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state)
        if args.kill_at is not None and step + 1 == args.kill_at:
            if ckpt:
                ckpt.wait()
            print(f"[kill] simulated failure after step {step}")
            return {"killed_at": step + 1, "losses": losses, "state": state}

    if ckpt:
        ckpt.save(args.steps, state, blocking=True)
        ckpt.close()
    tokens = (args.steps - start) * args.batch * args.seq
    wall = time.time() - t_start
    out = {
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "tokens_per_s": tokens / wall,
        "losses": losses,
        "final_step": args.steps,
        "state": state,
    }
    if losses:
        print(f"done: loss {out['first_loss']:.3f} -> "
              f"{out['last_loss']:.3f}, {out['tokens_per_s']:.0f} tok/s")
    return out


if __name__ == "__main__":
    run()
