"""Serving launcher: batched requests through the serving engine (port of
repro.launch.serve), on the card unless ``--device`` names another:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        --requests 12 --slots 4 --max-new 16 --device cpu

Runs the architecture's smoke config (dense or moe; a moe model with
capacity factor 2.0, as the JAX launcher builds it) with weights drawn from
a seeded generator; prints per-request outputs plus engine stats (steps,
tokens, the request-ledger versions that prove exactly-once slot
commits). Other families exit with the JAX launcher's message.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import base as cfg_base
from repro_torch.models.lm import LM
from repro_torch.serving.engine import Request, ServeEngine


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = cfg_base.get_smoke(args.arch)
    if cfg.family not in ("dense", "moe"):
        raise SystemExit("serving engine drives dense/moe archs "
                         f"(got {cfg.family}); ssm serving uses decode_step")
    model = LM(cfg, moe_capacity_factor=2.0, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    eng = ServeEngine(model, slots=args.slots, max_len=args.max_len)

    rng = np.random.default_rng(0)
    reqs = [
        Request(rid=i,
                prompt=rng.integers(0, cfg.vocab, args.prompt_len
                                    ).astype(np.int32),
                max_new=args.max_new)
        for i in range(args.requests)
    ]
    t0 = time.time()
    eng.run(reqs)
    wall = time.time() - t0
    done = sum(r.done or len(r.out) >= r.max_new for r in reqs)
    for r in reqs[:4]:
        print(f"req {r.rid}: {len(r.out)} tokens, ledger_version="
              f"{eng.request_version(r.rid)}")
    stats = {
        "completed": done,
        "total": len(reqs),
        "engine_steps": eng.steps,
        "tokens_out": eng.tokens_out,
        "tok_per_s": eng.tokens_out / wall,
        "device": str(dev),
    }
    print(stats)
    return stats


if __name__ == "__main__":
    run()
