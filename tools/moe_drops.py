#!/usr/bin/env python3
"""Where MoE routing drops assignments: Qwen1.5-MoE-A2.7B (capacity
factor 2.0, as ``launch.train.build`` and the serving launcher build it,
bf16 with the router f32, weights drawn from seed 0) cut to each of
``--layers``, the share of routed assignments dropped by layer in forward
passes that differ in one thing at a time:

* ``pipeline 4 x 2048, loss``: the training step's forward (the port's
  pipeline batch of step 0, ``LM.loss``), as phase 21 of ``chip_smoke.py``
  counts it;
* ``pipeline 1 x 2048, loss``: its first row alone;
* ``uniform 4 x 2048, loss``: four prompts of uniform random tokens;
* ``uniform 1 x 2048, loss``: the first of them, which is phase 17's
  2,048-token prompt (``np.random.default_rng(0).integers(0, vocab,
  2048)``);
* ``uniform 1 x 2048, prefill``: the same prompt through ``LM.prefill``,
  as phase 17 serves it.

Capacity is set per ``moe_mlp`` call, so for T tokens of a call it is
``int(2.0 * T * 4 / 60)`` slots an expert. Needs one card (``--device
cpu --smoke`` rehearses it):

    PYTHONPATH=src python3 tools/moe_drops.py [--layers 4 24]

Prints a line a case and one JSON line."""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from repro_torch.data import pipeline
from repro_torch.launch import train
from repro_torch.models import moe
from repro_torch.models.lm import LM, Batch

ARCH, SEQ = "qwen2-moe-a2.7b", 2048


def _shares(model, fn) -> list:
    """Each layer's dropped share over the ``moe_mlp`` calls of ``fn()``
    (one call a layer)."""
    calls, real = [], moe.moe_mlp

    def recording(*a, **kw):
        st = {}
        out = real(*a, **kw, stats=st)
        calls.append(st)
        return out

    moe.moe_mlp = recording
    try:
        with torch.no_grad():
            fn()
    finally:
        moe.moe_mlp = real
    n = model.cfg.n_layers
    return [sum(int(c["dropped"]) for c in calls[i::n])
            / sum(c["assignments"] for c in calls[i::n]) for i in range(n)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[4, 24])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = torch.device(args.device or "cuda")
    seq = 64 if args.smoke else SEQ
    base, built, _, dcfg = train.build(ARCH, smoke=args.smoke, seq=seq,
                                       batch=4, microbatches=1, lr=1e-3,
                                       total_steps=100, device=dev)
    pb = train.device_batch(pipeline.global_batch_for_step(dcfg, 0), dev)
    uni = torch.as_tensor(np.stack([
        np.random.default_rng(0).integers(0, base.vocab, seq)] + [
        np.random.default_rng(1 + i).integers(0, base.vocab, seq)
        for i in range(3)]).astype(np.int32), device=dev)
    out = {}
    for layers in args.layers:
        cfg = dataclasses.replace(base, n_layers=layers, dtype="bfloat16")
        model = LM(cfg, vocab_chunk=built.vocab_chunk,
                   moe_capacity_factor=built.moe_cf, device=dev).init(
            torch.Generator(dev).manual_seed(0))
        one = uni[:1]
        cases = {
            f"pipeline 4 x {seq}, loss": lambda: model.loss(pb),
            f"pipeline 1 x {seq}, loss": lambda: model.loss(Batch(
                tokens=pb.tokens[:1], labels=pb.labels[:1])),
            f"uniform 4 x {seq}, loss": lambda: model.loss(Batch(
                tokens=uni, labels=uni)),
            f"uniform 1 x {seq}, loss": lambda: model.loss(Batch(
                tokens=one, labels=one)),
            f"uniform 1 x {seq}, prefill": lambda: model.prefill(
                Batch(tokens=one.long()), model.init_cache(1, seq)),
        }
        rows = {name: _shares(model, fn) for name, fn in cases.items()}
        for name, per in rows.items():
            print(f"[moe-drops] {layers} layers, {name}: by layer "
                  f"{[round(x * 100, 3) for x in per]} %", flush=True)
        out[str(layers)] = rows
        del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"moe_drops": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
