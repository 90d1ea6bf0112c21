#!/usr/bin/env python3
"""What writing bf16 leaves as f32 costs a checkpoint: the port's
``Checkpointer.save`` of a bf16 training state timed in turns in its two
formats, bf16 leaves as f32 (the format the checkpointer writes) and as
their raw 16-bit words (the format it wrote before, which the JAX package
cannot restore), with each file's size:

    PYTHONPATH=src python3 tools/checkpoint_cost.py [--dir DIR]
    PYTHONPATH=src python3 tools/checkpoint_cost.py --device cpu --smoke

The state is phase 16's of ``chip_smoke.py`` by default: Qwen2-7B at full
width cut to 4 layers, bf16 params with f32 AdamW moments, drawn on the
card from seed 0 (``--smoke``: the smoke config). Each save is blocking: ``host_s`` is ``save``'s copy
of the state to the host, ``write_s`` the writer's digests and npz write
(to DIR, the system's temporary directory by default, through the page
cache), ``total_s`` both; the turns run words, f32, f32, words, each into
a fresh directory removed after it. The f32 file restores bit for bit
into the state (checked once). Prints one JSON line."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import checkpointer as ck_lib
from repro_torch.launch import train
from repro_torch.models.lm import LM
from repro_torch.training import train_step as ts_lib

ARCH, LAYERS = "qwen2-7b", 4  # chip_smoke.py's TRAIN_ARCH, TRAIN_LAYERS


def _words(real):
    """``checkpointer._to_host`` with bf16 leaves as raw 16-bit words."""
    def to_host(group, u32_words):
        if group[0].dtype != torch.bfloat16:
            return real(group, u32_words)
        t = (group[0].detach().to("cpu", copy=True) if len(group) == 1
             else torch.stack([x.detach() for x in group]).cpu())
        return t.view(torch.int16).numpy().view(np.uint16)
    return to_host


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None)
    ap.add_argument("--dir", default=None)
    args = ap.parse_args(argv)
    dev = torch.device(args.device or "cuda")
    cfg, built, _, _ = train.build(ARCH, smoke=args.smoke, seq=2048,
                                   batch=4, microbatches=1, lr=1e-3,
                                   total_steps=100, device=dev)
    cfg = dataclasses.replace(cfg, n_layers=LAYERS, dtype="bfloat16")
    model = LM(cfg, vocab_chunk=built.vocab_chunk, device=dev)
    state = ts_lib.init_state(model, torch.Generator(dev).manual_seed(0))
    leaves = [t for g in ts_lib.state_leaves(state) for t in g]
    n_bf16 = sum(t.numel() for t in leaves if t.dtype == torch.bfloat16)
    state_bytes = sum(t.numel() * t.element_size() for t in leaves)
    free = shutil.disk_usage(args.dir or tempfile.gettempdir()).free
    print(f"[ckpt-cost] {cfg.name} at {cfg.n_layers} layers: {n_bf16} bf16 "
          f"elements, {state_bytes} bytes of state; {free} bytes free "
          f"on disk", flush=True)
    real = ck_lib._to_host
    turns = []
    for fmt in ("words", "f32", "f32", "words"):
        ck_lib._to_host = _words(real) if fmt == "words" else real
        tmp = tempfile.mkdtemp(prefix="ckcost_", dir=args.dir)
        try:
            ck = ck_lib.Checkpointer(tmp, keep=1)
            t0 = time.perf_counter()
            ck.save(1, state)
            t1 = time.perf_counter()
            ck.wait()
            t2 = time.perf_counter()
            path = os.path.join(tmp, "step_00000001", "arrays.npz")
            row = {"format": fmt, "host_s": t1 - t0, "write_s": t2 - t1,
                   "total_s": t2 - t0, "file_bytes": os.path.getsize(path)}
            if fmt == "f32" and not any(r["format"] == "f32" for r in turns):
                before = [t.detach().to("cpu", copy=True) for t in leaves]
                for t in leaves:
                    t.data.zero_()
                ck.restore(state)
                row["restored_bit_for_bit"] = all(
                    torch.equal(t.detach().cpu(), b)
                    for t, b in zip(leaves, before))
                del before
            ck.close()
        finally:
            ck_lib._to_host = real
            shutil.rmtree(tmp, ignore_errors=True)
        turns.append(row)
        print(f"[ckpt-cost] {fmt}: {json.dumps(row)}", flush=True)
    mean = lambda f, k: sum(r[k] for r in turns if r["format"] == f) / 2
    out = {"card": _card(), "config": cfg.name, "layers": cfg.n_layers,
           "bf16_elements": n_bf16, "state_bytes": state_bytes,
           "disk_free_bytes": free, "turns": turns,
           "mean_total_s": {f: mean(f, "total_s") for f in ("words", "f32")},
           "file_bytes": {f: next(r["file_bytes"] for r in turns
                                  if r["format"] == f)
                          for f in ("words", "f32")}}
    print(json.dumps({"checkpoint_cost": out}))
    ok = all(r.get("restored_bit_for_bit", True) for r in turns)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
