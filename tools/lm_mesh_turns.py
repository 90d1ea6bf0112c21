#!/usr/bin/env python3
"""Serve LLaVA-NeXT-34B at all 60 layers over four cards: the mesh LM
(``repro_torch.models.lm.MeshLM``, the layout of ``launch.sharding``) on
``mesh.from_cards(1, 4)``, weights drawn on ``cuda:0`` from ``--seed`` a
layer at a time and cut over the cards (17.2 GB of bf16 weights a card):

    python3 tools/lm_mesh_turns.py [--out FILE]   # needs four cards

Two turns of a prefill of 8 prompts of 4,096 positions (576 patch
embeddings + 3,520 tokens) into a cache of 4,160 and 32 greedy decode
steps. It prints, with the cards' names and power limits, each turn's
prompt tokens/s, decode p50 / min / max ms, peak memory of each card,
the bytes between cards of the prefill and of a decode step by kind (and
a token's), and K5's launches by card (asserted: one a layer a card), and
writes them as JSON to ``--out``. It raises with fewer than four cards:
nothing falls back to fewer.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BATCH, SEQ, CACHE, NEW = 8, 4096, 4160, 32


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import base as cfg_base
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as mesh_mod

    mesh = mesh_mod.from_cards(1, 4)  # raises with fewer than four cards
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cs.log("cards:", cards.replace("\n", " | "), "| torch",
           torch.__version__, "cuda", torch.version.cuda)
    t0 = time.perf_counter()
    build.libraries()
    cs.log(f"[build] {time.perf_counter() - t0:.2f} s")
    cfg = cfg_base.get(cs.LM_MESH_ARCH)
    path_launches = {}
    t0 = time.perf_counter()
    out = cs.lm_mesh_turns(
        mesh.first, mesh, cfg, seq=SEQ,
        cache_len=CACHE, n_new=NEW, counts=cs.launch_counts,
        zero_counts=cs.zero_launch_counts, path_launches=path_launches,
        seed=args.seed, batch=BATCH, turns=("mesh", "mesh"), tag="60 ")
    out["s"] = time.perf_counter() - t0
    out["cards"] = cards
    for rec in out["turns"]:
        rec["bytes_decode_token"] = {
            k: n / BATCH for k, n in rec["bytes_decode_step"].items()}
    cs.log(json.dumps({"lm_mesh_turns": out}, default=str))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1, default=str))
    cs.log(cards)
    return 0


if __name__ == "__main__":
    sys.exit(main())
