#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 22 alone: the window engine over a
(data, model) mesh of the cards present, in turns with the one-device
window engine, on the same proposals:

    python3 tools/mesh_turns.py [--out FILE]

With four cards or more the mesh is (2, 2) over ``cuda:0``-``cuda:3``;
with fewer, every position is on ``cuda:0``. The configuration is phase
4's (PAPER_DIMS, blocks of 100, a 2^20 x 8 table a channel, proposals from
2^22 accounts) at two channels over ``data``: the sharded engine at depth
8 in turns (one device, mesh, mesh, one device) and the replicated one,
rounds of 1,000 transactions a channel, each with the same store chain,
heads, digests and overflow bits as the one-device engine; a durable run
with a butterfly doubling and ``recover_shard`` onto rank (0, 1)'s card;
one block of the Fabric 1.2 step. It prints each turn's tx/s, the K1, K2
and K4 launches by card (asserted), the bytes the collectives moved
between ranks and the consensus bytes a block under FASTFABRIC and Fabric
1.2, with the cards' names and power limits, and writes the phase's
summary as JSON to ``--out``. Compare the engines only within one run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("mesh_turns: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import engine, types
    from repro_torch.kernels import build

    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cs.log("cards:", cards.replace("\n", " | "), "| torch",
           torch.__version__, "cuda", torch.version.cuda)
    t0 = time.perf_counter()
    build.libraries()
    cs.log(f"[build] {time.perf_counter() - t0:.2f} s")
    cfg = engine.EngineConfig(dims=types.PAPER_DIMS, n_buckets=1 << 20,
                              slots=8)
    path_launches = {}
    t0 = time.perf_counter()
    out = cs.mesh_phase(cfg, cs.launch_counts, cs.zero_launch_counts,
                        path_launches, cs.card_mesh(), card=cards)
    out["s"] = time.perf_counter() - t0
    out["path_launches"] = path_launches
    cs.log(f"[mesh] phase in {out['s']:.1f} s")
    text = json.dumps({"mesh": out}, default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
