#!/usr/bin/env python3
"""Split the cost of the durability layer (and of observability) in a
FASTFABRIC round, on one card, by timing engines with one more piece of it
on each, in turns:

    python3 tools/durable_turns.py [--turns 2] [--out FILE]

Every engine runs ``chip_smoke.py``'s phase 4 (PAPER_DIMS, blocks of 100,
a 2^20 x 8 world state, proposals from 2^22 accounts: a warm-up round,
then a timed round of 1,000 disjoint transfers) under one of:

* ``off``: phase 4's configuration (no spill, no journal);
* ``spill``: the storage role also spills each block (``block_dir``);
* ``journal``: the storage role journals each block's write sets in
  memory (a snapshot cadence that never fires), no files;
* ``durable``: phase 11's configuration (block spill, journal spill, a
  snapshot every 10 blocks, the chain pruned a snapshot behind);
* ``obs``: phase 4's configuration with observability on (spans on the
  round's syncs, tx lifecycle tracing, the flight recorder's tap), as
  phase 12's obs-on engine.

The configurations run in the order off, spill, journal, durable, obs, then
reversed, ``--turns`` times. For each run it prints the timed round's
tx/s, ``order_s``, ``commit_s`` and ``replay_s``, and the journal's mean
append latency (its ``Registry`` histogram), then the medians per
configuration, with the card's name and power limit. Compare
configurations only within one run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROUND_TXS, N_ACCOUNTS, EVERY = 1000, 1 << 22, 10
CONFIGS = ("off", "spill", "journal", "durable", "obs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("durable_turns: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.core import engine, types
    from repro_torch.obs import Obs, Registry, Tracer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print("card:", card, flush=True)
    base = engine.EngineConfig(dims=types.PAPER_DIMS, n_buckets=1 << 20,
                               slots=8)
    order = (list(CONFIGS) + list(reversed(CONFIGS))) * args.turns
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(order):
            root = os.path.join(tmp, f"{i}")
            cfg = {
                "off": base,
                "spill": dataclasses.replace(
                    base, block_dir=os.path.join(root, "blocks")),
                "journal": dataclasses.replace(
                    base, snapshot_every_blocks=1 << 30),
                "durable": dataclasses.replace(
                    base, snapshot_every_blocks=EVERY,
                    snapshot_dir=os.path.join(root, "snap"),
                    journal_dir=os.path.join(root, "jrnl"),
                    block_dir=os.path.join(root, "blocks")),
                "obs": base,
            }[name]
            reg = Registry()
            handle = (Obs(tracer=Tracer(), registry=reg) if name == "obs"
                      else Obs(registry=reg))
            eng = engine.FabricEngine(dataclasses.replace(cfg, obs=handle))
            stats = [eng.run_round(eng.make_proposals(
                ROUND_TXS, seed=s, n_accounts=N_ACCOUNTS)) for s in (0, 1)]
            eng.store.close()
            if any(st.n_valid != st.n_txs for st in stats):
                raise AssertionError(f"{name}: invalid transactions")
            del eng
            torch.cuda.empty_cache()
            timed = stats[1]
            append = reg.histogram("journal.append.latency")
            run = {"config": name, "tps": timed.tps,
                   "order_s": timed.order_s, "commit_s": timed.commit_s,
                   "replay_s": timed.replay_s,
                   "append_mean_s": (append.sum / append.count
                                     if append.count else None),
                   "appends": append.count}
            runs.append(run)
            print(json.dumps(run), flush=True)
    medians = {
        name: {k: statistics.median(r[k] for r in runs
                                    if r["config"] == name)
               for k in ("tps", "order_s", "commit_s", "replay_s")}
        for name in CONFIGS}
    summary = {"card": card, "medians": medians, "runs": runs}
    print(json.dumps({"medians": medians, "card": card}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
