#!/usr/bin/env python3
"""Time the peer ladder, FASTFABRIC and the serial validation steps of
several checkouts in turns, on one card:

    python3 tools/ladder_turns.py --trees A B B A [--out FILE]
    python3 tools/ladder_turns.py --trees A B B A --kernels [--out FILE]
    python3 tools/ladder_turns.py --trees A B B A --fastfabric [--out FILE]

Each tree is the root of a checkout whose ``src/`` holds ``repro_torch``
(e.g. this one and a ``git archive`` of its parent, unpacked into a
directory that ``.gitignore`` lists). For each tree, in the order given, a
child process with that tree's ``src/`` first on its path builds the
kernels and measures on the card:

* FASTFABRIC at PAPER_DIMS, blocks of 100, a 2^20 x 8 world state,
  proposals from 2^22 accounts: one warm-up round, then a timed round of
  1,000 disjoint transfers (``chip_smoke.py``'s phase 4);
* each ladder configuration (Fabric 1.2, P-I, P-I+II behind the Fabric
  1.2 orderer), same sizes: a one-block warm-up and a timed round of 500
  disjoint transfers (``chip_smoke.py``'s phase 7 without the conflicting
  round);
* the serial endorsement check of one 100-tx PAPER_DIMS block
  (``committer._verify_endorsements(txb, False, 0)``): host time a call
  over 20 calls ending in a synchronize, and from the profiler the device
  time and device ops of one call;
* K4 on a 100-tx block with conflicts: the profiler's device time of
  ``mvcc_kernel`` over 50 calls.

With ``--fastfabric``, only the FASTFABRIC rounds (a minute a tree, where
the ladder's serial log chain takes minutes). With ``--kernels``, only the
hash-table kernels instead, on a 2^20 x 8
table holding ~2M keys (some buckets full, PAPER_DIMS values): the probe
(K2) at 200 and 8,192 queries and the sequential commit (K3) at 200, 2,048
and 4,096 writes and on a hot bucket (64 writes of 6 keys into a bucket
with 3 free slots), each as the wrapper's time a call (CUDA events over
200 calls) and its kernels' device time a call (the profiler over 50).

Prints the card's name and power limit, then one JSON line per tree, and
writes them all to ``--out``. Compare trees only within one run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROUND_TXS, LADDER_TXS, N_ACCOUNTS = 1000, 500, 1 << 22


def measure_kernels(tree: Path) -> dict:
    """The hash-table kernels' times (``--kernels``) with ``tree``'s port;
    runs in a child. Every tree gets the same inputs, made here."""
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import u32
    from repro_torch.kernels import build
    from repro_torch.kernels.hash_table import ops as ht_ops

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.libraries()
    out = {"tree": str(tree), "build_s": time.perf_counter() - t0}
    nb, slots, vw = 1 << 20, 8, 4
    rng = np.random.default_rng(0)
    kk = rng.integers(1, 1 << 32, (2 * nb, 2), dtype=np.uint32)
    bkt = (kk[:, 0] & (nb - 1)).astype(np.int64)
    order = np.argsort(bkt, kind="stable")
    rank = np.arange(len(kk)) - np.searchsorted(bkt[order], bkt[order])
    keep = order[rank < slots]
    keys = np.zeros((nb, slots, 2), np.uint32)
    keys[bkt[keep], rank[rank < slots]] = kk[keep]
    occ = np.argwhere(keys[..., 0] != 0)
    table = [u32.from_numpy(a, dev) for a in (
        keys, rng.integers(1, 1 << 32, (nb, slots), dtype=np.uint32),
        rng.integers(0, 1 << 32, (nb, slots, vw), dtype=np.uint32))]

    def queries(q):
        qs = keys[tuple(occ[rng.integers(0, len(occ), q)].T)]
        qs[q // 2:] = rng.integers(1, 1 << 32, (q - q // 2, 2),
                                   dtype=np.uint32)
        return u32.from_numpy(qs, dev)

    def writes(k, hot=False):
        wk = rng.integers(1, 1 << 32, (k, 2), dtype=np.uint32)
        wk[:k // 2] = keys[tuple(occ[rng.integers(0, len(occ), k // 2)].T)]
        if hot:
            free3 = np.argwhere((keys[..., 0] == 0).sum(axis=1) == 3)[0, 0]
            pool = rng.integers(1, 1 << 32, (6, 2), dtype=np.uint32)
            pool[:, 0] = (pool[:, 0] & ~np.uint32(nb - 1)) | np.uint32(free3)
            wk = pool[rng.integers(0, 6, k)]
        return (u32.from_numpy(wk, dev),
                u32.from_numpy(rng.integers(0, 1 << 32, (k, vw),
                                            dtype=np.uint32), dev),
                torch.from_numpy(rng.random(k) >= 0.05).to(dev))

    def timed(fn, name):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(200):
            fn()
        end.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and name in ev.key]
        return {"ms": start.elapsed_time(end) / 200,
                "device_ms": sum(ev.self_device_time_total
                                 for ev in evs) / 50 / 1e3,
                "kernels": sorted({ev.key for ev in evs})}

    for q in (200, 8192):
        qs = queries(q)
        out[f"lookup_q{q}"] = timed(lambda: ht_ops.lookup(*table, qs),
                                    "lookup_kernel")
    work = [t.clone() for t in table]
    for what, ins in (("commit_k200", writes(200)),
                      ("commit_k2048", writes(2048)),
                      ("commit_k4096", writes(4096)),
                      ("commit_hot_bucket", writes(64, hot=True))):
        out[what] = timed(lambda: ht_ops.commit(*work, *ins), "commit_")
    return out


def measure(tree: Path, fastfabric_only: bool = False) -> dict:
    """Every measurement above (``fastfabric_only``: the FASTFABRIC rounds
    alone), with ``tree``'s port; runs in a child."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import committer, crypto, engine, types
    from repro_torch.kernels import build
    from repro_torch.kernels.mvcc_validate import ops as mv_ops
    from repro_torch.kernels.sig_mac import ops as mac_ops

    def sync():
        torch.cuda.synchronize()

    def device_events(fn, iters=1):
        fn()
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            sync()
        return [ev for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA]

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.libraries()
    out = {"tree": str(tree), "build_s": time.perf_counter() - t0}
    dims, nb = types.PAPER_DIMS, 1 << 20

    # FASTFABRIC, then the ladder.
    def rounds(cfg, sizes):
        e = engine.FabricEngine(cfg)
        mac0, mv0 = mac_ops.launches, mv_ops.launches
        st = [e.run_round(e.make_proposals(n, seed=i, n_accounts=N_ACCOUNTS))
              for i, n in enumerate(sizes)]
        ok = e.verify()
        e.store.close()
        timed = st[-1]
        return {"tps": timed.tps, "peer_tps": timed.n_txs / timed.commit_s,
                "order_s": timed.order_s, "commit_s": timed.commit_s,
                "replay_s": timed.replay_s, "verify": all(ok.values()),
                "k1_launches": mac_ops.launches - mac0,
                "k4_launches": mv_ops.launches - mv0}

    cfg = engine.EngineConfig(dims=dims, n_buckets=nb, slots=8)
    out["fastfabric"] = rounds(cfg, (ROUND_TXS, ROUND_TXS))
    if fastfabric_only:
        return out
    for name, peer in (("fabric-1.2", committer.FABRIC_V12_PEER),
                       ("P-I", committer.OPT_P1),
                       ("P-I+II", committer.OPT_P2)):
        torch.cuda.empty_cache()
        lcfg = dataclasses.replace(engine.FABRIC_V12, dims=dims, peer=peer,
                                   n_buckets=nb, slots=8)
        out[name] = rounds(lcfg, (lcfg.orderer.block_size, LADDER_TXS))

    # The serial endorsement check of one block.
    tb = types.make_transfer_batch(dims, 100, seed=1, device=dev)
    tb = tb._replace(endorse_tags=crypto.endorse_batch(tb))

    def serial():
        return committer._verify_endorsements(tb, False, 0)

    if not bool(serial().all()):
        raise AssertionError("serial endorsement check failed")
    sync()
    t0 = time.perf_counter()
    for _ in range(20):
        serial()
    sync()
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    evs = device_events(serial)
    out["serial_check"] = {
        "host_ms": host_ms,
        "device_ms": sum(ev.self_device_time_total for ev in evs) / 1e3,
        "device_ops": sum(ev.count for ev in evs),
        "mac_kernel_ms": sum(ev.self_device_time_total for ev in evs
                             if "mac_kernel" in ev.key) / 1e3}

    # K4 on a block of 100 with conflicts.
    blk = types.make_transfer_batch(dims, 100, seed=3, n_accounts=64,
                                    conflict_rate=0.5, device=dev)
    ins = [t.contiguous() for t in (blk.read_keys, blk.read_vers,
                                    blk.write_keys, blk.read_vers)]
    ins.append(torch.ones(100, dtype=torch.bool, device=dev))
    evs = [ev for ev in device_events(lambda: mv_ops.validate(*ins), 50)
           if "mvcc_kernel" in ev.key]
    n = sum(ev.count for ev in evs)
    out["k4_device_ms"] = (sum(ev.self_device_time_total for ev in evs)
                           / n / 1e3 if n else None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", type=Path)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--kernels", action="store_true",
                    help="time only the hash-table kernels (K2, K3)")
    ap.add_argument("--fastfabric", action="store_true",
                    help="time only the FASTFABRIC rounds")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if args.one:
        tree = args.one.resolve()
        res = (measure_kernels(tree) if args.kernels
               else measure(tree, args.fastfabric))
        print(json.dumps(res), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    results = []
    for tree in args.trees:
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        res = subprocess.run([sys.executable, __file__, "--one",
                              str(tree.resolve())]
                             + (["--kernels"] if args.kernels else [])
                             + (["--fastfabric"] if args.fastfabric else []),
                             capture_output=True, text=True, env=env)
        if res.returncode:
            sys.stderr.write(res.stdout + res.stderr)
            return res.returncode
        results.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "runs": results},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
