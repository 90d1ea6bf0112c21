#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FastFabric (src/repro_torch) on one card.

    python3 chip_smoke.py [--seed N]   # from the root of a checkout, one card

Phases; any failure raises and exits nonzero, and no result line is printed:

1. Build the five kernels from src/repro_torch/kernels/csrc with nvcc for
   sm_90a (one nvcc process per source, all at once).
2. Hold each kernel against its plain PyTorch version on the card, at the
   paths' shapes and on adversarial inputs (words 0 and 0xFFFFFFFF, empty
   keys, full buckets, duplicate keys, conflicting transactions, inactive
   writes). Tolerance: none for K1-K4, whose outputs are integers and must
   be bit-equal; flash attention (K5) within atol = rtol = 2e-5 in f32
   (TF32 off) and 3e-2 in bf16, the JAX kernel tests' tolerances.
3. Time each kernel with CUDA events over many launches after a warm-up,
   beside its plain version, its bound (the larger of bytes over 3.35 TB/s
   and operations over 67 T/s, or 989 TFLOP/s for K5's bf16 products),
   from the profiler its device time and, for K5, SDPA's time.
4. Run the FASTFABRIC engine on the card at PAPER_DIMS (2.9 KB
   transactions), blocks of 100, a 2^20-bucket x 8-slot world state, and
   proposals from 2^22 accounts: one warm-up round, then a timed round of
   1,000 transactions. Every launch counter is set to 0 just before and read
   just after; every kernel of the path must have run, and verify() must be
   all True.
5. Run the same rounds on the CPU (plain versions) and require the store
   chain, log head, journal head and both state digests to be identical.
6. Profile one more round on the card, of 500 transactions, for the
   device's busy share.
7. The peer ladder: Fabric 1.2 (sorted store, staged serial validation),
   P-I and P-I+II (hash table, sequential commit kernel), each behind the
   Fabric 1.2 orderer, at the same size: a warm-up round of one block, a
   timed round of 500 disjoint transfers and a conflicting round of 500
   transfers among 256 accounts (src != dst), counters set to 0 before each
   configuration and read after it; verify() all True, every kernel of the
   configuration launched, and the same rounds on the CPU identical.
8. Serving at full width: Qwen2-7B (28 layers, bf16, weights drawn on the
   card from --seed), ServeEngine with 4 slots of 2,080 positions, 8
   requests of 64-2,048 random tokens, 16 new tokens each; counters set to
   0 before and read after. Every request done with 16 tokens and ledger
   version 2, every logit finite, K5 launched 28 times a prefill; one
   request re-run by its own prefill + decode_step must give the same first
   token. Then one prefill and one decode step are profiled for the
   device's busy time.
9. Serving, card against CPU: the same architecture cut to 2 layers, f32,
   weights drawn once on the CPU and moved to the card, 2 requests (777
   and 256 tokens, 4 new each): prefill logits within 1e-4, greedy tokens
   and request-ledger words identical.

The lines before the last give each phase's seconds, the card's name and
power limit (as nvidia-smi prints them), the engine, ladder and serving
summaries and the kernels; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
ALU_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores; the
# data sheet gives no integer-ALU rate, and 32-bit integer work runs on the
# same units at no more than this rate
TC_BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
ROUND_TXS = 1000
LADDER_TXS = 500  # the ladder's timed and conflicting rounds
N_ACCOUNTS = 1 << 22
SEEDS = (0, 1)  # warm-up round, then the timed round
PROFILED_TXS = 500  # the profiled round (its trace takes minutes to read)
LADDER_POOL = 256  # accounts of the ladder's conflicting round
SERVE_ARCH = "qwen2-7b"
SERVE_PROMPTS = (2048, 1531, 1024, 777, 2000, 300, 1999, 64)
SERVE_NEW = 16
SERVE_SLOTS, SERVE_MAX_LEN = 4, 2080
CHECK_PROMPTS, CHECK_NEW = (777, 256), 4  # card against CPU, 2 layers
# K5 against its plain version: (B, S, H, Hkv, D), dtype
FLASH_CASES = (((1, 2048, 28, 4, 128), "bfloat16"),
               ((1, 777, 28, 4, 128), "bfloat16"),
               ((2, 300, 32, 32, 96), "float32"),
               ((2, 64, 4, 1, 16), "float32"))
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# Prefill logits, card (K5, cuBLAS) against CPU (plain, MKL), f32 with
# TF32 off: both sides sum the same f32 products in other orders, ~1e-6
# relative through two layers and a 3,584-term head product on logits of
# size ~1; 1e-4 leaves two orders of magnitude.
LOGITS_TOL = 1e-4


def log(*a):
    print(*a, flush=True)


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = ALU_OPS_PER_S
             ) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def event_ms(fn, iters: int, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel_name: str, iters: int = 50) -> float | None:
    """Mean device time of the CUDA kernel ``kernel_name`` over ``iters``
    calls of ``fn``, from the profiler; None when it records no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in _device_events(prof):
        if kernel_name in ev.key:
            total += ev.self_device_time_total
            count += ev.count
    return total / count / 1e3 if count else None


def _device_events(prof):
    """The profiler's device-side events (kernels, copies, memsets); the
    host-side ops that launched them are left out, not counted twice."""
    from torch.autograd import DeviceType
    return [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA]


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over the outputs, as unsigned integers."""
    from repro_torch.core import u32
    err = 0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
        if g.dtype == torch.bool:
            g, w = g.long(), w.long()
        else:
            g, w = u32.to_u64(g), u32.to_u64(w)
        if g.numel():
            err = max(err, int((g - w).abs().max()))
    return err


def conflicting_proposals(n: int, seed: int, device):
    """n transfers among LADDER_POOL accounts with src != dst: in-block
    conflicts and stale reads, but no transaction writes one key twice, so
    the sequential and vectorized commits agree and verify() holds."""
    from repro_torch.core import endorser, u32
    rng = np.random.default_rng(seed)
    src = rng.integers(0, LADDER_POOL, n, dtype=np.uint32)
    dst = ((src + rng.integers(1, LADDER_POOL, n, dtype=np.uint32))
           % LADDER_POOL).astype(np.uint32)
    return endorser.Proposal(*(u32.from_numpy(a, device) for a in (
        src, dst, rng.integers(1, 1000, n, dtype=np.uint32),
        rng.integers(0, 64, n, dtype=np.uint32),
        np.arange(n, dtype=np.uint32) + np.uint32(seed << 16))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the serving phases' weights and prompts")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.nn.functional as F
    from repro_torch.configs import base as cfg_base
    from repro_torch.core import (committer, crypto, engine, ledger, types,
                                  u32, unmarshal)
    from repro_torch.core import world_state as ws
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.hash_table import ops as ht_ops, ref as ht_ref
    from repro_torch.kernels.mvcc_validate import ops as mv_ops
    from repro_torch.kernels.mvcc_validate import ref as mv_ref
    from repro_torch.kernels.sig_mac import ops as mac_ops, ref as mac_ref
    from repro_torch.models.lm import LM, Batch
    from repro_torch.serving.engine import Request, ServeEngine
    from repro_torch.storage import journal

    dev = torch.device("cuda")
    # Every f32 product in full f32, on both sides of every comparison.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log("card:", card, "| torch", torch.__version__, "cuda",
        torch.version.cuda)
    rng = np.random.default_rng(0)
    t_start = time.perf_counter()
    phase_s = {}

    def phase_done(name, t0):
        phase_s[name] = time.perf_counter() - t0
        log(f"[phase] {name}: {phase_s[name]:.1f} s")

    def counts():
        return {"mac_many": mac_ops.launches, "lookup": ht_ops.launches,
                "commit": ht_ops.commit_launches,
                "validate": mv_ops.launches,
                "flash_attention": fa_ops.launches}

    def zero_counts():
        mac_ops.launches = ht_ops.launches = ht_ops.commit_launches = 0
        mv_ops.launches = fa_ops.launches = 0

    dims = types.PAPER_DIMS
    nb, slots = 1 << 20, 8
    T = lambda a: u32.from_numpy(np.asarray(a), dev)

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    build.libraries()
    log(f"[build] {time.perf_counter() - t0:.2f} s in {build.build_dir()}")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if ("Used" in line or "spill" in line
                    or "Compiling entry" in line):
                log(f"[build] {name}: {line.strip()}")
    phase_done("1 build", t0)

    # -- 2. kernels against their plain versions ----------------------------
    t0 = time.perf_counter()
    errs = {"mac_many": 0, "lookup": 0, "commit": 0, "validate": 0,
            "flash_attention": 0.0}

    def check(name, got, want, what):
        e = max_abs_err(got, want)
        errs[name] = max(errs[name], e)
        log(f"[check] {name} {what}: max_abs_err {e}")
        if e:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on {what}")

    # K1: verify (100 x 22 x 3), admission (1000 x 3 x 1), endorse
    # (1000 x 22 x 3), and extreme words and keys.
    block = types.make_transfer_batch(dims, 100, seed=1, device=dev)
    msg_block = types.message_words(block)
    r3, s3 = crypto.endorser_keys(3, dev)
    r1, s1 = crypto.endorser_keys(1, dev)
    p31 = (1 << 31) - 1
    edge = rng.integers(0, 1 << 32, (1000, 22), dtype=np.uint32)
    edge[:300] = 0
    edge[300:600] = 0xFFFFFFFF
    keys_edge = (T(np.array([0, 1, p31 - 1, 12345], np.uint32)),
                 T(np.array([p31 - 1, 0, 1, 777], np.uint32)))
    for what, msg, (r, s) in (
            ("verify 100x22x3", msg_block, (r3, s3)),
            ("admission 1000x3x1",
             T(rng.integers(0, 1 << 32, (1000, 3), dtype=np.uint32)),
             (r1, s1)),
            ("endorse 1000x22x3", T(edge), (r3, s3)),
            ("extreme words and keys 1000x22x4", T(edge), keys_edge)):
        check("mac_many", [mac_ops.mac_many(msg, r, s)],
              [mac_ref.mac_many_ref(msg, r, s)], what)

    # K2: a full-size table: ~2M keys in 2^20 buckets (some buckets full),
    # buckets forced full, a key stored twice; 200 queries as on the path.
    n_keys = 2 * nb
    kk = rng.integers(1, 1 << 32, (n_keys, 2), dtype=np.uint32)
    hot = rng.integers(0, nb, 16)
    kk[:16 * slots, 0] = ((kk[:16 * slots, 0] & ~np.uint32(nb - 1))
                          | np.repeat(hot, slots).astype(np.uint32))
    bkt = (kk[:, 0] & (nb - 1)).astype(np.int64)
    order = np.argsort(bkt, kind="stable")
    sb = bkt[order]
    rank = np.arange(n_keys) - np.searchsorted(sb, sb, side="left")
    keep = order[rank < slots]
    tkeys = np.zeros((nb, slots, 2), np.uint32)
    tkeys[bkt[keep], rank[rank < slots]] = kk[keep]
    occ = tkeys[..., 0] != 0
    tvers = np.zeros((nb, slots), np.uint32)
    tvers[occ] = rng.integers(1, 1 << 32, occ.sum(), dtype=np.uint32)
    tvals = np.zeros((nb, slots, dims.vw), np.uint32)
    tvals[occ] = rng.integers(0, 1 << 32, (occ.sum(), dims.vw),
                              dtype=np.uint32)
    full = np.argwhere(occ.all(axis=1))[:, 0]
    dup_b = np.argwhere(occ[:, 1])[0, 0]
    tkeys[dup_b, 1] = tkeys[dup_b, 0]
    table = ws.HashState(T(tkeys), T(tvers), T(tvals))
    log(f"[check] table: {int(occ.sum())} entries, {len(full)} full buckets")

    def queries(q, seed):
        g = np.random.default_rng(seed)
        occ_idx = np.argwhere(occ)
        hits = tkeys[tuple(occ_idx[g.integers(0, len(occ_idx), q // 2)].T)]
        qs = np.concatenate([hits, g.integers(1, 1 << 32, (q - q // 2, 2),
                                              dtype=np.uint32)])
        qs[0] = (0, hits[1, 1])  # empty key
        qs[1] = tkeys[full[0], -1]  # last slot of a full bucket
        qs[2] = (tkeys[full[0], 0, 0], tkeys[full[0], 0, 1] ^ 1)
        qs[3] = tkeys[dup_b, 0]  # stored twice
        return T(qs)

    q200 = queries(200, 1)
    for what, qs in (("200 queries", q200), ("8192 queries",
                                             queries(8192, 2))):
        check("lookup", ht_ops.lookup(*table, qs),
              ht_ref.lookup_ref(*table, qs), what)

    # K3: on copies of the full-size table, the kernel and the plain version
    # apply the same writes; tables and flag must be bit-equal.
    occ_idx = np.argwhere(occ)
    three_free = np.argwhere((~occ).sum(axis=1) == 3)[:, 0]

    def writes(k, seed, n_upd, p_inactive=0.03, p_empty=0.0):
        g = np.random.default_rng(seed)
        wk = g.integers(1, 1 << 32, (k, 2), dtype=np.uint32)
        pick = occ_idx[g.choice(len(occ_idx), n_upd, replace=False)]
        wk[:n_upd] = tkeys[tuple(pick.T)]
        wk = wk[g.permutation(k)]
        wk[g.random(k) < p_empty, 0] = 0
        wv = g.integers(0, 1 << 32, (k, dims.vw), dtype=np.uint32)
        return wk, wv, g.random(k) >= p_inactive

    def in_bucket(wk, bkts):
        wk[:, 0] = (wk[:, 0] & ~np.uint32(nb - 1)) | bkts.astype(np.uint32)
        return wk

    g = np.random.default_rng(7)
    w_full = writes(64, 8, 16)
    w_full[0][16:] = in_bucket(w_full[0][16:], g.choice(full, 48))
    hot_pool = in_bucket(g.integers(1, 1 << 32, (6, 2), dtype=np.uint32),
                         np.full(6, three_free[0]))
    w_hot = writes(64, 9, 0, p_inactive=0.1)
    w_hot[0][:] = hot_pool[g.integers(0, 6, 64)]
    w_path = writes(200, 10, 100)  # updates and inserts, as on the path
    commit_cases = (
        ("200 writes as on the path", w_path, None),
        ("64 writes into full buckets", w_full, True),
        ("64 writes of 6 keys into one bucket", w_hot, True),
        ("200 writes, inactive and empty keys",
         writes(200, 11, 80, p_inactive=0.3, p_empty=0.2), None),
        ("K = 2048", writes(2048, 12, 1024), None),
    )
    for what, (wk, wv, act), want_ovf in commit_cases:
        ins = (T(wk), T(wv), torch.from_numpy(act).to(dev))
        kern = [t.clone() for t in table]
        plain = [t.clone() for t in table]
        ovf = ht_ops.commit(*kern, *ins)
        check("commit", kern + [ovf],
              plain + [ht_ref.commit_ref(*plain, *ins)], what)
        log(f"[check] commit {what}: overflow {bool(ovf)}")
        if want_ovf is not None and bool(ovf) != want_ovf:
            raise AssertionError(f"commit {what}: overflow {bool(ovf)}")
        del kern, plain

    # K4: a main-path block with conflicts and stale reads, and the extremes
    # (1 and 1024 txs, empty keys, a tx writing one key twice).
    def mvcc_inputs(b, seed, conflict_rate):
        g = np.random.default_rng(seed)
        tb = types.make_transfer_batch(dims, b, seed=seed, n_accounts=64,
                                       conflict_rate=conflict_rate,
                                       device=dev)
        rk, wk = tb.read_keys.clone(), tb.write_keys.clone()
        rk[T(g.random(b) < 0.05), 1] = 0
        wk[T(g.random(b) < 0.05), 0] = 0
        twice = T(g.random(b) < 0.05)  # one key written twice
        wk[twice, 1] = wk[twice, 0]
        rv = T(g.integers(0, 3, (b, dims.rk)).astype(np.uint32))
        cur = torch.where(T(g.random((b, dims.rk)) < 0.9), rv,
                          u32.add(rv, 1))
        ok0 = torch.from_numpy(g.random(b) < 0.95).to(dev)
        return [t.contiguous() for t in (rk, rv, wk, cur)] + [ok0]

    mv_block = mvcc_inputs(100, 3, 0.5)
    for what, ins in (("block of 100", mv_block),
                      ("block of 1", mvcc_inputs(1, 4, 0.0)),
                      ("block of 1024", mvcc_inputs(1024, 5, 0.3))):
        got = mv_ops.validate(*ins)
        check("validate", [got], [mv_ref.validate_ref(*ins)], what)
        log(f"[check] validate {what}: {int(got.sum())} valid")
    try:
        mv_ops.validate(*mvcc_inputs(1025, 6, 0.0))
    except ValueError:
        log("[check] validate refuses a block of 1025")
    else:
        raise AssertionError("validate took a block of 1025 transactions")

    # K5: the serving shapes (a 2,048-token Qwen2-7B prompt, a ragged one),
    # MHA at D = 96 and MQA in f32; SDPA's distance from the plain version
    # for information.
    def qkv(shape, dtype, seed):
        b_, s_, h_, kv_, d_ = shape
        g_ = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn((b_, s_, n, d_), generator=g_, device=dev
                            ).to(getattr(torch, dtype))
                for n in (h_, kv_, kv_)]

    def sdpa(q_, k_, v_):
        return F.scaled_dot_product_attention(
            q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)

    for i, (shape, dtype) in enumerate(FLASH_CASES):
        q_, k_, v_ = qkv(shape, dtype, i)
        got = fa_ops.flash_attention(q_, k_, v_, causal=True).float()
        want = fa_ref.flash_attention_ref(q_, k_, v_, causal=True).float()
        tol = FLASH_TOL[dtype]
        e = float((got - want).abs().max())
        e_lib = float((sdpa(q_, k_, v_).float() - want).abs().max())
        errs["flash_attention"] = max(errs["flash_attention"], e)
        log(f"[check] flash_attention {shape} {dtype}: max_abs_err {e} "
            f"(tolerance {tol}); SDPA's max_abs_err {e_lib}")
        if not torch.allclose(got, want, atol=tol, rtol=tol):
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version at {shape} {dtype}")
        del q_, k_, v_, got, want
    torch.cuda.synchronize()
    phase_done("2 kernels vs plain", t0)

    # -- 3. timing at the main path's shapes -------------------------------
    t0 = time.perf_counter()
    ne, w = r3.shape[0], msg_block.shape[1]
    q = q200.shape[0]
    qn = q200[:, 0] != 0
    found = ht_ops.lookup(*table, q200)[0]
    b, nr, _ = mv_block[0].shape
    nw = mv_block[2].shape[1]
    valid = mv_ops.validate(*mv_block)
    valid_before = torch.cumsum(valid.long(), 0) - valid.long()
    wk_path, wv_path, act_path = w_path
    ins_path = (T(wk_path), T(wv_path), torch.from_numpy(act_path).to(dev))
    applied = act_path & (wk_path[:, 0] != 0)
    n_applied = int(applied.sum())
    chain = int(np.bincount(wk_path[applied, 0] & (nb - 1)).max())
    t_commit = [t.clone() for t in table]  # written by every timed call
    timing = {
        "mac_many": dict(
            name="sig_mac.mac_many", kernel="mac_kernel",
            source="src/repro_torch/kernels/csrc/sig_mac.cu",
            replaces="src/repro/kernels/sig_mac/kernel.py:79",
            fn=lambda: mac_ops.mac_many(msg_block, r3, s3),
            plain=lambda: mac_ref.mac_many_ref(msg_block, r3, s3),
            bound=bound_ms(4 * (msg_block.numel() + 2 * ne + 100 * ne),
                           2 * 100 * ne * w),
            shape="verify: 100 tx x 22 words x 3 keys"),
        "lookup": dict(
            name="hash_table.lookup", kernel="lookup_kernel",
            source="src/repro_torch/kernels/csrc/hash_table.cu",
            replaces="src/repro/kernels/hash_table/kernel.py:90",
            fn=lambda: ht_ops.lookup(*table, q200),
            plain=lambda: ht_ref.lookup_ref(*table, q200),
            bound=bound_ms(
                8 * q + 8 * slots * int(qn.sum())
                + 4 * (1 + dims.vw) * int(found.sum())
                + q * (1 + 4 + 4 * dims.vw + 4),
                2 * slots * int(qn.sum())),
            shape="200 queries on a 2^20 x 8 table"),
        "commit": dict(
            name="hash_table.commit", kernel="commit_kernel",
            source="src/repro_torch/kernels/csrc/hash_table.cu",
            replaces="src/repro/kernels/hash_table/kernel.py:167",
            fn=lambda: ht_ops.commit(*t_commit, *ins_path),
            plain=lambda: ht_ref.commit_ref(*t_commit, *ins_path),
            bound=bound_ms(
                wk_path.size * 4 + wv_path.size * 4 + act_path.size + 4
                + n_applied * (8 * slots + 8 + 4 + 4 * dims.vw),
                2 * slots * n_applied),
            shape="200 writes into a 2^20 x 8 table"),
        "validate": dict(
            name="mvcc_validate.validate", kernel="mvcc_kernel",
            source="src/repro_torch/kernels/csrc/mvcc_validate.cu",
            replaces="src/repro/kernels/mvcc_validate/kernel.py:71",
            fn=lambda: mv_ops.validate(*mv_block),
            plain=lambda: mv_ref.validate_ref(*mv_block),
            bound=bound_ms(4 * b * (2 * nr + 2 * nr + 2 * nw) + 2 * b,
                           2 * nw * (nr + nw) * int(valid_before.sum())),
            shape="block of 100, RK = WK = 2"),
    }
    # K5 at one Qwen2-7B layer's prefill of a 2,048-token prompt: Q, K, V
    # read and O written once; 4 operations (QK^T and PV multiply-adds) for
    # each of the S(S+1)/2 causal (query, key) pairs of each head and dim.
    (fb, fs, fh, fkv, fd), _ = FLASH_CASES[0]
    fq, fk, fv = qkv(FLASH_CASES[0][0], "bfloat16", 100)
    fq_t, fk_t, fv_t = (x.transpose(1, 2).contiguous() for x in (fq, fk, fv))
    timing["flash_attention"] = dict(
        name="flash_attention", kernel="flash_fwd_bf16_kernel",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:94",
        fn=lambda: fa_ops.flash_attention(fq, fk, fv, causal=True),
        plain=lambda: fa_ref.flash_attention_ref(fq, fk, fv, causal=True),
        library=lambda: F.scaled_dot_product_attention(
            fq_t, fk_t, fv_t, is_causal=True, enable_gqa=True),
        bound=bound_ms(2 * fb * fs * (2 * fh + 2 * fkv) * fd,
                       4 * fb * fs * (fs + 1) // 2 * fh * fd,
                       TC_BF16_OPS_PER_S),
        shape=f"(B, S, H, Hkv, D) = {FLASH_CASES[0][0]} bf16, causal")
    for key, t in timing.items():
        t["ms"] = event_ms(t["fn"], 500)
        t["plain_ms"] = (event_ms(t["plain"], 5, warmup=1) if key == "commit"
                         else event_ms(t["plain"], 20, warmup=3))
        t["library_ms"] = (event_ms(t["library"], 500) if "library" in t
                           else None)
        t["device_ms"] = device_ms(t["fn"], t["kernel"])
        log(f"[time] {t['name']} ({t['shape']}): {t['ms']:.5f} ms per call, "
            f"device {t['device_ms']} ms, plain {t['plain_ms']:.4f} ms, "
            f"library {t['library_ms']} ms, "
            f"bound {t['bound'][0]:.7f} ms ({t['bound'][1]})")
    fa_t = timing["flash_attention"]
    log(f"[time] flash_attention: {fa_t['bound'][0] / fa_t['ms'] * 100:.2f} "
        f"% of its bound; {fa_t['ms'] / fa_t['library_ms']:.2f}x SDPA's time")
    del fq, fk, fv, fq_t, fk_t, fv_t
    # K4's scan is b dependent barrier steps, which no byte or operation
    # count sees: report the device time per step beside its byte bound.
    mv_dev = timing["validate"]["device_ms"]
    log(f"[time] mvcc_validate.validate: {b} dependent scan steps, "
        f"{mv_dev / b * 1e3 if mv_dev else None} us of device time each")
    # K3's same-bucket writes are a dependent chain on one thread.
    log(f"[time] hash_table.commit: {n_applied} applied writes, longest "
        f"same-bucket chain {chain}; bound "
        f"{timing['commit']['bound'][0]:.7f} ms")
    del t_commit
    # hash_words is plain PyTorch, one small launch per word: time one
    # block's digests as the commit path computes them.
    wire_b = unmarshal.marshal(block, dims)
    valid_b = torch.ones(100, dtype=torch.bool, device=dev)
    head = torch.zeros(2, dtype=u32.WORD, device=dev)
    bno = torch.zeros((), dtype=u32.WORD, device=dev)

    def digests():
        unmarshal.payload_checksum(unmarshal.wire_words(wire_b))
        d = ledger.block_body_digest(wire_b, valid_b)
        ledger.append_hash(head, bno, d)
        journal.update_head(head, bno, journal.write_set_digest(
            block.write_keys, block.write_vals, valid_b))

    digest_block_ms = event_ms(digests, 3, warmup=1)
    log(f"[time] one block's checksum + body/journal digests "
        f"(plain hash_words): {digest_block_ms:.2f} ms")
    phase_done("3 kernel timing", t0)

    # -- 4. the engine on the card ------------------------------------------
    t0 = time.perf_counter()
    cfg = engine.EngineConfig(dims=dims, n_buckets=nb, slots=slots)
    zero_counts()
    eng = engine.FabricEngine(cfg)
    stats = [eng.run_round(eng.make_proposals(ROUND_TXS, seed=s,
                                              n_accounts=N_ACCOUNTS))
             for s in SEEDS]
    t0 = time.perf_counter()
    verdict = eng.verify()
    verify_s = time.perf_counter() - t0
    launches = counts()
    path_launches = {"fastfabric": launches}
    for s, st in zip(SEEDS, stats):
        log(f"[engine] round seed {s}: {st.n_txs} txs, {st.n_valid} valid, "
            f"{st.tps:.1f} tx/s, wall {st.wall_s:.4f} s = order "
            f"{st.order_s:.4f} + commit {st.commit_s:.4f}; replay "
            f"{st.replay_s:.4f} s")
    timed = stats[1:]
    wall = sum(st.wall_s for st in timed)
    summary = {
        "tps": sum(st.n_txs for st in timed) / wall,
        "wall_s": wall,
        "order_s": sum(st.order_s for st in timed),
        "commit_s": sum(st.commit_s for st in timed),
        "replay_s": sum(st.replay_s for st in timed),
        "digest_s_est": digest_block_ms / 1e3 * sum(st.n_blocks
                                                     for st in timed),
        "verify_s": verify_s,
        "launches": launches,
        "verify": verdict,
    }
    log(f"[engine] verify {verdict} in {verify_s:.2f} s; launches {launches}")
    if not all(verdict.values()):
        raise AssertionError(f"verify() failed on the card: {verdict}")
    if not all(launches[k] for k in ("mac_many", "lookup", "validate")):
        raise AssertionError(f"a kernel never ran on the main path: "
                             f"{launches}")
    if any(st.n_valid != st.n_txs for st in stats):
        raise AssertionError("a disjoint-transfer round had invalid txs")

    def results(e):
        e.store.drain()
        ps = e.peer_state
        peer = ([u32.to_numpy(ws.state_digest(ps.hash_state))]
                if ps.sorted_state is None else
                [u32.to_numpy(t) for t in ps.sorted_state])
        return {
            "chain": [(sb.block_no, sb.prev_hash, sb.block_hash, sb.valid)
                      for sb in e.store.chain],
            "log_head": u32.to_numpy(e.log_head),
            "journal_head": u32.to_numpy(ps.journal_head),
            "peer": peer,
            "replica": u32.to_numpy(ws.state_digest(e.endorser_state)),
        }

    def same_results(a, c, what):
        if len(a["chain"]) != len(c["chain"]):
            raise AssertionError(f"{what}: chains differ in length")
        for x, y in zip(a["chain"], c["chain"]):
            if x[0] != y[0] or not all(np.array_equal(u, v)
                                       for u, v in zip(x[1:], y[1:])):
                raise AssertionError(f"{what}: block {x[0]} differs between "
                                     f"card and CPU")
        for k in ("log_head", "journal_head", "replica"):
            if not np.array_equal(a[k], c[k]):
                raise AssertionError(f"{what}: {k} differs between card and "
                                     f"CPU")
        if len(a["peer"]) != len(c["peer"]) or not all(
                np.array_equal(u, v) for u, v in zip(a["peer"], c["peer"])):
            raise AssertionError(f"{what}: peer state differs between card "
                                 f"and CPU")

    on_card = results(eng)
    eng.store.close()
    del eng
    phase_done("4 engine on the card", t0)

    # -- 5. the same rounds on the CPU, plain versions -----------------------
    t0 = time.perf_counter()
    eng_cpu = engine.FabricEngine(cfg, device="cpu")
    cpu_stats = [eng_cpu.run_round(eng_cpu.make_proposals(
        ROUND_TXS, seed=s, n_accounts=N_ACCOUNTS)) for s in SEEDS]
    cpu_verdict = eng_cpu.verify()
    on_cpu = results(eng_cpu)
    eng_cpu.store.close()
    del eng_cpu
    cpu_s = time.perf_counter() - t0
    same_results(on_card, on_cpu, "fastfabric")
    if cpu_verdict != verdict:
        raise AssertionError(f"CPU verify {cpu_verdict} != {verdict}")
    summary["cpu_tps"] = (sum(st.n_txs for st in cpu_stats[1:])
                          / sum(st.wall_s for st in cpu_stats[1:]))
    log(f"[cpu] {len(on_cpu['chain'])} blocks identical to the card's "
        f"(chain, log head {on_card['log_head']}, journal head "
        f"{on_card['journal_head']}, digests {on_card['peer']}); "
        f"{cpu_s:.1f} s, {summary['cpu_tps']:.1f} tx/s (CPU, plain versions)")
    phase_done("5 same rounds on the CPU", t0)

    # -- 6. one profiled round on the card: device busy share ----------------
    t0 = time.perf_counter()
    from torch.profiler import ProfilerActivity, profile
    eng_p = engine.FabricEngine(cfg)
    eng_p.run_round(eng_p.make_proposals(PROFILED_TXS, seed=0,
                                         n_accounts=N_ACCOUNTS))
    props = eng_p.make_proposals(PROFILED_TXS, seed=1,
                                 n_accounts=N_ACCOUNTS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st = eng_p.run_round(props)
    eng_p.store.close()
    dev_events = _device_events(prof)
    busy_us = sum(ev.self_device_time_total for ev in dev_events)
    n_kernels = sum(ev.count for ev in dev_events)
    round_s = st.wall_s + st.replay_s
    # the same span (order + commit + replay) of the unprofiled timed
    # round, scaled to the profiled round's size
    plain_round_s = (sum(s.wall_s + s.replay_s for s in timed) / len(timed)
                     * PROFILED_TXS / ROUND_TXS)
    summary["profiled_round"] = {
        "wall_s": round_s, "unprofiled_wall_s": plain_round_s,
        "device_busy_s": busy_us / 1e6,
        "busy_share": busy_us / 1e6 / round_s if busy_us else None,
        "device_ops": n_kernels}
    log(f"[profile] round under the profiler: {round_s:.3f} s (unprofiled "
        f"{plain_round_s:.3f} s), device busy {busy_us / 1e6:.4f} s over "
        f"{n_kernels} device ops")
    top = sorted(dev_events, key=lambda ev: -ev.self_device_time_total)[:8]
    for ev in top:
        log(f"[profile]   {ev.self_device_time_total / 1e3:9.2f} ms "
            f"{ev.count:7d}x {ev.key[:90]}")
    del eng_p
    phase_done("6 profiled round", t0)

    # -- 7. the peer ladder on the card, then on the CPU ---------------------
    ladder = {}
    for name, peer in (("fabric-1.2", committer.FABRIC_V12_PEER),
                       ("P-I", committer.OPT_P1),
                       ("P-I+II", committer.OPT_P2)):
        t0 = time.perf_counter()
        lcfg = dataclasses.replace(engine.FABRIC_V12, dims=dims, peer=peer,
                                   n_buckets=nb, slots=slots)

        def rounds(e):
            bs = lcfg.orderer.block_size
            return [
                e.run_round(e.make_proposals(bs, seed=0,
                                             n_accounts=N_ACCOUNTS)),
                e.run_round(e.make_proposals(LADDER_TXS, seed=1,
                                             n_accounts=N_ACCOUNTS)),
                e.run_round(conflicting_proposals(LADDER_TXS, 3, e.device)),
            ]

        torch.cuda.empty_cache()
        zero_counts()
        e = engine.FabricEngine(lcfg)
        st = rounds(e)
        lverdict = e.verify()
        got = counts()
        path_launches[name] = got
        card_res = results(e)
        e.store.close()
        del e
        card_s = time.perf_counter() - t0
        need = {"mac_many", "lookup", "validate"} | (
            {"commit"} if peer.hash_state else set())
        if not all(got[k] for k in need):
            raise AssertionError(f"{name}: a kernel of the path never ran: "
                                 f"{got}")
        if not all(lverdict.values()):
            raise AssertionError(f"{name}: verify() failed on the card: "
                                 f"{lverdict}")
        if (st[1].n_valid != st[1].n_txs
                or not 0 < st[2].n_valid < LADDER_TXS):
            raise AssertionError(f"{name}: valid counts "
                                 f"{[s.n_valid for s in st]}")
        t1 = time.perf_counter()
        e_cpu = engine.FabricEngine(lcfg, device="cpu")
        cst = rounds(e_cpu)
        if e_cpu.verify() != lverdict:
            raise AssertionError(f"{name}: CPU verify() differs")
        same_results(card_res, results(e_cpu), name)
        e_cpu.store.close()
        del e_cpu
        cpu_s = time.perf_counter() - t1
        if [s.n_valid for s in cst] != [s.n_valid for s in st]:
            raise AssertionError(f"{name}: valid counts differ on the CPU")
        ladder[name] = {
            "timed_tps": st[1].tps, "conflicting_tps": st[2].tps,
            "peer_tps": st[1].n_txs / st[1].commit_s,
            "rounds": [s._asdict() for s in st],
            "cpu_timed_tps": cst[1].tps,
            "launches": got, "verify": lverdict,
            "card_s": card_s, "cpu_s": cpu_s,
        }
        for label, s in zip(("warm-up", "timed", "conflicting"), st):
            log(f"[ladder] {name} {label}: {s.n_txs} txs, {s.n_valid} valid, "
                f"{s.tps:.2f} tx/s, order {s.order_s:.4f} s, commit "
                f"{s.commit_s:.4f} s, replay {s.replay_s:.4f} s")
        log(f"[ladder] {name}: peer {ladder[name]['peer_tps']:.1f} tx/s "
            f"(timed round, commit only); launches {got}; verify all True; "
            f"CPU identical ({cst[1].tps:.2f} tx/s timed, {cpu_s:.1f} s)")
        phase_done(f"7 ladder {name}", t0)

    # -- 8. serving at full width: Qwen2-7B, bf16, on the card -------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    scfg = cfg_base.get(SERVE_ARCH)
    t1 = time.perf_counter()
    model = LM(scfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(args.seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t1
    n_weights = sum(p.numel() for p in model.parameters())
    if n_weights != scfg.n_params():
        raise AssertionError(f"{n_weights} weights, config says "
                             f"{scfg.n_params()}")
    srng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i, prompt=srng.integers(0, scfg.vocab, n
                                                ).astype(np.int32),
                    max_new=SERVE_NEW) for i, n in enumerate(SERVE_PROMPTS)]
    eng = ServeEngine(model, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
    finite = []  # every prefill's and decode step's logits, checked after

    def finite_logits(fn):
        def call(*a):
            logits, cache = fn(*a)
            finite.append(torch.isfinite(logits).all())
            return logits, cache
        return call

    eng.prefill_fn = finite_logits(eng.prefill_fn)
    eng.decode_fn = finite_logits(eng.decode_fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t1 = time.perf_counter()
    eng.submit(reqs)
    prefill_s, decode_ms = 0.0, []
    while True:  # ServeEngine.run, with admission and decode timed apart
        torch.cuda.synchronize()
        ta = time.perf_counter()
        eng.admit()
        torch.cuda.synchronize()
        tb = time.perf_counter()
        n_active = eng.decode()  # ends in a host copy of the tokens
        prefill_s += tb - ta
        if n_active:
            decode_ms.append((time.perf_counter() - tb) * 1e3)
        elif not eng.queue:
            break
    serve_s = time.perf_counter() - t1
    got = counts()
    path_launches["serving"] = got
    peak = torch.cuda.max_memory_allocated()
    if not all(r.done and len(r.out) == SERVE_NEW for r in reqs):
        raise AssertionError(f"serving: outputs "
                             f"{[len(r.out) for r in reqs]}")
    versions = [eng.request_version(r.rid) for r in reqs]
    if versions != [2] * len(reqs):
        raise AssertionError(f"serving: ledger versions {versions}")
    if not bool(torch.stack(finite).all()):
        raise AssertionError("serving: non-finite logits")
    if got["flash_attention"] != len(reqs) * scfg.n_layers or not \
            got["lookup"]:
        raise AssertionError(f"serving: launches {got}")
    # One request again, by its own prefill + decode_step (batch 1).
    r = reqs[3]
    prompt = torch.as_tensor(r.prompt.astype(np.int64), device=dev)[None]
    cache = model.init_cache(1, len(r.prompt) + SERVE_NEW)
    logits, cache = model.prefill(Batch(tokens=prompt), cache)
    alone = [int(torch.argmax(logits[0]))]
    for i in range(SERVE_NEW - 1):
        logits, cache = model.decode_step(
            cache, torch.tensor([alone[-1]], device=dev),
            len(r.prompt) + i)
        alone.append(int(torch.argmax(logits[0])))
    if alone[0] != r.out[0]:
        raise AssertionError(f"serving: request {r.rid}'s first token "
                             f"{r.out[0]}, alone {alone[0]}")
    agree = sum(a == b for a, b in zip(alone, r.out))
    decode_sorted = sorted(decode_ms)
    serving = {
        "arch": SERVE_ARCH, "dtype": scfg.dtype, "n_layers": scfg.n_layers,
        "weights": n_weights, "init_s": init_s,
        "requests": len(reqs), "prompt_tokens": sum(SERVE_PROMPTS),
        "prefill_s": prefill_s,
        "prompt_tokens_per_s": sum(SERVE_PROMPTS) / prefill_s,
        "decode_steps": len(decode_ms),
        "decode_ms_p50": float(np.median(decode_ms)),
        "decode_ms_min": decode_sorted[0], "decode_ms_max": decode_sorted[-1],
        "output_tokens": eng.tokens_out,
        "output_tokens_per_s": eng.tokens_out / (sum(decode_ms) / 1e3),
        "wall_s": serve_s, "peak_mem_bytes": peak, "launches": got,
        "alone_agree": agree,
    }
    log(f"[serve] {SERVE_ARCH} bf16 at full width ({n_weights} weights, "
        f"drawn in {init_s:.2f} s): {len(reqs)} requests, "
        f"{sum(SERVE_PROMPTS)} prompt tokens prefilled in {prefill_s:.4f} s "
        f"({serving['prompt_tokens_per_s']:.1f} tokens/s); {len(decode_ms)} "
        f"decode steps, p50 {serving['decode_ms_p50']:.3f} ms (min "
        f"{decode_sorted[0]:.3f}, max {decode_sorted[-1]:.3f}), "
        f"{eng.tokens_out} tokens, {serving['output_tokens_per_s']:.1f} "
        f"tokens/s; wall {serve_s:.3f} s; peak memory {peak / 2**30:.3f} "
        f"GiB; launches {got}; ledger versions all 2; request {r.rid} alone "
        f"agrees on {agree} of {SERVE_NEW} tokens")
    # Where the time goes: one prefill (the 2,048-token prompt) and one
    # decode step over the 4 slots, each timed alone, then under the
    # profiler for the device's busy time and its largest ops.
    from torch.profiler import ProfilerActivity, profile
    p2048 = torch.as_tensor(reqs[0].prompt.astype(np.int64), device=dev)[None]
    step_args = (torch.zeros(SERVE_SLOTS, dtype=torch.long, device=dev),
                 torch.as_tensor(eng.pos.astype(np.int64), device=dev),
                 torch.ones(SERVE_SLOTS, dtype=torch.bool, device=dev))
    calls = {
        "prefill 2048": lambda: model.prefill(
            Batch(tokens=p2048), model.init_cache(1, p2048.shape[1])),
        "decode step": lambda: eng.decode_fn(eng.cache, *step_args),
    }
    serving["profile"] = {}
    for what, fn in calls.items():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = _device_events(prof)
        busy_s = sum(ev.self_device_time_total for ev in evs) / 1e6
        n_ops = sum(ev.count for ev in evs)
        serving["profile"][what] = {"wall_s": wall, "device_busy_s": busy_s,
                                    "device_ops": n_ops}
        log(f"[serve-profile] {what}: {wall:.4f} s alone; under the "
            f"profiler device busy {busy_s:.4f} s over {n_ops} device ops "
            f"({busy_s / wall * 100:.1f} % of the unprofiled time)")
        for ev in sorted(evs, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"[serve-profile]   {ev.self_device_time_total / 1e3:9.3f} ms "
                f"{ev.count:6d}x {ev.key[:90]}")
    del eng, model, cache, logits, finite, p2048, step_args, calls
    torch.cuda.empty_cache()
    phase_done("8 serving at full width", t0)

    # -- 9. serving, card against CPU: 2 layers, full width, f32 ------------
    t0 = time.perf_counter()
    ccfg = dataclasses.replace(scfg, n_layers=2, dtype="float32")
    model = LM(ccfg, device="cpu").init(
        torch.Generator().manual_seed(args.seed))
    crng = np.random.default_rng(args.seed + 1)
    cspecs = [(i, crng.integers(0, ccfg.vocab, n).astype(np.int32))
              for i, n in enumerate(CHECK_PROMPTS)]

    def serve_check():
        e = ServeEngine(model, slots=len(cspecs),
                        max_len=max(CHECK_PROMPTS) + 2 * CHECK_NEW)
        prefill_logits = []

        def keep(*a):
            logits, cache = model.prefill(*a)
            prefill_logits.append(logits.cpu())
            return logits, cache

        e.prefill_fn = keep
        rs = [Request(rid=i, prompt=p, max_new=CHECK_NEW) for i, p in cspecs]
        e.run(rs)
        return ([r.out for r in rs], torch.cat(prefill_logits),
                [u32.to_numpy(t) for t in e.state])

    t1 = time.perf_counter()
    cpu_res = serve_check()
    cpu_s = time.perf_counter() - t1
    model.to(dev)
    zero_counts()
    t1 = time.perf_counter()
    card_res = serve_check()
    card_s = time.perf_counter() - t1
    got = counts()
    path_launches["serving_vs_cpu"] = got
    lerr = float((card_res[1] - cpu_res[1]).abs().max())
    log(f"[serve-check] {SERVE_ARCH} cut to 2 layers, f32: prefill logits "
        f"max_abs_err {lerr} (tolerance {LOGITS_TOL}); tokens card "
        f"{card_res[0]} CPU {cpu_res[0]}; card {card_s:.2f} s, CPU "
        f"{cpu_s:.2f} s; launches {got}")
    if not torch.allclose(card_res[1], cpu_res[1], atol=LOGITS_TOL,
                          rtol=LOGITS_TOL):
        raise AssertionError("serving: prefill logits differ between card "
                             "and CPU")
    if card_res[0] != cpu_res[0]:
        raise AssertionError("serving: greedy tokens differ between card "
                             "and CPU")
    if not all(np.array_equal(a, c) for a, c in zip(card_res[2],
                                                    cpu_res[2])):
        raise AssertionError("serving: request ledgers differ between card "
                             "and CPU")
    if got["flash_attention"] != len(cspecs) * ccfg.n_layers:
        raise AssertionError(f"serving check: launches {got}")
    serving["vs_cpu"] = {"logits_max_abs_err": lerr, "tokens": card_res[0],
                         "card_s": card_s, "cpu_s": cpu_s, "launches": got}
    del model
    torch.cuda.empty_cache()
    phase_done("9 serving, card against CPU", t0)

    kernels = [{
        "name": t["name"], "route": "cuda", "source": t["source"],
        "replaces": t["replaces"],
        "launches": sum(c[key] for c in path_launches.values()),
        "launches_by_path": {p: c[key] for p, c in path_launches.items()},
        "max_abs_err": errs[key], "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
        "library_ms": t["library_ms"], "device_ms": t["device_ms"],
    } for key, t in timing.items()]
    log(json.dumps({"engine": summary}, default=str))
    log(json.dumps({"ladder": ladder}, default=str))
    log(json.dumps({"serving": serving}, default=str))
    log(json.dumps({"phase_s": phase_s,
                    "total_s": time.perf_counter() - t_start}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
