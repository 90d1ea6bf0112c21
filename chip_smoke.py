#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FastFabric (src/repro_torch) on one card.

    python3 chip_smoke.py [--seed N]   # from the root of a checkout, one card

Phases; any failure raises and exits nonzero, and no result line is printed:

1. Build the five kernels from src/repro_torch/kernels/csrc with nvcc for
   sm_90a (one nvcc process per source, all at once).
2. Hold each kernel against its plain PyTorch version on the card, at the
   paths' shapes and on adversarial inputs (words 0 and 0xFFFFFFFF, empty
   keys, full buckets, duplicate keys, conflicting transactions, inactive
   writes); K1 also at every ordered schedule the paths use (`step` 1 and
   tiles that do not divide the rows); K2 also at other slot counts (S =
   3, a generic instance; S = 40, a row in two segments); K3 also on
   every route and edge of its schedule (33 writes in two parts; 4,096;
   33,000, past the 1,024-part limit; a hot bucket of 3,000 writes that
   one part stages in several passes; S = 16; S = 40, a row walked in
   memory, also as a hot bucket that overflows);
   K4 on both routes (one CTA; a grid of conflict-word tiles and a scan
   CTA; each block on both where it fits one CTA), at the borders of its 32-tx chunks (31-33, 63-65, 1023, 1024
   txs), past 32 chunks (1,025, 2,048, 4,096 txs), at RK = WK = 4,
   RK = WK = 8 (1,024 txs, past one CTA's shared memory) and RK = 3,
   WK = 1, and on hand-made blocks whose verdicts are known
   (kernels/mvcc_validate/cases.py). Tolerance: none for K1-K4, whose
   outputs are integers and must be bit-equal; flash attention (K5) within
   atol = rtol = 2e-5 in f32 (TF32 off), and in bf16 within atol 5e-3 +
   rtol 1e-2 of the plain version on the inputs cast to f32
   (kernels/flash_attention/ref.py), at the serving shapes, at the
   edges of its wgmma kernel's tiles and at the hybrid and encdec
   families' D = 64 shapes: causal MHA of 32 heads, an encoder without
   the causal mask, cross-attention at Skv = S / 4, and Skv below one key
   tile and far above S.
3. Time each kernel with CUDA events over many launches after a warm-up,
   beside its plain version, its bound (the larger of bytes over 3.35 TB/s
   and operations over 67 T/s, or 989 TFLOP/s for K5's bf16 products),
   from the profiler its device time and, for K5, SDPA's time; then K5 and
   SDPA in turns at a 2,048- and a 777-token Qwen2-7B prefill, a
   2,048-token phi3-mini one (D = 96), zamba2's shared block and
   seamless's encoder and cross-attention (D = 64, the last two without
   the causal mask) (TFLOP/s, share of the bound, ratio);
   K1 at step 1, 16 and 100 on the verify block, the serial admission of a
   ladder round and the launch floor (1 x 1 x 1), device time a step; K2
   at 200 and 8,192 queries; K3 at 200, 2,048 and 4,096 writes and on a
   hot bucket (64 writes of 6 keys); K4 at 100, 1,024, 2,048 and 4,096
   txs, device time a chunk, and each of its two routes, forced, at 32 to
   1,235 txs, where the wrapper chooses between them. K5's backward at the
   training shape (4, 2048, 28, 4, 128) bf16 causal: CUDA events and the
   profiler's device time a call (its three kernels, and each apart),
   beside its bound (5 products, 2.5x the forward's operations, at 989
   TFLOP/s), its plain version and SDPA's backward (fwd+bwd - fwd, in
   turns); the same at phi3-mini's (1, 2048, 32, 32, 96) and at phase
   21's D = 64 shapes: zamba2's shared block and seamless's decoder
   self-attention (causal), its encoder and cross-attention (no mask).
4. Run the FASTFABRIC engine on the card at PAPER_DIMS (2.9 KB
   transactions), blocks of 100, a 2^20-bucket x 8-slot world state, and
   proposals from 2^22 accounts: one warm-up round, then a timed round of
   1,000 transactions. Every launch counter is set to 0 just before and read
   just after; every kernel of the path must have run, K1 exactly twice a
   round plus once a block and K4 once a block, and verify() must be all
   True.
5. Run the same rounds on the CPU (plain versions) and require the store
   chain, log head, journal head and both state digests to be identical.
6. Profile one more round on the card, of 300 transactions, for the
   device's busy share.
7. The peer ladder: Fabric 1.2 (sorted store, staged serial validation),
   P-I and P-I+II (hash table, sequential commit kernel), each behind the
   Fabric 1.2 orderer, at the same size: a warm-up round of one block, a
   timed round of 200 disjoint transfers and a conflicting round of 200
   transfers among 256 accounts (src != dst), counters set to 0 before each
   configuration and read after it; verify() all True, every kernel of the
   configuration launched (K1 and K4 as in phase 4: a serial check is one
   launch a block and a serial admission one a round), and the same
   rounds on the CPU identical.
8. Large blocks: P-I+II (`OPT_P2`) behind the O-I + O-II orderer with
   blocks of 2,048 at the same size, one round of 4,096 transfers (K2,
   K3 at 4,096 writes a block, K4 on its tiled route), counters set to 0
   before and read after; verify() all True, and the same round on the
   CPU identical (chain and validity bits, log head, journal head, state
   digest).
9. Serving at full width (``serve_traffic``): Qwen2-7B (28 layers, bf16,
   weights drawn on the card from --seed), ServeEngine with 4 slots of
   2,080 positions, 8 requests of 64-2,048 random tokens, 16 new tokens
   each; counters set to 0 before and read after. Every request done with
   16 tokens and ledger version 2, every logit finite, K5 launched 28
   times a prefill, the weight count; one request re-run by its own
   prefill + decode_step must give the same first token. Then one prefill
   and one decode step are profiled for the device's busy time and K5's
   share of it (``serve_profile``).
10. Serving, card against CPU (``serve_check``): the same architecture cut
   to 2 layers, f32, weights drawn once on the CPU and moved to the card,
   2 requests (777 and 256 tokens, 4 new each): prefill logits within
   1e-4, greedy tokens and request-ledger words identical.
11. Durability on the card: FASTFABRIC as in phase 4 with a snapshot every
   10 blocks and the snapshot, journal and block directories in a
   temporary directory (chain pruned a snapshot behind): rounds of 1,000,
   1,000 (timed) and 500 transfers, 25 blocks, snapshots at blocks 9 and
   19 (224 MiB each), counters set to 0 before and read after (K1 and K4
   as in phase 4). verify() all True with the journal attached; the same
   rounds on the CPU write identical manifests, journal records and
   spilled blocks; a copy with one word flipped in the newest journal
   record, and one with a value flipped in the snapshot shard, are
   refused by restore(); FabricEngine.restore from a copy of the
   directories alone matches the live engine (state digest, journal and
   ledger heads, next block, overflow bits) and verifies, and one more
   round of 500 on both leaves them identical. Timed: the round beside
   phase 4's, snapshot take and save, recover(), full_replay over phase
   4's 20 blocks, restore, the journal's append latency.

12. Observability and elastic state on the card: (a) FASTFABRIC as in
   phase 4 with obs on (and a recorder directory), in turns with obs off
   (off, on, on, off: a warm-up and a timed round each); the checked
   obs-on engine's chain, heads and digests equal phase 4's, its spans
   (round.order, round.commit with a block.ship a block,
   round.endorser_replay) agree with RoundStats within 5 %, its tx phases
   count every transaction and sum to e2e, its valid outcomes equal
   n_valid, health() is healthy; then the policy pass's stacked read and
   one resize of its 2^20 x 8 table to 2^21, timed. (b) ResizePolicy(
   grow_free_slots=2) from a 2,048 x 8 table over four rounds of 1,000
   with a snapshot every 25 blocks and the three directories: at least
   two doublings without overflow, verify() all True, recovery from
   genesis across every re-anchor, restore from a copy of the
   directories onto the grown layout, and the same rounds on the CPU
   identical (epochs, digest, heads, files, journal records). (c) Fault
   edges: a static 8 x 2 table latches overflow (overflow_latch,
   health() critical, health.status 2), the same table under a policy
   capped at 8 buckets refuses once (resize_refused), and a word flipped
   in the newest journal record breaks verify() (verify_contract with
   the journal's reason); each trip dumps the recorder's five files.
   Counters are set to 0 before each engine of (a)-(c) that is checked
   and read after it; K1 and K4 as in phase 4.
13. The block pipeline on the card (``window_phase``): (a) phase 4's
   configuration and rounds through the engine's window committer
   (pipeline/engine_bridge.WindowCommitter at depth 8: a round of 10
   blocks is a window of 8 and a tail of 2); counters set to 0 before and
   read after its rounds and verify(), K1 exactly 2 a round + 1 a window,
   K2 2 a round + 2 a window + 2 a block (the replica's update, verify's
   replay), K4 1 a block, K3 0; verify() all True and the store chain,
   log and journal heads and digests identical to phase 4's per-block
   engine; (b) the same rounds on the CPU identical; (c) an 8 x 2 table at
   depth 4, a round of 200: overflow latched, chain_ok True, card = CPU;
   (d) ResizePolicy(grow_free_slots=2) from 2,048 x 8 over two rounds
   with a journal: at least one epoch, verify() all True, epochs, digest
   and journal heads card = CPU; (e) the per-block and window engines in
   turns (block, window, window, block; a warm-up and a timed round each)
   and one depth-8 window under the profiler for its busy share.
14. Several channels on one card (``channels_phase``), each channel a 2^20
   x 8 table at PAPER_DIMS in blocks of 100: (a) four channels in lockstep
   through a four-channel WindowCommitter at depth 8, a warm-up and a timed
   round of 4 x 1,000 disjoint transfers (the fairness rows' uniform
   load), verify_all() all True; counters set to 0 before and read after,
   K4 exactly once a window position (its four blocks in one launch), K1
   twice a channel round + once a window, K2 as in phase 13 a channel, K3
   0; each channel's chain, heads and digests equal a one-channel window
   engine's on the card fed that channel's proposals; per-channel tx/s
   (the shared wall) beside that engine's and the fairness ratio (min /
   max). (b) The host path under the Zipf (s = 1.2) load, 1,000 / 400 /
   200 / 200 txs (2,000 split by weight, rounded down to the block size),
   K1 and K4 as in phase 4; card = CPU (chains, heads, digests,
   verify_all). (c) Durability: two channels through a two-channel
   committer with a journal, snapshots every 10 blocks and a block spill
   (tables cut to 2^18 x 8), channel 1 doubled after the first round (two
   shape groups: K4 once a position a group), then restore() of both
   channels on the card, verify_all() all True and heads and digests equal
   the live engine's. (d) K4 over NB = 1, 2, 4 and 8 blocks in one call,
   blocks of 100 (one CTA a block, one launch) and of 1,024 (tiled, two
   launches), against its plain version; wrapper and device time beside
   NB x the NB = 1 time. (d) runs in phase 3 (``k4_blocks``), where the
   profiler's device times are read before the profiled rounds.
15. Bucket-sharded world state on one card (``sharding_phase``), phase 4's
   configuration in 4 shards of 2^18 buckets: (a) FASTFABRIC_SHARDED_STEP
   over ten blocks of phase 4's proposals against FASTFABRIC_STEP (every
   state tensor, head, validity bit and overflow lane identical; K2 twice
   a shard a block) and one block of a sequential commit (K3 once a
   shard); (b) a durable WindowCommitter(FASTFABRIC_PIPELINED_STEP,
   n_shards=4) engine over phase 4's rounds, a snapshot every 10 blocks in
   4 parts: the chain it keeps (pruned a snapshot behind), log and journal
   heads and digests equal to phase 13's
   replicated window engine, tree_head equal to the routed digest tree;
   then rounds of 300 around a doubling, verify() all True, K1-K4 as
   counted from the code; (c) the butterfly resize of (a)'s table, 2^20 ->
   2^21 and back, against world_state.resize, timed; (d) an 8 x 2 table (2
   buckets a shard) whose round overflows: the bits name the shards that
   dropped writes, card = CPU; (e) recover_shard of each shard from (b)'s
   directories, across the re-anchor, equal to the live shard, loading the
   parts its range schedule names; (f) card = CPU at 2^14 buckets (the
   depth-1 step over three blocks, the window engine over two rounds of
   300); and the replicated and sharded window engines in turns
   (replicated, sharded, sharded, replicated).
16. LM training on the card (``training_phase``), under torch's
   deterministic algorithms (cuBLAS's workspace fixed at start): (a)
   Qwen2-7B at full width (d 3,584, 28/4 heads, D = 128, d_ff 18,944,
   vocab 152,064, untied head), bf16, cut to 4 layers (2.02 B parameters;
   params, gradients and f32 moments take ~24 GB, all 28 layers ~91 GB),
   random weights from --seed, batches of 4 x 2,048 tokens from the port's
   pipeline, TrainConfig and AdamWConfig from launch/train.build: a
   warm-up step, 6 timed steps (host clock + sync) and a profiled one
   (``_train_full_width``, as phase 21's); every loss finite, every
   microbatch endorsed, none skipped; counters set to 0 before the timed
   steps and read after, K5's forward and backward each exactly 4 a step;
   a second run of 2 steps from the same seed equal bit for bit (params,
   moments, ledger head) to the first run after 2; tokens/s, median step
   ms, peak device memory, each step's device allocations, allocator
   retries and garbage-collector pauses, the profiled step's busy share
   and K5's part of it. (b) The same width at 1 layer, f32 (TF32 off), batch 1 x 256:
   one step's loss, gradient norm and every gradient, card against CPU
   (GRAD_TOL of each leaf's largest magnitude). (c) The qwen2-7b smoke
   config in f32 and in bf16 (K5's CUDA-core and mma.sync instances): 6
   steps straight against 3 + a Checkpointer save + restore into a fresh
   state + 3, bit for bit, verify_chain() True. (d) K5's backward (its
   dQ, dK, dV from the kernel's own O and LSE) against its plain version
   on the inputs cast to f32 at FLASH_BWD_CASES (the training shape, 777
   tokens, MHA at D = 96 in f32 and bf16 and at 2,048 tokens, MQA at D =
   16 in f32, one row past a 128- and a 64-row tile, D = 64 in GQA of 8,
   Skv < S off the tiles, no causal mask; and phase 21's D = 64 shapes:
   seamless's encoder and cross-attention without the mask at Skv = S and
   S / 4, its decoder self-attention and zamba2's shared block, Skv below
   one key tile without the mask in bf16 and in f32; Qwen1.5-MoE's 16 MHA
   heads at D = 128 and 4 x 2,048 tokens), the forward's LSE
   against the plain one, and O with the LSE written equal bit for bit to
   O without it.
17. MoE serving at full width (``moe_serving_phase``): Qwen1.5-MoE-A2.7B
   (24 layers, d 2,048, 16 heads of 128, 60 routed experts top-4 of width
   1,408 plus 4 shared; 14.3 B weights), bf16 with the router f32, random
   weights from --seed, at the JAX serving launcher's capacity factor 2.0,
   behind ServeEngine with phase 9's traffic and checks (8 prompts, 16 new
   tokens each, 4 slots of 2,080): every request done, ledger versions 2,
   logits finite, K5 exactly 8 x 24 times and K2 launched, the weight
   count; prompt and output tokens/s, decode p50/min/max, peak memory.
   Untimed after it: a replay of the same requests, which must give the
   same tokens, counts the share of routed assignments dropped in prefill
   and in decode, in all and by layer; the 2,048-token prefill repeated bit for bit; the
   device's busy share and top ops of one prefill and one decode step.
   (b) The same width cut to 2 layers, f32 (TF32 off), phase 10's
   ``serve_check``, CHECK_PROMPTS card against CPU: prefill logits
   within LOGITS_TOL, greedy tokens and ledgers identical, each moe
   layer's routes compared (a difference where the CPU's k-th and (k+1)-th
   probabilities lie within ROUTE_TIE is an f32 tie, printed, and its
   request is compared no further; any other fails).
18. Mamba2-2.7B at full width (``ssm_phase``): 64 layers, d 2,560, 80 SSD
   heads of 64, state 128 (2.8 B weights), bf16, random weights from
   --seed: an untimed warm-up prefill, a timed prefill of 4 x 2,048
   tokens, then 16 greedy decode steps (``_family_full_width``, as phases
   19-20); logits finite, no kernel launched, the weight count, layer 0's
   chunked
   scan against the sequential reference on the card (SSD_TOL); prompt
   tokens/s, decode p50/min/max, peak memory, busy share and top ops of a
   prefill and a decode step. (b) 2 layers, f32, prompts of 768 and 256
   tokens + 4 greedy steps card against CPU: logits, tokens, conv tails
   and SSM states.
19. Zamba2-1.2B at full width (``hybrid_phase``): 38 Mamba2 layers, d
   2,048, 64 SSD heads of 64, state 64, and ONE shared attention + MLP
   block (32 heads of 64, d_ff 8,192) before each group of 6 layers, 7
   sites (1.17 B weights), bf16, random weights from --seed: a prefill of
   4 x 2,048 tokens into a cache of 2,064 positions, then 16 greedy decode
   steps; logits finite, K5 exactly 7 times (once a site) and no other
   kernel, the weight count; prompt tokens/s, decode p50/min/max, peak
   memory, busy share and top ops of a prefill and a decode step. (b) 8
   layers (2 sites, the last group of 2), f32, prompts of 768 and 256
   tokens + 4 greedy steps card against CPU: logits, tokens, the sites'
   K/V, conv tails and SSM states.
20. SeamlessM4T-medium at full width (``encdec_phase``): 12 encoder and 12
   decoder layers, d 1,024, 16 heads of 64, d_ff 4,096, vocab 256,206
   (0.98 B weights), bf16, random weights from --seed; the audio frontend
   is the reference's stub, standard-normal frames (4 x 512, a quarter of
   the text length): a prefill of 4 x 2,048 decoder tokens, then 16 greedy
   decode steps; logits finite, K5 exactly 36 times (12 encoder layers
   without the causal mask, 12 causal self-attentions, 12
   cross-attentions at Skv = 512 without the mask) and no other kernel,
   the weight count; the same figures as phase 19. (b) 2 + 2 layers, f32,
   decoder prompts of 768 and 256 tokens over 192 and 64 frames (off K5's
   128-key tile) + 4 greedy steps card against CPU: logits, tokens, the
   self-attention K/V and the cross K/V (within ENCDEC_CACHE_TOL of each
   field's largest magnitude).
21. Training the moe, ssm, hybrid and encdec families
   (``family_training_phase``), under torch's deterministic algorithms
   (strict, as launch/train.py runs them). For each of
   Qwen1.5-MoE-A2.7B, Mamba2-2.7B, Zamba2-1.2B and SeamlessM4T-medium:
   (a) full width, bf16, built by launch/train.build (MoE at capacity
   factor 2.0), batches of 4 x 2,048 tokens from the port's pipeline
   (seamless over 4 x 512 frames), depth cut only as far as 80 GB forces
   (FAMILY_TRAIN: MoE 4 of 24 layers, Mamba2 and Zamba2 as listed there,
   Zamba2 with at least 2 shared-block sites, Seamless all 12 + 12), as
   phase 16 (a) runs: MoE's routed and dropped assignments counted by
   layer in an untimed forward of the first batch; a warm-up step,
   FAMILY_TRAIN_STEPS timed steps and a profiled one, each step's device
   allocations, allocator retries and garbage-collector pauses counted;
   a second run of 2 steps from the same seed bit for bit the first
   run's; every step's skipped flag equal to
   "the loss or some gradient non-finite", a skipped step leaving params
   and moments unchanged (their words' sums, and bit for bit against a
   host copy when every step skipped, as the reference's SSD overflow
   makes every Mamba2 and Zamba2 step at these widths); MoE and Seamless:
   every loss finite, every microbatch endorsed; counters set to 0 before
   the timed steps and read after, K5's forward and backward each once an
   attention layer or site a step (MoE 4, Zamba2 its sites, Seamless 2 a
   decoder layer + 1 an encoder layer, Mamba2 0); tokens/s, median step
   ms, peak memory, busy share. (b) Card against CPU, f32, TF32 off, batch
   1: the published width cut to 1 layer (Zamba2 to one group: a site and
   6 Mamba2 layers; Seamless 1 + 1) at FAMILY_CHECK_SEQ, the same
   non-finite leaves and the finite ones within GRAD_TOL; the smoke config
   at FAMILY_SMOKE_SEQ, every leaf finite and within GRAD_TOL. (c) The
   smoke config in bf16: 6 steps straight against 3 + a Checkpointer save
   + restore into a fresh state + 3, bit for bit.
22. Shards and channels over a (data, model) mesh (``mesh_phase``, also
   run alone by tools/mesh_turns.py): a (2, 2) mesh of the cards present
   (``card_mesh``: one card a position with four or more, else all four
   positions on cuda:0, printed as such), phase 4's configuration at two
   channels over ``data``. (a) The window engine at depth 8 over the mesh,
   bucket-sharded (in turns with the one-device engine of the same
   configuration: one, mesh, mesh, one) and replicated (one, mesh), two
   rounds of 1,000 transactions a channel each: store chain, validity
   bits, log, journal and ledger heads, state_digest, tree_head and
   overflow bits of both channels equal the one-device engine's; counters
   set to 0 before the first mesh turn and read after, K1, K2 and K4
   launches by device exactly as ``mesh_window_launches`` reckons them;
   the consensus bytes a block equal their formula (``spw`` words, two id
   words and a flag byte a transaction from each other model rank). (b)
   The mesh engine durable and sharded, a snapshot every 5 blocks: a
   round of 500, one of 200, the butterfly doubling of channel 0 (2^20 ->
   2^21), one of 200; verify_all; the grown table equals the one-device
   butterfly of the same table, and ``recover_shard`` of shard 1 onto rank
   (0, 1)'s device (crossing the re-anchor) equals it onto the first device
   and the live shard. (c) One block a channel of the Fabric 1.2 step on
   the mesh (the whole wire in consensus; K3 on every replica) equals the
   one-device step on the CPU; its launches by device and consensus bytes
   a block against FASTFABRIC's.
23. The program contracts on the card (``contracts_phase``): the contract
   gate's seven programs (repro_torch.analysis: the fabric step replicated
   and sharded at depth 1, sharded at depth 8 and at depth 4 over two
   channels, the stats pass, the butterfly resize 256 -> 512 buckets, the
   qwen2-7b smoke decode step) at the gate's sizing on a (1, 4) mesh of
   the cards present (four positions on cuda:0 with fewer than four), each
   a warm-up call and a call recorded under the dispatch mode and
   ``set_sync_debug_mode("error")``: no host sync, collective calls by
   type within their budgets, one commit pass into every table, the
   tables kept in place, no f64/u64 result and no s64 tensor in or out;
   counters set to 0 before each recorded call and read after, K1, K2 and
   K4 launches by device as ``contract_launches`` reckons them (none in
   the other three programs); a seeded ``.item()`` in a step caught as a
   host sync; the committer's rebuild and signature audit and the
   host-sync lint clean; the phase within CONTRACT_PHASE_S.

The lines before the last give each phase's seconds, the card's name and
power limit (as nvidia-smi prints them), the engine, ladder, serving,
durability, observability, pipeline, channel, sharding, training, MoE
serving, SSM, hybrid, encdec, family-training, mesh and analysis
summaries (with
the storage objects' sizes) and the kernels (K1-K5 and K5's backward); the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
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
# The ladder's timed round and its conflicting round: Fabric 1.2's orderer
# chains every transaction serially (~17 tx/s on the card's host), so these
# sizes set the phase's time on the card and on the CPU.
LADDER_TXS = 200
LADDER_CONFLICT_TXS = 200
N_ACCOUNTS = 1 << 22
SEEDS = (0, 1)  # warm-up round, then the timed round
PROFILED_TXS = 300  # the profiled round (its trace takes minutes to read)
LADDER_POOL = 256  # accounts of the ladder's conflicting round
BIG_BLOCK, BIG_ROUND = 2048, 4096  # the large-block round: two blocks
# The durable rounds (phase 11): 25 blocks of 100, snapshots at blocks 9
# and 19, the newest trailing the journal tip by 5 blocks; then one more
# round on the live and the restored engine.
DURABLE_ROUNDS, DURABLE_EVERY, DURABLE_AFTER = (1000, 1000, 500), 10, 500
# Phase 12: obs-off and obs-on engines in turns; the elastic run's start
# table (2,048 x 8: four rounds of 2,000 fresh keys from 2^22 accounts fill
# a bucket to 6-7 of its 8 slots before each of three doublings, to 16,384
# buckets, and to 5 after the last round) and its snapshot cadence (one
# snapshot, at block 29, trails the tip, so restore() replays a suffix).
OBS_TURNS = ("off", "on", "on", "off")
# Phase 13: the window committer's depth (a round of 1,000 is a window of
# 8 blocks and a tail of 2), the engines' turns and the elastic start.
WINDOW_DEPTH = 8
WINDOW_TURNS = ("block", "window", "window", "block")
WINDOW_ELASTIC_START = 1 << 11
# Phase 14: four channels (the fairness rows' uniform load, then the Zipf
# s = 1.2 split of 2,000 txs rounded down to the block size), the durable
# two-channel run's table (cut to 2^18 x 8: six snapshots of it) and
# K4's block counts and sizes.
CHANNELS = 4
CHANNEL_ZIPF = (1000, 400, 200, 200)
CHANNEL_DURABLE_NB, CHANNEL_DURABLE_EVERY = 1 << 18, 10
K4_NBS, K4_NB_TXS = (1, 2, 4, 8), (100, 1024)
# Phase 15: four bucket shards (2^18 buckets each of phase 4's table); the
# depth-1 step's blocks; the durable window engine's snapshot cadence
# (snapshots at blocks 9 and 19) and the rounds around its doubling (3
# blocks each: the journal suffix recover_shard replays after the snapshot
# at block 19 crosses the re-anchor after block 22); the engines' turns;
# the card-against-CPU table and round.
SHARDS = 4
SHARD_STEP_BLOCKS = 10
SHARD_DURABLE_EVERY, SHARD_AFTER_TXS = 10, 300
SHARD_TURNS = ("replicated", "sharded", "sharded", "replicated")
SHARD_CHECK_NB, SHARD_CHECK_TXS = 1 << 14, 300
ELASTIC_START, ELASTIC_ROUNDS, ELASTIC_EVERY = 1 << 11, 4, 25
# Phase 22: a (data, model) mesh of the cards present (every position on
# cuda:0 when there are fewer cards than positions), two channels over
# ``data``; the engines' turns; the durable run's snapshot cadence and its
# rounds (500, then 200 before and after the doubling: a snapshot at block
# 4, the resize after block 6, recover_shard's suffix crosses it).
MESH_SHAPE = (2, 2)
MESH_CHANNELS = 2
MESH_TURNS = ("one", "mesh", "mesh", "one")
MESH_DURABLE_EVERY, MESH_DURABLE_TXS, MESH_AFTER_TXS = 5, 500, 200
# Phase 23: the program contracts at the gate's sizing (TEST_DIMS, 8 txs a
# model rank a block, 256 x 8 tables) on its (1, 4) mesh of the cards
# present (four positions on cuda:0 with fewer cards).
CONTRACT_PHASE_S = 30.0
DUMP_FILES = {"trace.jsonl", "trace_chrome.json", "metrics.json",
              "lifecycles.json", "meta.json"}
ROUTE_SWEEP = (32, 64, 100, 128, 160, 192, 256, 512, 1024, 1235)  # K4
SERVE_ARCH = "qwen2-7b"
SERVE_PROMPTS = (2048, 1531, 1024, 777, 2000, 300, 1999, 64)
SERVE_NEW = 16
SERVE_SLOTS, SERVE_MAX_LEN = 4, 2080
CHECK_PROMPTS, CHECK_NEW = (777, 256), 4  # card against CPU, 2 layers
# Phase 17: Qwen1.5-MoE-A2.7B served at the JAX serving launcher's capacity
# factor, with phase 9's traffic. Routing is a discrete choice: a route
# that differs card/CPU where the CPU's k-th and (k+1)-th probabilities lie
# closer than ROUTE_TIE (f32 logits of a 2,048-term product differ by
# ~1e-7 of their size across the two sides) is an f32 tie.
MOE_ARCH, MOE_CF = "qwen2-moe-a2.7b", 2.0
ROUTE_TIE = 1e-6
# Phase 18: Mamba2-2.7B, a prefill of 4 x 2,048 tokens and 16 greedy
# decode steps; card against CPU at two prompts (three chunks of 256, one).
# Layer 0's chunked scan against the sequential one: the chunk's cumsum of
# log-decays (up to |dt A| x 256 ~ 1e4 for the fast heads) rounds in f32,
# so the two orders part by ~1e-5 of the largest magnitude (y and final
# state, measured at full width on the CPU); 1e-4 of it leaves a factor 5.
SSM_ARCH = "mamba2-2.7b"
SSM_BATCH, SSM_SEQ, SSM_NEW = 4, 2048, 16
SSM_CHECK_PROMPTS = (768, 256)
SSD_TOL = 1e-4
# Phases 19-20: Zamba2-1.2B (hybrid) and SeamlessM4T-medium (encdec) at full
# width, a prefill of 4 x 2,048 tokens (seamless over 4 x 512 frames, the
# reference's seq // 4 stub) and 16 greedy steps; card against CPU at two
# prompts, zamba2 cut to 8 layers (2 sites, the last group of 2), seamless
# to 2 + 2 with 192 and 64 frames (off K5's 128-key tile). Zamba2's caches
# within LOGITS_TOL, as phase 18 (b)'s. Seamless's k/v and cross_k/v within
# ENCDEC_CACHE_TOL of each field's largest magnitude, as the SSD check
# scales its own: the second decoder layer's K, a 1,024-term product of the
# first layer's output, parts card/CPU by 1.3e-5 on entries near 0 from
# summation order alone (measured on the card), while a kernel fault moves
# entries by a share of their own size.
HYBRID_ARCH, ENCDEC_ARCH = "zamba2-1.2b", "seamless-m4t-medium"
FAMILY_BATCH, FAMILY_SEQ, FAMILY_NEW = 4, 2048, 16
HYBRID_CHECK_LAYERS = 8
ENCDEC_CHECK_LAYERS = 2
FAMILY_CHECK_PROMPTS = (768, 256)
ENCDEC_CHECK_FRAMES = (192, 64)
ENCDEC_CACHE_TOL = 1e-5
# K5 against its plain version: (B, S, Skv, H, Hkv, D), dtype, causal
FLASH_CASES = (((1, 2048, 2048, 28, 4, 128), "bfloat16", True),
               ((1, 777, 777, 28, 4, 128), "bfloat16", True),
               ((2, 300, 300, 32, 32, 96), "float32", True),
               ((2, 64, 64, 4, 1, 16), "float32", True),
               # the wgmma kernel's tile edges: one row past a 128-row
               # tile, two batches with ragged S (TMA zero-fills each
               # batch's tail), D = 96 under the 64-byte swizzle
               ((1, 129, 129, 28, 4, 128), "bfloat16", True),
               ((2, 200, 200, 28, 4, 128), "bfloat16", True),
               ((2, 300, 300, 32, 32, 96), "bfloat16", True),
               # Qwen1.5-MoE's prefill and its training shape: MHA of 16
               # heads at D = 128
               ((1, 2048, 2048, 16, 16, 128), "bfloat16", True),
               ((4, 2048, 2048, 16, 16, 128), "bfloat16", True),
               # D = 64: zamba2's shared block; seamless's decoder
               # self-attention, encoder (no mask) and cross-attention
               # (Skv = S / 4, no mask); Skv below one 128-key tile, and
               # far above S
               ((4, 2048, 2048, 32, 32, 64), "bfloat16", True),
               ((4, 2048, 2048, 16, 16, 64), "bfloat16", True),
               ((4, 512, 512, 16, 16, 64), "bfloat16", False),
               ((4, 2048, 512, 16, 16, 64), "bfloat16", False),
               ((1, 300, 77, 16, 16, 64), "bfloat16", False),
               ((2, 16, 512, 16, 16, 64), "bfloat16", False))
# K5 timed at these (B, S, Skv, H, Hkv, D), causal (bf16), in turns with
# SDPA: Qwen2-7B's prefill of a full and a ragged prompt, phi3-mini's (D =
# 96, MHA), zamba2's shared block, seamless's decoder self-attention,
# encoder and cross-attention
FLASH_TIMED = ((1, 2048, 2048, 28, 4, 128, True),
               (1, 777, 777, 28, 4, 128, True),
               (1, 2048, 2048, 32, 32, 96, True),
               (4, 2048, 2048, 32, 32, 64, True),
               (4, 2048, 2048, 16, 16, 64, True),
               (4, 512, 512, 16, 16, 64, False),
               (4, 2048, 512, 16, 16, 64, False))
# Prefill logits, card (K5, cuBLAS) against CPU (plain, MKL), f32 with
# TF32 off: both sides sum the same f32 products in other orders, ~1e-6
# relative through two layers and a 3,584-term head product on logits of
# size ~1; 1e-4 leaves two orders of magnitude.
LOGITS_TOL = 1e-4
# Phase 16, training. (a) Qwen2-7B at full width cut to 4 layers: params,
# gradients and f32 m and v take 12 B a parameter, so all 28 layers (7.62 B
# parameters) would need ~91 GB, 4 layers (2.02 B) ~24 GB; batches of 4 x
# 2,048 tokens (8,192 a step) from the port's pipeline, a warm-up step,
# then 6 timed steps. (b) card against CPU at 1 layer, f32, batch 1 x 256.
TRAIN_ARCH = "qwen2-7b"
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4, 2048, 4, 6
TRAIN_CHECK_SEQ = 256
# (b)'s limits. Both sides run the same f32 math (TF32 off), summed in
# other orders: cuBLAS against MKL, K5's f32 kernels (tiles, shuffles)
# against the plain attention, rmsnorm's row means over 3,584 and the
# 152,064-way log-sum-exp. Each differs by ~1e-7-1e-6 of its terms, and a
# gradient leaf's largest element is at least as large as its terms: 1e-4
# of the leaf's largest magnitude leaves two orders of magnitude, as
# LOGITS_TOL does, while a kernel fault (a key tile dropped, dS without
# its - delta) moves a leaf by a good share of its largest element. The
# loss and the gradient norm: 1e-5 relative (a 256-term mean of ~12).
GRAD_TOL = 1e-4
TRAIN_LOSS_TOL = 1e-5
# (d) K5's backward against its plain version: (B, S, Skv, H, Hkv, D),
# dtype, causal; the first is the training shape, timed in phase 3. The
# bf16 cases at D >= 64 sit on the edges of the wgmma kernels' tiles (64-row
# q tiles of dK/dV, 128-row ones of dQ, 128-key tiles of both).
FLASH_BWD_CASES = (((4, 2048, 2048, 28, 4, 128), "bfloat16", True),
                   ((1, 777, 777, 28, 4, 128), "bfloat16", True),
                   ((2, 300, 300, 32, 32, 96), "float32", True),
                   ((2, 300, 300, 32, 32, 96), "bfloat16", True),
                   ((2, 64, 64, 4, 1, 16), "float32", True),
                   ((1, 129, 129, 28, 4, 128), "bfloat16", True),
                   ((1, 300, 300, 28, 4, 128), "bfloat16", False),
                   ((1, 65, 65, 28, 4, 128), "bfloat16", True),
                   ((1, 333, 333, 16, 2, 64), "bfloat16", True),
                   ((1, 2048, 2048, 32, 32, 96), "bfloat16", True),
                   ((1, 200, 72, 28, 4, 128), "bfloat16", True),
                   # D = 64, the families' training shapes (phase 21):
                   # seamless's encoder and cross-attention (no mask,
                   # Skv = S / 4) and decoder self-attention, zamba2's
                   # shared block; Skv below one 128-key tile, no mask, in
                   # bf16 and f32
                   ((4, 512, 512, 16, 16, 64), "bfloat16", False),
                   ((4, 2048, 512, 16, 16, 64), "bfloat16", False),
                   ((4, 2048, 2048, 16, 16, 64), "bfloat16", True),
                   ((4, 2048, 2048, 32, 32, 64), "bfloat16", True),
                   ((1, 200, 72, 16, 16, 64), "bfloat16", False),
                   ((2, 300, 77, 16, 16, 64), "float32", False),
                   # Qwen1.5-MoE's training shape: 16 MHA heads at D = 128
                   # (a GQA group of 1 in the wgmma kernels)
                   ((4, 2048, 2048, 16, 16, 128), "bfloat16", True))
# Phase 3 times K5's backward, bf16, in turns with SDPA's at these (B, S,
# Skv, H, Hkv, D, causal): the training shape, phi3-mini's MHA at D = 96,
# and the shapes of phase 21 (Qwen1.5-MoE's MHA at D = 128; at D = 64
# zamba2's shared block, seamless's decoder self-attention, encoder and
# cross-attention).
FLASH_BWD_TIMED = ((4, 2048, 2048, 28, 4, 128, True),
                   (1, 2048, 2048, 32, 32, 96, True),
                   (4, 2048, 2048, 16, 16, 128, True),
                   (4, 2048, 2048, 32, 32, 64, True),
                   (4, 2048, 2048, 16, 16, 64, True),
                   (4, 512, 512, 16, 16, 64, False),
                   (4, 2048, 512, 16, 16, 64, False))

# Phase 21: training the moe, ssm, hybrid and encdec families. (a) Each at
# full width, bf16, through launch/train.build and the port's pipeline, 4 x
# 2,048 tokens a step (seamless over 4 x 512 frames, enc_frac 4), depth cut
# only as far as the card's 80 GB forces: params, gradients and f32 AdamW
# moments take 12 B a parameter, and a Mamba2 layer keeps the SSD's f32
# (b, c, l, m, h) tensors for its backward: measured 4.58 GiB a Mamba2-2.7B
# layer (peak 15.04 GiB at 2 layers, 33.34 at 6) and 3.67 GiB a Zamba2
# layer (25.90 at 6, 47.94 at 12), on one H100 80GB HBM3 at 700 W. So
# Qwen1.5-MoE at 4 layers (2.9 B parameters, 45.4 GiB peak; all 24 would
# need ~172 GB for the state alone), Mamba2 at 14 of 64 layers (~70 GiB;
# 16 ran out of memory), Zamba2 at 18 of 38 (3 shared-block sites, ~70
# GiB), Seamless at all 12 + 12 (28.0 GiB); a warm-up step, then
# FAMILY_TRAIN_STEPS timed steps and a profiled one. (b) Card against CPU,
# f32, TF32 off, batch 1: the published width cut to 1 layer (Zamba2 to 1
# group: 1 site and 6 Mamba2 layers; Seamless to 1 + 1) at
# FAMILY_CHECK_SEQ, and the smoke config at FAMILY_SMOKE_SEQ, within
# GRAD_TOL. (c) The smoke config in bf16, 6 steps straight against 3 +
# save + restore + 3.
FAMILY_TRAIN = (("qwen2-moe-a2.7b", 4, 0), ("mamba2-2.7b", 14, 0),
                ("zamba2-1.2b", 18, 0), ("seamless-m4t-medium", 12, 12))
FAMILY_TRAIN_STEPS = 3
FAMILY_CHECK_SEQ = 256
FAMILY_SMOKE_SEQ = 64


def log(*a):
    print(*a, flush=True)


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = ALU_OPS_PER_S
             ) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_fwd_work(b, s, skv, h, hkv, d, causal) -> tuple[int, int]:
    """K5's forward at q (b, s, h, d), k/v (b, skv, hkv, d), bf16: (bytes,
    operations). Q, K, V read and O written once; 4 operations (QK^T and
    PV multiply-adds) for each (query, key) pair the mask keeps, of each
    head and dim: s(s+1)/2 pairs causal at skv = s, s x skv without the
    mask."""
    if causal and skv != s:
        raise ValueError("causal work is counted at skv = s only")
    pairs = s * (s + 1) // 2 if causal else s * skv
    return 2 * b * d * (2 * s * h + 2 * skv * hkv), 4 * b * pairs * h * d


def flash_bwd_work(b, s, skv, h, hkv, d, causal) -> tuple[int, int]:
    """K5's backward at q (b, s, h, d), k/v (b, skv, hkv, d), bf16: (bytes,
    operations). Five products, 2.5x the forward's operations; Q, O, dO, K,
    V and the LSE read and dQ, dK, dV written once."""
    flop = flash_fwd_work(b, s, skv, h, hkv, d, causal)[1] * 5 // 2
    q_bytes, kv_bytes = 2 * b * s * h * d, 2 * b * skv * hkv * d
    # reads Q, O, dO, K, V and the f32 LSE; writes dQ, dK, dV
    return 4 * q_bytes + 4 * kv_bytes + 4 * b * h * s, flop


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


def device_ms(fn, kernel_name: str, iters: int = 50, tries: int = 3
              ) -> float | None:
    """Mean device time of the CUDA kernel ``kernel_name`` over ``iters``
    calls of ``fn``, from the profiler; None when ``tries`` profiled runs
    all record no device time for it (a profiled run now and then records
    none at all)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
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
        if count:
            return total / count / 1e3
    return None


def device_call_ms(fn, kernel_names: tuple, iters: int = 50) -> float:
    """Device time a call of ``fn`` spends in the CUDA kernels whose names
    contain one of ``kernel_names`` (all of a route's launches), over
    ``iters`` calls, from the profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total for ev in _device_events(prof)
               if any(n in ev.key for n in kernel_names)) / iters / 1e3


def device_total_ms(fn, iters: int = 50) -> float:
    """Mean device time of everything ``fn`` launches, over ``iters``
    calls, from the profiler: unlike CUDA events around back-to-back
    calls, it does not count the host's launch time when the host, not
    the device, sets the pace."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total
               for ev in _device_events(prof)) / iters / 1e3


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


def launch_counts() -> dict:
    """Every kernel wrapper's launch count."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.hash_table import ops as ht_ops
    from repro_torch.kernels.mvcc_validate import ops as mv_ops
    from repro_torch.kernels.sig_mac import ops as mac_ops
    return {"mac_many": mac_ops.launches, "lookup": ht_ops.launches,
            "commit": ht_ops.commit_launches, "validate": mv_ops.launches,
            "flash_attention": fa_ops.launches,
            "flash_attention_bwd": fa_ops.launches_bwd}


def launches_by_device() -> dict:
    """K1-K4's launch counts by device: kernel -> {"cuda:i": n}."""
    from repro_torch.kernels.hash_table import ops as ht_ops
    from repro_torch.kernels.mvcc_validate import ops as mv_ops
    from repro_torch.kernels.sig_mac import ops as mac_ops
    return {"mac_many": dict(mac_ops.launches_by_device),
            "lookup": dict(ht_ops.launches_by_device),
            "commit": dict(ht_ops.commit_launches_by_device),
            "validate": dict(mv_ops.launches_by_device)}


def zero_launch_counts() -> None:
    """Every launch count to 0, the counts by device too."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.hash_table import ops as ht_ops
    from repro_torch.kernels.mvcc_validate import ops as mv_ops
    from repro_torch.kernels.sig_mac import ops as mac_ops
    mac_ops.launches = ht_ops.launches = ht_ops.commit_launches = 0
    mv_ops.launches = fa_ops.launches = fa_ops.launches_bwd = 0
    for c in (mac_ops.launches_by_device, ht_ops.launches_by_device,
              ht_ops.commit_launches_by_device, mv_ops.launches_by_device):
        c.clear()


def k1_k4_launches(stats, k4_per_block: int = 1) -> dict:
    """The K1 and K4 launches a run of rounds must make: K1 once a round
    for the endorsers' tags, once a round for admission (whole or one
    proposal a step) and once a block for the endorsement check (whole,
    tiled or one transaction a step); K4 once a block on its one-CTA
    route, twice on its tiled route."""
    n_blocks = sum(st.n_blocks for st in stats)
    return {"mac_many": 2 * len(stats) + n_blocks,
            "validate": k4_per_block * n_blocks}


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


def window_launches(stats, depth: int, replayed_blocks: int) -> dict:
    """The K1, K2 and K4 launches of a window engine's rounds and of a
    verify() that replays ``replayed_blocks`` blocks: K1 twice a round
    (the endorsers' tags, admission) and once a window (the whole window's
    endorsement check); K2 twice a round (the endorser's reads), twice a
    window (the fill's probe and the fused commit's), once a block for the
    replica's update and once a replayed block; K4 once a block."""
    n_blocks = sum(st.n_blocks for st in stats)
    n_windows = sum(-(-st.n_blocks // depth) for st in stats)
    return {"mac_many": 2 * len(stats) + n_windows,
            "lookup": 2 * len(stats) + 2 * n_windows + n_blocks
            + replayed_blocks,
            "validate": n_blocks, "commit": 0}


def window_view(e, channel: int = 0) -> dict:
    """A channel's store chain, heads and digests, in the form of phase 4's
    ``results``: with a window committer the peer's table and journal head
    are the committer's."""
    from repro_torch.core import u32
    from repro_torch.core import world_state as ws
    e.store.drain()
    ch = e.chans[channel]
    return {
        "chain": [(sb.block_no, sb.prev_hash, sb.block_hash, sb.valid)
                  for sb in e.store.chains[channel]],
        "log_head": u32.to_numpy(ch.log_head),
        "journal_head": e._peer_journal_head(channel),
        "peer": [e._peer_digest(channel)],
        "replica": u32.to_numpy(ws.state_digest(ch.endorser_state)),
    }


def window_phase(cfg, on_card, counts, zero_counts, same_results,
                 path_launches, dev, *, n_accounts: int = None,
                 round_txs: int = None, elastic_start: int = None,
                 profile: bool = True) -> dict:
    """Phase 13: the block pipeline (pipeline/engine_bridge.WindowCommitter
    at depth 8) under phase 4's engine configuration ``cfg``, on ``dev``
    and on the CPU; ``on_card`` is phase 4's per-block result. The keyword
    sizes default to the phase's; a rehearsal on the CPU passes smaller."""
    from repro_torch.core import engine
    from repro_torch.launch import fabric_step as fs
    from repro_torch.pipeline import engine_bridge as eb
    n_accounts = n_accounts or N_ACCOUNTS
    round_txs = round_txs or ROUND_TXS
    elastic_start = elastic_start or WINDOW_ELASTIC_START
    dims, nb, slots = cfg.dims, cfg.n_buckets, cfg.slots
    cuda = torch.device(dev).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def window_engine(c, device, depth=WINDOW_DEPTH):
        wc = eb.WindowCommitter(dims, fs.FabricStepConfig(
            pipeline_depth=depth), n_buckets=c.n_buckets, slots=c.slots,
            device=device)
        return engine.FabricEngine(c, device=device, window_committer=wc)

    def rounds(e, seeds, n=None):
        return [e.run_round(e.make_proposals(n or round_txs, seed=s,
                                             n_accounts=n_accounts))
                for s in seeds]

    def launches_ok(name, got, want):
        path_launches[name] = got
        bad = {k: (got[k], n) for k, n in want.items() if got[k] != n}
        if bad:
            raise AssertionError(f"{name}: launches (got, expected) {bad}")

    out = {}
    # (a) The window engine at phase 4's size; its launches counted.
    zero_counts()
    e = window_engine(cfg, dev)
    st = rounds(e, SEEDS)
    verdict = e.verify()
    got = counts()
    if not all(verdict.values()):
        raise AssertionError(f"window engine verify() {verdict}")
    launches_ok("window", got, window_launches(
        st, WINDOW_DEPTH, sum(s.n_blocks for s in st)))
    card_view = window_view(e)
    same_results(on_card, card_view, "window engine against phase 4's "
                 "per-block engine")
    out["rounds"] = [s._asdict() for s in st]
    out["launches"] = got
    out["view"] = card_view  # phase 15's reference; main takes it out
    e.store.close()
    del e
    log(f"[pipeline] window engine, depth {WINDOW_DEPTH}: "
        f"{len(card_view['chain'])} blocks, verify {verdict}; chain, log "
        f"head, journal head {card_view['journal_head']} and digests equal "
        f"phase 4's per-block engine; launches {got}")

    # (b) The same rounds on the CPU, plain versions.
    t1 = time.perf_counter()
    e = window_engine(cfg, "cpu")
    rounds(e, SEEDS)
    same_results(card_view, window_view(e), "window engine, card against "
                 "CPU")
    cpu_verdict = e.verify()
    if cpu_verdict != verdict:
        raise AssertionError(f"window engine: CPU verify {cpu_verdict}")
    e.store.close()
    del e
    log(f"[pipeline] the same rounds on the CPU: identical "
        f"({time.perf_counter() - t1:.1f} s)")

    # (c) Overflow: an 8 x 2 table at depth 4, one round of 200.
    ocfg = dataclasses.replace(cfg, n_buckets=8, slots=2)
    views = []
    for device in (dev, "cpu"):
        if device == dev:
            zero_counts()
        e = window_engine(ocfg, device, depth=4)
        ost = rounds(e, (0,), 2 * cfg.orderer.block_size)
        over = e.verify()
        if device == dev:
            got = counts()
            want = window_launches(ost, 4, sum(s.n_blocks for s in ost))
            launches_ok("window_overflow", got, {
                k: want[k] for k in ("mac_many", "validate", "commit")})
        if over["overflow_ok"] or not over["chain_ok"] or \
                e.overflow_bits() != 1:
            raise AssertionError(f"overflow: verify {over}, bits "
                                 f"{e.overflow_bits()}")
        views.append((window_view(e), over))
        e.store.close()
        del e
    same_results(views[0][0], views[1][0], "overflowing window, card "
                 "against CPU")
    out["overflow"] = {"verify": views[0][1], "valid": int(sum(
        v.sum() for *_, v in views[0][0]["chain"]))}
    log(f"[pipeline] overflow at 8 x 2, depth 4: verify {views[0][1]}, "
        f"{out['overflow']['valid']} of {2 * cfg.orderer.block_size} valid;"
        f" card = CPU")

    # (d) Elastic state through the window committer.
    tmp = tempfile.TemporaryDirectory()
    eviews = []
    for i, device in enumerate((dev, "cpu")):
        ecfg = dataclasses.replace(
            cfg, n_buckets=elastic_start,
            resize_policy=engine.ResizePolicy(grow_free_slots=2),
            journal_dir=os.path.join(tmp.name, f"jrnl{i}"))
        if device == dev:
            zero_counts()
        e = window_engine(ecfg, device)
        est = rounds(e, SEEDS)
        ever = e.verify()
        if device == dev:
            got = counts()
            want = window_launches(est, WINDOW_DEPTH, 0)
            launches_ok("window_elastic", got, {
                k: want[k] for k in ("mac_many", "validate", "commit")})
        if not all(ever.values()) or not e.reanchor_log:
            raise AssertionError(f"elastic window engine: verify {ever}, "
                                 f"epochs {e.reanchor_log}")
        eviews.append({
            "reanchor_log": list(e.reanchor_log), "n_buckets": e.n_buckets,
            "digest": e._peer_digest(), "journal_head": e._peer_journal_head(),
            "journal": np.asarray(e.journal.head),
            "reanchor_head": np.asarray(e.journal.reanchor_head)})
        e.store.close()
        del e
    tmp.cleanup()
    for k in eviews[0]:
        if not np.array_equal(eviews[0][k], eviews[1][k]):
            raise AssertionError(f"elastic window engine: {k} differs "
                                 f"between card and CPU")
    out["elastic"] = {"reanchor_log": eviews[0]["reanchor_log"],
                      "n_buckets": eviews[0]["n_buckets"]}
    log(f"[pipeline] elastic from {elastic_start} x {slots}: epochs "
        f"{eviews[0]['reanchor_log']} to {eviews[0]['n_buckets']} buckets; "
        f"card = CPU (epochs, digest, journal heads)")

    # (e) Timing: per-block and window engines in turns; then one window
    # profiled for the device's busy share.
    turns = []
    for mode in WINDOW_TURNS:
        e = (engine.FabricEngine(cfg, device=dev) if mode == "block"
             else window_engine(cfg, dev))
        tst = rounds(e, SEEDS)[-1]
        turns.append({"engine": mode, **tst._asdict(), "tps": tst.tps})
        log(f"[pipeline] turn {mode}: {tst.tps:.1f} tx/s, wall "
            f"{tst.wall_s:.4f} s = order {tst.order_s:.4f} + commit "
            f"{tst.commit_s:.4f}; replay {tst.replay_s:.4f} s")
        if mode == "window" and profile and "profiled_window" not in out:
            out["profiled_window"] = _profile_window(e, sync, n_accounts,
                                                     round_txs)
        e.store.close()
        del e
        if cuda:
            torch.cuda.empty_cache()
    out["turns"] = turns
    med = lambda mode, k: float(np.median([t[k] for t in turns
                                           if t["engine"] == mode]))
    out["medians"] = {mode: {k: med(mode, k) for k in
                             ("tps", "order_s", "commit_s", "wall_s")}
                      for mode in ("block", "window")}
    log(f"[pipeline] medians {out['medians']}")
    return out


def channel_window_launches(rounds, depth: int, n_channels: int,
                            replayed_blocks: int) -> dict:
    """The K1, K2 and K4 launches of a multi-channel window engine's
    lockstep rounds (``rounds``: each round's per-channel stats) and of a
    verify_all() that replays ``replayed_blocks`` blocks in all: K1 twice a
    channel round (the endorsers' tags, admission) and once a window
    position range (every channel's rows at once); K2 twice a channel
    round, twice a channel window (the fill's probe and the fused
    commit's), once a block for the replica and once a replayed block; K4
    once a block position (the channels' blocks in one launch)."""
    n_blocks = sum(r[0].n_blocks for r in rounds)
    n_windows = sum(-(-r[0].n_blocks // depth) for r in rounds)
    c = n_channels
    return {"mac_many": 2 * c * len(rounds) + n_windows,
            "lookup": 2 * c * len(rounds) + 2 * c * n_windows
            + c * n_blocks + replayed_blocks,
            "validate": n_blocks, "commit": 0}


def channels_phase(cfg, counts, zero_counts, same_results, path_launches,
                   dev, *, n_accounts: int = None, round_txs: int = None,
                   zipf: tuple = None, durable_nb: int = None,
                   card: str = "") -> dict:
    """Phase 14 (a)-(c): several channels on one card under phase 4's
    engine configuration ``cfg`` (one channel); see the module docstring.
    The keyword sizes default to the phase's; a rehearsal on the CPU passes
    smaller ones."""
    from repro_torch.core import engine
    from repro_torch.launch import fabric_step as fs
    from repro_torch.pipeline import engine_bridge as eb
    n_accounts = n_accounts or N_ACCOUNTS
    round_txs = round_txs or ROUND_TXS
    zipf = zipf or CHANNEL_ZIPF
    durable_nb = durable_nb or CHANNEL_DURABLE_NB
    cuda = torch.device(dev).type == "cuda"
    nch = CHANNELS
    out = {"card": card}

    def launches_ok(name, got, want):
        path_launches[name] = got
        bad = {k: (got[k], n) for k, n in want.items() if got[k] != n}
        if bad:
            raise AssertionError(f"{name}: launches (got, expected) {bad}")

    def props(e, r, c, n):
        return e.make_proposals(n, seed=100 * r + c, n_accounts=n_accounts)

    def window_engine(c, device, n_channels, nb=None):
        wc = eb.WindowCommitter(
            c.dims, fs.FabricStepConfig(pipeline_depth=WINDOW_DEPTH),
            n_buckets=nb or c.n_buckets, slots=c.slots,
            n_channels=n_channels, device=device)
        return engine.FabricEngine(c, device=device, window_committer=wc)

    # (a) Four channels in lockstep through the window committer.
    cfg4 = dataclasses.replace(cfg, n_channels=nch)
    zero_counts()
    e = window_engine(cfg4, dev, nch)
    rounds = [e.run_rounds([props(e, r, c, round_txs) for c in range(nch)])
              for r in range(2)]
    verdicts = e.verify_all()
    got = counts()
    if not all(all(v.values()) for v in verdicts.values()):
        raise AssertionError(f"four-channel window engine: {verdicts}")
    launches_ok("channels_window", got, channel_window_launches(
        rounds, WINDOW_DEPTH, nch, sum(e.store.chains[c][-1].block_no + 1
                                       for c in range(nch))))
    views = [window_view(e, c) for c in range(nch)]
    timed = rounds[-1]
    tps = [st.n_txs / st.wall_s for st in timed]
    e.store.close()
    del e
    single = []
    for c in range(nch):
        e = window_engine(cfg, dev, 1)
        st = [e.run_round(props(e, r, c, round_txs)) for r in range(2)]
        same_results(views[c], window_view(e), f"channel {c} of four "
                     "against a one-channel window engine")
        single.append(st[-1].tps)
        e.store.close()
        del e
    out["window"] = {
        "verify_all": verdicts, "launches": got,
        "rounds": [[s._asdict() for s in r] for r in rounds],
        "per_channel_tps": tps, "aggregate_tps": sum(tps),
        "fairness": min(tps) / max(tps), "single_channel_tps": single,
        "per_channel_vs_single": float(np.mean(tps) / np.mean(single))}
    log(f"[channels] window path, {nch} channels at depth {WINDOW_DEPTH}: "
        f"verify_all {verdicts[0]} on every channel; launches {got}, K4 "
        f"once a window position; each channel equals a one-channel window "
        f"engine")
    log(f"[channels] per-channel tx/s {[round(t, 1) for t in tps]} "
        f"(shared wall {timed[0].wall_s:.4f} s = order "
        f"{timed[0].order_s:.4f} + commit {timed[0].commit_s:.4f}; replay "
        f"{timed[0].replay_s:.4f} s), aggregate {sum(tps):.1f}, fairness "
        f"{out['window']['fairness']:.4f}; one-channel window engines "
        f"{[round(t, 1) for t in single]} tx/s, per-channel / one-channel "
        f"{out['window']['per_channel_vs_single']:.4f}")
    if cuda:
        torch.cuda.empty_cache()

    # (b) The host path under the Zipf load, card against CPU.
    hviews = []
    for device in (dev, "cpu"):
        if device == dev:
            zero_counts()
        e = engine.FabricEngine(cfg4, device=device)
        st = e.run_rounds([props(e, 5, c, n) for c, n in enumerate(zipf)])
        hverdicts = e.verify_all()
        if device == dev:
            got = counts()
            want = k1_k4_launches(st)
            launches_ok("channels_host", got, want)
            htps = [s.n_txs / s.wall_s for s in st]
            hst = st
        if not all(all(v.values()) for v in hverdicts.values()):
            raise AssertionError(f"Zipf host path on {device}: {hverdicts}")
        hviews.append([window_view(e, c) for c in range(nch)])
        e.store.close()
        del e
    for c in range(nch):
        same_results(hviews[0][c], hviews[1][c], f"Zipf host path, channel "
                     f"{c}, card against CPU")
    out["host_zipf"] = {
        "load": list(zipf), "launches": got,
        "rounds": [s._asdict() for s in hst], "per_channel_tps": htps,
        "aggregate_tps": sum(htps), "fairness": min(htps) / max(htps)}
    log(f"[channels] host path, Zipf load {list(zipf)}: verify_all True; "
        f"card = CPU; launches {got}; per-channel tx/s "
        f"{[round(t, 1) for t in htps]} (shared wall {hst[0].wall_s:.4f} "
        f"s), aggregate {sum(htps):.1f}, fairness "
        f"{out['host_zipf']['fairness']:.4f}")

    # (c) Durability: two channels, channel 1 doubled, then restore.
    tmp = tempfile.TemporaryDirectory()
    dcfg = dataclasses.replace(
        cfg, n_channels=2, n_buckets=durable_nb,
        snapshot_every_blocks=CHANNEL_DURABLE_EVERY,
        **{k: os.path.join(tmp.name, k) for k in ("journal_dir",
                                                   "snapshot_dir",
                                                   "block_dir")})
    zero_counts()
    e = window_engine(dcfg, dev, 2)
    drounds = [e.run_rounds([props(e, 7, c, round_txs) for c in range(2)])]
    e.resize(2 * durable_nb, channel=1)
    groups = len(e.window_committer.groups)
    drounds.append(e.run_rounds([props(e, 8, c, round_txs)
                                 for c in range(2)]))
    dverdicts = e.verify_all()
    got = counts()
    want = channel_window_launches(drounds, WINDOW_DEPTH, 2, 0)
    # After the resize each shape group runs its own step: K1 once a
    # window and K4 once a block position, a group.
    want["mac_many"] += (groups - 1) * -(-drounds[1][0].n_blocks
                                         // WINDOW_DEPTH)
    want["validate"] += (groups - 1) * drounds[1][0].n_blocks
    launches_ok("channels_durable", got, {
        k: want[k] for k in ("mac_many", "validate", "commit")})
    if not all(all(v.values()) for v in dverdicts.values()) or groups != 2:
        raise AssertionError(f"durable channels: {dverdicts}, {groups} "
                             "groups")
    live = [(e._peer_digest(c), e._peer_journal_head(c), e._ledger_head(c),
             e.chans[c].next_block_no, e.chans[c].n_buckets)
            for c in range(2)]
    snaps = [[s.block_no for s in e.chans[c].snapshots] for c in range(2)]
    e.store.close()
    del e
    t1 = time.perf_counter()
    back = engine.FabricEngine.restore(dcfg, device=dev)
    restore_s = time.perf_counter() - t1
    rverdicts = back.verify_all()
    for c in range(2):
        got_c = (back._peer_digest(c), back._peer_journal_head(c),
                 back._ledger_head(c), back.chans[c].next_block_no,
                 back.chans[c].n_buckets)
        if not all(np.array_equal(x, y) for x, y in zip(got_c, live[c])):
            raise AssertionError(f"restored channel {c} differs from the "
                                 "live one")
    if not all(all(v.values()) for v in rverdicts.values()):
        raise AssertionError(f"restored channels: verify_all {rverdicts}")
    back.store.close()
    del back
    tmp.cleanup()
    out["durable"] = {"verify_all": dverdicts, "restored": rverdicts,
                      "launches": got, "snapshots": snaps,
                      "n_buckets": [x[4] for x in live],
                      "restore_s": restore_s}
    log(f"[channels] durable, two channels from {durable_nb} x "
        f"{cfg.slots}: channel 1 doubled ({groups} shape groups), "
        f"snapshots {snaps}, launches {got}; restore() in {restore_s:.3f} "
        f"s, every channel equal to the live one, verify_all True")

    return out


def sharded_window_launches(stats, depth: int, n_shards: int) -> dict:
    """The K1-K4 launches of a sharded window engine's rounds: as
    :func:`window_launches` without a replay, but the window's fill and its
    fused commit probe once a shard."""
    n_blocks = sum(st.n_blocks for st in stats)
    n_windows = sum(-(-st.n_blocks // depth) for st in stats)
    return {"mac_many": 2 * len(stats) + n_windows,
            "lookup": 2 * len(stats) + 2 * n_shards * n_windows + n_blocks,
            "validate": n_blocks, "commit": 0}


def sharding_phase(cfg, reference_view, counts, zero_counts, same_results,
                   path_launches, dev, *, n_accounts: int = None,
                   round_txs: int = None, check_nb: int = None,
                   card: str = "") -> dict:
    """Phase 15: bucket-sharded world state (``SHARDS`` shards) under phase
    4's engine configuration ``cfg``; ``reference_view`` is phase 13's
    replicated window engine's result on the same rounds. See the module
    docstring. The keyword sizes default to the phase's; a rehearsal on
    the CPU passes smaller ones."""
    from repro_torch.core import endorser, engine, ledger, u32, unmarshal
    from repro_torch.core import world_state as ws
    from repro_torch.launch import fabric_step as fs
    from repro_torch.launch import state_sharding as ss
    from repro_torch.pipeline import engine_bridge as eb
    from repro_torch.storage import recovery, snapshot
    n_accounts = n_accounts or N_ACCOUNTS
    round_txs = round_txs or ROUND_TXS
    check_nb = check_nb or SHARD_CHECK_NB
    m = SHARDS
    dims, nb, slots = cfg.dims, cfg.n_buckets, cfg.slots
    bsz = cfg.orderer.block_size
    cuda = torch.device(dev).type == "cuda"
    out = {"card": card, "n_shards": m, "nb_loc": nb // m}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def launches_ok(name, got, want):
        path_launches[name] = got
        bad = {k: (got[k], n) for k, n in want.items() if got[k] != n}
        if bad:
            raise AssertionError(f"{name}: launches (got, expected) {bad}")

    def rounds(e, seeds, n=None):
        return [e.run_round(e.make_proposals(n or round_txs, seed=s,
                                             n_accounts=n_accounts))
                for s in seeds]

    def sharded_engine(c, device, depth=WINDOW_DEPTH):
        wc = eb.WindowCommitter(
            c.dims, dataclasses.replace(fs.FASTFABRIC_PIPELINED_STEP,
                                        pipeline_depth=depth),
            n_buckets=c.n_buckets, slots=c.slots, n_shards=m, device=device)
        return engine.FabricEngine(c, device=device, window_committer=wc)

    def replicated_engine(c, device):
        wc = eb.WindowCommitter(
            c.dims, fs.FabricStepConfig(pipeline_depth=WINDOW_DEPTH),
            n_buckets=c.n_buckets, slots=c.slots, device=device)
        return engine.FabricEngine(c, device=device, window_committer=wc)

    def blocks(n, device, n_blocks):
        """The first ``n_blocks`` blocks of a round of ``n`` of phase 4's
        warm-up proposals, endorsed at genesis, as (D, B, WB) and (D, B, 2)
        in proposal order."""
        maker = engine.FabricEngine(dataclasses.replace(
            cfg, n_buckets=1 << 10, store_blocks=False), device=device)
        txb = endorser.execute_and_endorse(
            maker.endorser_state, maker.make_proposals(
                n, seed=SEEDS[0], n_accounts=n_accounts), dims)
        wire = unmarshal.marshal(txb, dims)[:n_blocks * bsz]
        return (wire.reshape(n_blocks, bsz, -1),
                txb.tx_id[:n_blocks * bsz].reshape(n_blocks, bsz, 2))

    def step_run(step_cfg, n_shards, wire, ids, device, table_nb):
        step = fs.make_fabric_step(dims, step_cfg, n_shards=n_shards)
        st = fs.create_mesh_state(1, dims, table_nb, slots, device=device)
        valid = []
        for k in range(wire.shape[0]):
            st, v = step(st, wire[k][None], ids[k][None])
            valid.append(v[0])
        return st, torch.stack(valid)

    def same_state(a, b, what):
        (sa, va), (sb, vb) = a, b
        for name, x, y in zip(fs.FabricMeshState._fields, sa, sb):
            if not torch.equal(x.cpu(), y.cpu()):
                raise AssertionError(f"{what}: {name} differs")
        if not torch.equal(va.cpu(), vb.cpu()):
            raise AssertionError(f"{what}: validity differs")

    # (a) The sharded depth-1 step against the replicated one: ten blocks
    # of phase 4's proposals on a 2^20 x 8 table; then one block of a
    # sequential commit (K3 once a shard).
    wire, ids = blocks(round_txs, dev, SHARD_STEP_BLOCKS)
    repl = step_run(fs.FASTFABRIC_STEP, 1, wire, ids, dev, nb)
    zero_counts()
    t1 = time.perf_counter()
    shard = step_run(fs.FASTFABRIC_SHARDED_STEP, m, wire, ids, dev, nb)
    sync()
    step_s = time.perf_counter() - t1
    n = SHARD_STEP_BLOCKS
    launches_ok("sharded_step", counts(), {
        "mac_many": n, "lookup": 2 * m * n, "validate": n, "commit": 0})
    same_state(shard, repl, "sharded depth-1 step against the replicated")
    if ss.bits_to_int(shard[0].overflow[0]) or not bool(shard[1].all()):
        raise AssertionError("sharded step: overflow or invalid txs")
    seq = dataclasses.replace(fs.FASTFABRIC_SHARDED_STEP,
                              sequential_commit=True)
    seq_repl = step_run(dataclasses.replace(seq, shard_state=False), 1,
                        wire[:1], ids[:1], dev, nb)
    zero_counts()
    seq_shard = step_run(seq, m, wire[:1], ids[:1], dev, nb)
    sync()
    launches_ok("sharded_step_sequential", counts(), {
        "mac_many": 1, "lookup": m, "validate": 1, "commit": m})
    same_state(seq_shard, seq_repl, "sharded sequential commit against "
               "the replicated")
    del seq_repl, seq_shard, repl
    out["step"] = {"blocks": n, "launches": path_launches["sharded_step"],
                   "step_s": step_s,
                   "sequential": path_launches["sharded_step_sequential"]}
    log(f"[sharding] depth-1 step, {m} shards of {nb // m} buckets, {n} "
        f"blocks: every state tensor, head, validity bit and overflow lane "
        f"equal to the replicated step's ({step_s:.3f} s); launches "
        f"{path_launches['sharded_step']}; a sequential block: K3 "
        f"{path_launches['sharded_step_sequential']['commit']} (once a "
        f"shard), equal")

    # (c) The butterfly resize of (a)'s table: 2^20 -> 2^21 and back.
    table = fs.table(shard[0].keys, shard[0].versions, shard[0].values, 0)
    resize = {}
    for what, src, old_nb, new_nb in (("grow", table, nb, 2 * nb),
                                      ("shrink", None, 2 * nb, nb)):
        if src is None:
            src = ws.HashState(*(torch.cat(p) for p in zip(*res.state)))
        # Each timed on its second call (the first allocates).
        for _ in range(2):
            sync()
            t1 = time.perf_counter()
            res = ss.resize_sharded(ss.shard_views(src, m), new_nb // m,
                                    old_nb, m)
            sync()
            routed_s = time.perf_counter() - t1
        for _ in range(2):
            t1 = time.perf_counter()
            want = ws.resize(src, new_nb)
            sync()
            plain_s = time.perf_counter() - t1
        got = ws.HashState(*(torch.cat(p) for p in zip(*res.state)))
        if not all(torch.equal(x, y) for x, y in zip(got, want.state)) or \
                bool(res.overflow) or bool(want.overflow):
            raise AssertionError(f"resize_sharded {what} differs from "
                                 f"world_state.resize")
        resize[what] = {"from": old_nb, "to": new_nb, "routed_s": routed_s,
                        "world_state_resize_s": plain_s}
        del want, got
    del res, src, table, shard
    out["resize"] = resize
    log(f"[sharding] butterfly resize, {m} shards: {resize}; equal to "
        f"world_state.resize of the merged table")
    if cuda:
        torch.cuda.empty_cache()

    # (b) The sharded window engine, durable, against phase 13's
    # replicated one; then a round of 300, a doubling and another round of
    # 300 for (e).
    tmp = tempfile.TemporaryDirectory()
    dirs = {k: os.path.join(tmp.name, k)
            for k in ("journal_dir", "snapshot_dir", "block_dir")}
    dcfg = dataclasses.replace(cfg, snapshot_every_blocks=SHARD_DURABLE_EVERY,
                               **dirs)
    zero_counts()
    e = sharded_engine(dcfg, dev)
    st = rounds(e, SEEDS)
    view = window_view(e)
    # The durable engine's chain is pruned a snapshot behind.
    kept = [c for c in reference_view["chain"]
            if c[0] >= view["chain"][0][0]]
    if view["chain"][0][0] != e.store.base_block_no + 1:
        raise AssertionError("sharded window engine: chain starts at block "
                             f"{view['chain'][0][0]}, base "
                             f"{e.store.base_block_no}")
    same_results(dict(reference_view, chain=kept), view, "sharded window "
                 "engine against phase 13's replicated window engine")
    wc = e.window_committer
    tree = wc.tree_head()
    routed_tree = u32.to_numpy(ss.sharded_digest(ss.shard_views(
        wc.hash_state(), m)))
    if not (np.array_equal(tree, routed_tree) and np.array_equal(
            tree, u32.to_numpy(ws.tree_head(wc.hash_state(), m)))):
        raise AssertionError("sharded window engine: tree_head differs")
    snaps = [sn.block_no for sn in e.snapshots]
    man = snapshot.latest_manifest(dirs["snapshot_dir"])
    parts = sorted(f for f in os.listdir(dirs["snapshot_dir"])
                   if f.startswith(f"shard_{man.block_no:08d}_"))
    if man.n_shards != m or len(parts) != m:
        raise AssertionError(f"snapshot: {man.n_shards} shards, files "
                             f"{parts}")
    st += rounds(e, (SEEDS[-1] + 1,), SHARD_AFTER_TXS)
    e.resize(2 * nb)
    st += rounds(e, (SEEDS[-1] + 2,), SHARD_AFTER_TXS)
    got = counts()
    launches_ok("sharded_window", got,
                sharded_window_launches(st, WINDOW_DEPTH, m))
    verdict = e.verify()
    if not all(verdict.values()):
        raise AssertionError(f"sharded window engine: verify {verdict}")
    out["window"] = {"verify": verdict, "launches": got, "snapshots": snaps,
                     "snapshot_parts": len(parts),
                     "tree_head": tree.tolist(),
                     "rounds": [s._asdict() for s in st]}
    log(f"[sharding] window engine, {m} shards, depth {WINDOW_DEPTH}, "
        f"durable: chain (blocks {view['chain'][0][0]}-"
        f"{view['chain'][-1][0]} kept), log head, journal head "
        f"{view['journal_head']} and digests equal phase 13's replicated "
        f"window engine; tree_head "
        f"{tree.tolist()} = routed digest tree; snapshots {snaps} in {m} "
        f"parts; rounds of {SHARD_AFTER_TXS} before and after a doubling "
        f"to {2 * nb} buckets; verify {verdict}; launches {got}")

    # (e) recover_shard for every shard from (b)'s directories.
    e.store.drain()
    live = ss.shard_views(wc.hash_state(), m)
    recovered = []
    for k in range(m):
        sync()
        t1 = time.perf_counter()
        rec = recovery.recover_shard(
            e.chans[0].journal, shard=k, device=dev,
            snapshot_dir=ledger.channel_dir(dirs["snapshot_dir"], 0))
        sync()
        rec_s = time.perf_counter() - t1
        sched = recovery._range_schedule(k, m, [nb, 2 * nb])
        want_parts = sum(max(size // (nb // m), 1) for _, size in sched[0])
        if not all(torch.equal(x, y) for x, y in zip(rec.state, live[k])) \
                or rec.loaded_parts != want_parts \
                or rec.crossed_reanchors != 1:
            raise AssertionError(f"recover_shard({k}): differs from the live "
                                 f"shard, or loaded {rec.loaded_parts} parts "
                                 f"(schedule {want_parts}), crossed "
                                 f"{rec.crossed_reanchors}")
        recovered.append({"shard": k, "s": rec_s,
                          "loaded_parts": rec.loaded_parts,
                          "replayed_records": rec.replayed_records})
    out["recover_shard"] = recovered
    e.store.close()
    del e, wc, live
    tmp.cleanup()
    log(f"[sharding] recover_shard of each of {m} shards equals the live "
        f"shard: {recovered}")
    if cuda:
        torch.cuda.empty_cache()

    # (b) timing: the replicated and the sharded window engines in turns.
    turns = []
    for mode in SHARD_TURNS:
        e = (sharded_engine(cfg, dev) if mode == "sharded"
             else replicated_engine(cfg, dev))
        tst = rounds(e, SEEDS)[-1]
        turns.append({"engine": mode, **tst._asdict(), "tps": tst.tps})
        log(f"[sharding] turn {mode}: {tst.tps:.1f} tx/s, wall "
            f"{tst.wall_s:.4f} s = order {tst.order_s:.4f} + commit "
            f"{tst.commit_s:.4f}; replay {tst.replay_s:.4f} s")
        e.store.close()
        del e
        if cuda:
            torch.cuda.empty_cache()
    med = lambda mode, k: float(np.median([t[k] for t in turns
                                           if t["engine"] == mode]))
    out["turns"] = turns
    out["medians"] = {mode: {k: med(mode, k) for k in
                             ("tps", "order_s", "commit_s", "wall_s")}
                      for mode in ("replicated", "sharded")}
    out["tps_ratio"] = (out["medians"]["sharded"]["tps"]
                        / out["medians"]["replicated"]["tps"])
    log(f"[sharding] medians {out['medians']}; sharded / replicated tx/s "
        f"{out['tps_ratio']:.4f}")

    # (d) Overflow: an 8 x 2 table in 4 shards (2 buckets each) at depth
    # 4, a round of 200; card against CPU.
    ocfg = dataclasses.replace(cfg, n_buckets=8, slots=2)
    oviews = []
    for device in (dev, "cpu"):
        if device == dev:
            zero_counts()
        e = sharded_engine(ocfg, device, depth=4)
        ost = rounds(e, (0,), 2 * bsz)
        if device == dev:
            launches_ok("sharded_overflow", counts(),
                        sharded_window_launches(ost, 4, m))
        over = e.verify()
        bits = e.overflow_bits()
        if over["overflow_ok"] or not over["chain_ok"] or not bits & ~1 \
                or bits >> m:
            raise AssertionError(f"sharded overflow: verify {over}, bits "
                                 f"{bits:b}")
        oviews.append((window_view(e), bits))
        e.store.close()
        del e
    same_results(oviews[0][0], oviews[1][0], "sharded overflow, card "
                 "against CPU")
    if oviews[0][1] != oviews[1][1]:
        raise AssertionError("sharded overflow: bits differ between card "
                             "and CPU")
    out["overflow"] = {"bits": oviews[0][1], "verify": over}
    log(f"[sharding] overflow at 8 x 2 in {m} shards: bits "
        f"{oviews[0][1]:0{m}b} (shards that dropped writes), card = CPU")

    # (f) Card against CPU at 2^14 buckets: the depth-1 step over three
    # blocks and the window engine over two rounds of 300.
    cwire, cids = blocks(SHARD_CHECK_TXS, "cpu", SHARD_CHECK_TXS // bsz)
    step_views = [step_run(fs.FASTFABRIC_SHARDED_STEP, m, cwire.to(device),
                           cids.to(device), device, check_nb)
                  for device in (dev, "cpu")]
    same_state(*step_views, "sharded step, card against CPU")
    ccfg = dataclasses.replace(cfg, n_buckets=check_nb)
    cviews = []
    for device in (dev, "cpu"):
        e = sharded_engine(ccfg, device)
        rounds(e, SEEDS, SHARD_CHECK_TXS)
        cviews.append((window_view(e), e.verify(), e.window_committer
                       .tree_head()))
        e.store.close()
        del e
    same_results(cviews[0][0], cviews[1][0], "sharded window engine, card "
                 "against CPU")
    if cviews[0][1] != cviews[1][1] or not all(cviews[0][1].values()) or \
            not np.array_equal(cviews[0][2], cviews[1][2]):
        raise AssertionError(f"sharded check: verify {cviews[0][1]} / "
                             f"{cviews[1][1]} or tree heads differ")
    log(f"[sharding] card = CPU at {check_nb} buckets: the depth-1 step over "
        f"{SHARD_CHECK_TXS // bsz} blocks and the window engine over two "
        f"rounds of {SHARD_CHECK_TXS}")
    return out


def card_mesh(shape: tuple = MESH_SHAPE):
    """Phase 22's mesh: one card a position when there are enough, else
    every position on cuda:0, listed so."""
    from repro_torch.launch import mesh as mesh_mod
    if torch.cuda.device_count() >= shape[0] * shape[1]:
        return mesh_mod.from_cards(*shape)
    return mesh_mod.Mesh([["cuda:0"] * shape[1]] * shape[0])


def mesh_window_launches(mesh, stats, depth: int, n_channels: int,
                         engine_device) -> dict:
    """K1, K2 and K4 launches by device of a window engine's rounds over
    ``mesh`` (every channel in one shape group): at every rank, once a
    window K1 on its rows, twice a window a channel it holds K2 (the fill
    and the fused commit), once a block position K4 (one CTA); at the
    engine's device, twice a round a channel K1 (the endorsers' tags and
    admission) and K2 (the endorser's reads) and once a block K2 (the
    replica's update)."""
    import collections
    over = n_channels % mesh.dp_size == 0
    c_loc = n_channels // mesh.dp_size if over else n_channels
    out = {k: collections.Counter() for k in ("mac_many", "lookup",
                                              "validate")}
    eng = str(engine_device)
    for rnd in stats:
        n_blocks = rnd[0].n_blocks
        windows = [min(depth, n_blocks - lo)
                   for lo in range(0, n_blocks, depth)]
        out["mac_many"][eng] += 2 * n_channels
        out["lookup"][eng] += (2 + n_blocks) * n_channels
        for row in mesh.devices:
            for dev in row:
                out["mac_many"][str(dev)] += len(windows)
                out["lookup"][str(dev)] += 2 * c_loc * len(windows)
                out["validate"][str(dev)] += sum(windows)
    return {k: dict(v) for k, v in out.items()}


def _same_views(a: dict, b: dict, what: str) -> None:
    """Two engine views (:func:`mesh_view`) equal field by field."""
    if len(a["chain"]) != len(b["chain"]):
        raise AssertionError(f"{what}: chains differ in length")
    for x, y in zip(a["chain"], b["chain"]):
        if x[0] != y[0] or not all(np.array_equal(u, v)
                                   for u, v in zip(x[1:], y[1:])):
            raise AssertionError(f"{what}: block {x[0]} differs")
    for k in a.keys() - {"chain"}:
        xs, ys = ((a[k], b[k]) if isinstance(a[k], list)
                  else ([a[k]], [b[k]]))
        if len(xs) != len(ys) or not all(np.array_equal(u, v)
                                         for u, v in zip(xs, ys)):
            raise AssertionError(f"{what}: {k} differs")


def mesh_view(e, channel: int) -> dict:
    """:func:`window_view` with the ledger head, the digest tree and the
    overflow bits."""
    wc = e.window_committer
    return {**window_view(e, channel),
            "ledger_head": wc.ledger_head_for(channel),
            "tree_head": wc.tree_head(channel),
            "bits": wc.overflow_bits_for(channel)}


def mesh_phase(cfg, counts, zero_counts, path_launches, mesh, *,
               n_accounts: int = None, round_txs: int = None,
               durable_txs: int = None, after_txs: int = None,
               turns: tuple = MESH_TURNS, card: str = "") -> dict:
    """Phase 22: the window engine over ``mesh`` against the one-device
    window engine, under phase 4's engine configuration ``cfg`` at
    ``MESH_CHANNELS`` channels; see the module docstring. The keyword
    sizes default to the phase's; a rehearsal on the CPU passes smaller
    ones and a mesh of CPU positions. ``tools/mesh_turns.py`` runs it
    alone."""
    from repro_torch.core import endorser, engine, unmarshal
    from repro_torch.launch import fabric_step as fs
    from repro_torch.launch import state_sharding as ss
    from repro_torch.pipeline import engine_bridge as eb
    from repro_torch.storage import recovery
    n_accounts = n_accounts or N_ACCOUNTS
    round_txs = round_txs or ROUND_TXS
    durable_txs = durable_txs or MESH_DURABLE_TXS
    after_txs = after_txs or MESH_AFTER_TXS
    nch, first = MESH_CHANNELS, mesh.first
    cuda = first.type == "cuda"
    dims, bsz, m = cfg.dims, cfg.orderer.block_size, mesh.model_size
    ccfg = dataclasses.replace(cfg, n_channels=nch)
    distinct = len(mesh.distinct())
    out = {"card": card, "mesh": [[str(x) for x in r] for r in mesh.devices],
           "distinct_devices": distinct, "channels": nch,
           "depth": WINDOW_DEPTH}
    log(f"[mesh] {mesh!r}: {mesh.dp_size} x {m} positions on {distinct} "
        f"distinct device(s); {nch} channels over data")

    def sync():
        if cuda:
            mesh.synchronize()

    def committer(kind, sharded):
        step = dataclasses.replace(fs.FASTFABRIC_PIPELINED_STEP,
                                   shard_state=sharded)
        if kind == "mesh":
            return eb.WindowCommitter(dims, step, n_buckets=cfg.n_buckets,
                                      slots=cfg.slots, n_channels=nch,
                                      mesh=mesh)
        return eb.WindowCommitter(dims, step, n_buckets=cfg.n_buckets,
                                  slots=cfg.slots, n_channels=nch,
                                  n_shards=m, device=first)

    def rounds(e, plan):
        return [e.run_rounds([e.make_proposals(n, seed=100 * sd + c,
                                               n_accounts=n_accounts)
                              for c in range(nch)]) for sd, n in plan]

    def views(e):
        return [mesh_view(e, c) for c in range(nch)]

    def check_launches(name, want):
        got = launches_by_device()
        path_launches[name] = counts()
        for k, n in want.items():
            if got[k] != n:
                raise AssertionError(f"{name}: {k} launches by device "
                                     f"{got[k]}, expected {n}")
        return got

    # (a) The sharded window engine in turns with the one-device one, then
    # the replicated pair: same proposals, same results; launches by device
    # and gathered bytes of the first mesh turn.
    plan = [(sd, round_txs) for sd in SEEDS]
    parts_s = {}
    for mode, mode_turns in (("sharded", turns), ("replicated",
                                                  ("one", "mesh"))):
        t_part = time.perf_counter()
        ref, res = None, []
        for kind in mode_turns:
            if cuda:
                torch.cuda.empty_cache()
            e = engine.FabricEngine(ccfg, device=first,
                                    window_committer=committer(
                                        kind, mode == "sharded"))
            counted = kind == "mesh" and not any(
                r["engine"] == "mesh" for r in res)
            if counted:
                zero_counts()
                mesh.moved.clear()
            st = rounds(e, plan)
            sync()
            v = views(e)
            if ref is None:
                ref = v
            else:
                for c in range(nch):
                    _same_views(v[c], ref[c], f"{mode} {kind} engine, "
                                f"channel {c}, against the one-device one")
            row = {"engine": kind, "tps": sum(x.n_txs for x in st[-1])
                   / st[-1][0].wall_s, "wall_s": st[-1][0].wall_s,
                   "order_s": st[-1][0].order_s,
                   "commit_s": st[-1][0].commit_s,
                   "replay_s": st[-1][0].replay_s}
            if counted:
                row["launches_by_device"] = check_launches(
                    f"mesh_{mode}", mesh_window_launches(
                        mesh, st, WINDOW_DEPTH, nch, first))
                row["moved"] = dict(mesh.moved)
                n_blocks = sum(x[0].n_blocks for x in st)
                row["consensus_bytes_a_block"] = (
                    mesh.moved["consensus"] / (nch * n_blocks))
                want = fs.consensus_bytes(dims, fs.FASTFABRIC_STEP, bsz, m)
                if row["consensus_bytes_a_block"] != want:
                    raise AssertionError(
                        f"{mode}: consensus bytes a block "
                        f"{row['consensus_bytes_a_block']}, formula {want}")
            res.append(row)
            log(f"[mesh] {mode} turn {kind}: {row['tps']:.1f} tx/s over "
                f"{nch} channels, wall {row['wall_s']:.4f} s = order "
                f"{row['order_s']:.4f} + commit {row['commit_s']:.4f}; "
                f"replay {row['replay_s']:.4f} s")
            e.store.close()
            del e
        med = {k: float(np.median([r["tps"] for r in res
                                   if r["engine"] == k]))
               for k in ("one", "mesh")}
        mesh_row = next(r for r in res if r["engine"] == "mesh")
        out[mode] = {"turns": res, "median_tps": med,
                     "tps_ratio": med["mesh"] / med["one"],
                     "launches_by_device": mesh_row["launches_by_device"],
                     "moved": mesh_row["moved"]}
        parts_s[mode] = time.perf_counter() - t_part
        log(f"[mesh] {mode}: chain, validity, log/journal/ledger heads, "
            f"state_digest, tree_head and overflow bits of both channels "
            f"equal the one-device window engine's; median tx/s mesh "
            f"{med['mesh']:.1f} / one device {med['one']:.1f} = "
            f"{out[mode]['tps_ratio']:.4f}; K1/K2/K4 launches by device "
            f"{mesh_row['launches_by_device']}; bytes between ranks "
            f"{mesh_row['moved']}")

    # (b) Durable, sharded, on the mesh: a round of durable_txs, one of
    # after_txs, the butterfly doubling of channel 0 (2^20 -> 2^21), another
    # round; verify_all. The grown table against the one-device butterfly
    # of the same table, and recover_shard of shard 1 onto rank (0, 1)'s
    # device against recover_shard onto the first device and the live
    # shard.
    t_part = time.perf_counter()
    if cuda:
        torch.cuda.empty_cache()
    mesh.moved.clear()
    tmp = tempfile.TemporaryDirectory()
    dcfg = dataclasses.replace(
        ccfg, snapshot_every_blocks=MESH_DURABLE_EVERY,
        **{k: os.path.join(tmp.name, k)
           for k in ("journal_dir", "snapshot_dir", "block_dir")})
    e = engine.FabricEngine(dcfg, device=first,
                            window_committer=committer("mesh", True))
    rounds(e, [(SEEDS[0], durable_txs), (SEEDS[-1] + 1, after_txs)])
    wc = e.window_committer
    nb = cfg.n_buckets
    before = wc.hash_state(0)
    sync()
    t1 = time.perf_counter()
    e.resize(2 * nb, channel=0)
    sync()
    resize_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    res = ss.resize_sharded(ss.shard_views(before, m), 2 * nb // m, nb, m)
    sync()
    one_resize_s = time.perf_counter() - t1
    if not all(torch.equal(torch.cat(want), got) for want, got in zip(
            zip(*res.state), wc.hash_state(0))) or bool(res.overflow):
        raise AssertionError("the mesh's butterfly doubling differs from "
                             "the one-device butterfly")
    del before, res
    rounds(e, [(SEEDS[-1] + 2, after_txs)])
    verdict = e.verify_all()
    if not all(all(x.values()) for x in verdict.values()):
        raise AssertionError(f"durable mesh engine: verify {verdict}")
    e.store.drain()
    live = wc.shard_tables(0)[1]
    recs = {}
    for named in (mesh.devices[0][1], first):
        sync()
        t1 = time.perf_counter()
        rec = recovery.recover_shard(
            e.chans[0].journal, shard=1, device=named,
            snapshot_dir=engine.ledger.channel_dir(
                os.path.join(tmp.name, "snapshot_dir"), 0))
        sync()
        recs[str(named)] = time.perf_counter() - t1
        if rec.state.keys.device != named or rec.crossed_reanchors != 1 \
                or not all(torch.equal(x, y.to(named))
                           for x, y in zip(rec.state, live)):
            raise AssertionError(f"recover_shard onto {named} differs from "
                                 f"the live shard")
    out["durable"] = {"resize_s": resize_s, "one_device_resize_s":
                      one_resize_s, "recover_shard_s": recs,
                      "verify_all": verdict, "moved": dict(mesh.moved)}
    e.store.close()
    del e, wc, rec, live
    tmp.cleanup()
    parts_s["durable"] = time.perf_counter() - t_part
    log(f"[mesh] durable, sharded: the butterfly doubling of channel 0 "
        f"({nb} -> {2 * nb}) in {resize_s:.4f} s equals the one-device "
        f"butterfly of the same table ({one_resize_s:.4f} s); recover_shard "
        f"of shard 1 onto {mesh.devices[0][1]} equals it onto {first} and "
        f"the live shard, crossing the re-anchor (s: {recs}); verify_all "
        f"passes")

    # (c) One block a channel of the Fabric 1.2 step on the same mesh
    # (the whole wire in consensus, sequential commit: K3), against the
    # one-device step.
    t_part = time.perf_counter()
    maker = engine.FabricEngine(dataclasses.replace(
        cfg, n_buckets=1 << 10, store_blocks=False), device=first)
    blocks = []
    for c in range(nch):
        txb = endorser.execute_and_endorse(
            maker.endorser_state, maker.make_proposals(
                bsz, seed=SEEDS[0] * 100 + c, n_accounts=n_accounts), dims)
        blocks.append((unmarshal.marshal(txb, dims), txb.tx_id))
    wire = torch.stack([w for w, _ in blocks])
    ids = torch.stack([i for _, i in blocks])
    v12 = fs.FABRIC_V12_STEP
    # The one-device step on the CPU (the plain versions): its serial log
    # chain takes seconds a block on the card.
    one = fs.make_fabric_step(dims, v12, n_shards=m)
    st1, valid1 = one(fs.create_mesh_state(nch, dims, cfg.n_buckets,
                                           cfg.slots, device="cpu"),
                      wire.cpu(), ids.cpu())
    over = nch % mesh.dp_size == 0
    ms = fs.create_mesh_state(nch, dims, cfg.n_buckets, cfg.slots,
                              mesh=mesh, channels_over_data=over)
    zero_counts()
    mesh.moved.clear()
    t1 = time.perf_counter()
    ms, valid2 = fs.make_fabric_step(dims, v12, mesh=mesh,
                                     channels_over_data=over)(ms, wire, ids)
    sync()
    v12_s = time.perf_counter() - t1
    c_loc = nch // mesh.dp_size if over else nch
    want = {k: {} for k in ("mac_many", "lookup", "commit", "validate")}
    for row in mesh.devices:
        for dev in row:
            for k, n in (("mac_many", 1), ("lookup", c_loc),
                         ("commit", c_loc), ("validate", 1)):
                want[k][str(dev)] = want[k].get(str(dev), 0) + n
    v12_launches = check_launches("mesh_fabric12", want)
    gathered = fs.gather_state(ms, "cpu")
    if not torch.equal(valid1, valid2.cpu()) or not all(
            torch.equal(x, y) for x, y in zip(st1, gathered)):
        raise AssertionError("the Fabric 1.2 step on the mesh differs from "
                             "the one-device step")
    ff = fs.consensus_bytes(dims, fs.FASTFABRIC_STEP, bsz, m)
    f12 = mesh.moved["consensus"] / nch
    if f12 != fs.consensus_bytes(dims, v12, bsz, m):
        raise AssertionError(f"Fabric 1.2 consensus bytes a block {f12}")
    out["fabric12"] = {"step_s": v12_s, "launches_by_device": v12_launches,
                       "consensus_bytes_a_block": f12,
                       "valid": int(valid2.sum())}
    out["consensus_bytes_a_block"] = {
        "fastfabric": ff, "fabric12": f12, "ratio": f12 / ff,
        "published_words_a_tx": {
            "fastfabric": unmarshal.struct_prefix_words(dims),
            "fabric12": dims.payload_words}}
    parts_s["fabric12"] = time.perf_counter() - t_part
    log(f"[mesh] Fabric 1.2 step, one block a channel: state and validity "
        f"equal the one-device step's on the CPU ({v12_s:.3f} s on the "
        f"mesh); launches by device {v12_launches}")
    log(f"[mesh] consensus bytes a block between the {m} model ranks of a "
        f"row: FASTFABRIC {ff} ({unmarshal.struct_prefix_words(dims)} words "
        f"a tx) / Fabric 1.2 {f12:.0f} ({dims.payload_words} words a tx) = "
        f"1 / {f12 / ff:.2f}")
    del ms, st1, gathered, maker
    out["parts_s"] = parts_s
    log(f"[mesh] seconds by part: {parts_s}")
    return out


def contract_launches(mesh, depth: int, n_channels: int) -> dict:
    """K1, K2 and K4 launches by device of one call of a fabric step
    program over ``mesh``: at every rank once K1 on its rows, twice K2 a
    channel (the read or fill, and the commit's probe), once K4 a block
    position."""
    import collections
    out = {k: collections.Counter() for k in ("mac_many", "lookup",
                                              "validate")}
    for row in mesh.devices:
        for dev in row:
            out["mac_many"][str(dev)] += 1
            out["lookup"][str(dev)] += 2 * n_channels
            out["validate"][str(dev)] += depth
    return {k: dict(v) for k, v in out.items()}


def contracts_phase(mesh, zero_counts, path_launches, *, card: str = ""
                    ) -> dict:
    """Phase 23: the contract gate's seven programs (repro_torch.analysis)
    over ``mesh``, each a warm-up call and a call recorded under the
    dispatch mode (and, on a card, ``set_sync_debug_mode("error")``), held
    against ``contracts.json``; K1, K2 and K4 launches by device of each
    fabric step's recorded call as ``contract_launches`` reckons them, and
    none in the others; a seeded ``.item()`` in a wrapped step caught as a
    host sync; the retrace workload and the lint. A rehearsal on the CPU
    passes a mesh of CPU positions."""
    from repro_torch.analysis import checks, contracts, gate, registry
    from repro_torch.core import types
    t0 = time.perf_counter()
    ctx = gate.build_context(mesh)
    out = {"card": card, "mesh": [[str(x) for x in r] for r in mesh.devices],
           "distinct_devices": len(mesh.distinct()), "programs": {}}
    viols = []
    for name, reg in registry.discover().items():
        built = reg.builder(ctx)
        measured, v = gate.check_program(built, contracts.for_program(name),
                                         on_record=zero_counts)
        got = {k: {d: n for d, n in c.items() if n}
               for k, c in launches_by_device().items()}
        if name.startswith("fabric_step/"):
            want = contract_launches(mesh, built.meta["depth"],
                                     built.meta["n_channels"])
            path_launches[f"contracts {name}"] = launch_counts()
        else:
            want = {}
        for k in ("mac_many", "lookup", "commit", "validate"):
            if got.get(k, {}) != want.get(k, {}):
                raise AssertionError(f"[contracts] {name}: {k} launches by "
                                     f"device {got.get(k)}, expected "
                                     f"{want.get(k)}")
        row = {**checks.summary(measured), "seconds": measured["seconds"],
               "launches_by_device": {k: c for k, c in got.items() if c},
               "violations": [str(x) for x in v]}
        out["programs"][name] = row
        viols += v
        log(gate.report_line(name, {"measured": row, "violations": v}))
    # A seeded .item() in a wrapped step is caught as a host sync (on a
    # card by the sync debug mode, which raises inside the call).
    built = registry.get("fabric_step/shard/d1").builder(ctx)
    step = built.fn

    def seeded(st, wire, ids):
        res = step(st, wire, ids)
        res[1].any().item()
        return res

    built.fn = seeded
    syncs = checks.run_program(built)["host_syncs"]
    cuda = mesh.first.type == "cuda"
    if not syncs or (cuda and not any(x.startswith("cuda:") for x in syncs)):
        raise AssertionError(f"[contracts] a seeded .item() in a step went "
                             f"unseen: {syncs}")
    out["seeded_item"] = syncs
    auditor = gate.run_retrace(mesh, types.TEST_DIMS)
    out["retrace"] = auditor.report()
    viols += auditor.violations
    lint_viols = gate.run_lint()
    out["lint"] = len(lint_viols)
    viols += lint_viols
    out["seconds"] = time.perf_counter() - t0
    log(f"[contracts] seeded .item(): {syncs[-1]}; retrace "
        + ", ".join(f"{k} calls={r['calls']} traces={r['traces']}"
                    for k, r in out["retrace"].items())
        + f"; lint {len(lint_viols)}; {out['seconds']:.1f} s on "
        f"{out['distinct_devices']} distinct device(s)")
    if viols:
        raise AssertionError("[contracts] " + "; ".join(map(str, viols)))
    if cuda and out["seconds"] > CONTRACT_PHASE_S:
        raise AssertionError(f"[contracts] phase 23 took "
                             f"{out['seconds']:.1f} s, more than "
                             f"{CONTRACT_PHASE_S} s")
    return out


def k4_blocks(dev, k4_txs: tuple = None) -> list:
    """K4 over NB = 1, 2, 4 and 8 independent blocks in one call, blocks of
    ``k4_txs`` txs (one CTA a block at 100, tiled at 1,024), against its
    plain version; on the card the wrapper's time (CUDA events), the
    device time (profiler), the plain version's and the bound, beside NB
    times the NB = 1 time. Phase 3 runs it: the profiler's device times
    read low or zero later in the run (after the profiled rounds of phases
    6 and 13), while phase 3's agree with the earlier calls'."""
    from repro_torch.core import u32
    from repro_torch.kernels.mvcc_validate import cases as mv_cases
    from repro_torch.kernels.mvcc_validate import ops as mv_ops
    from repro_torch.kernels.mvcc_validate import ref as mv_ref
    cuda = torch.device(dev).type == "cuda"
    rows = []
    for b in k4_txs or K4_NB_TXS:
        base = {}
        for nblk in K4_NBS:
            blocks = [mv_cases.random_block(b, 50 * nblk + k,
                                            n_accounts=max(48, b * 2 // 5))
                      for k in range(nblk)]
            ins = [u32.from_numpy(a, dev) if a.dtype != np.bool_
                   else torch.from_numpy(a).to(dev)
                   for a in (np.stack(x) for x in zip(*blocks))]
            want = mv_ref.validate_blocks_ref(*(t.cpu() for t in ins))
            err = max_abs_err([mv_ops.validate_blocks(*ins).cpu()], [want])
            if err:
                raise AssertionError(f"validate_blocks NB={nblk} B={b}: "
                                     f"differs from the plain version")
            row = {"txs": b, "nb": nblk, "max_abs_err": err,
                   "route": mv_ops.route_for(b, 2, 2, dev) if cuda
                   else "plain"}
            rows.append(row)
            if not cuda:
                continue
            fn = lambda ins=ins: mv_ops.validate_blocks(*ins)
            row["ms"] = event_ms(fn, 200)
            row["device_ms"] = device_call_ms(fn, ("mvcc_",))
            row["plain_ms"] = event_ms(
                lambda ins=ins: mv_ref.validate_blocks_ref(*ins), 1, warmup=0)
            # Each block's keys, versions and flags read once and verdicts
            # written; the compares each tx's keys need against the valid
            # txs before it (RK = WK = 2).
            v = want.long()
            row["bound_ms"], row["bound_by"] = bound_ms(
                nblk * (4 * b * 12 + 2 * b),
                8 * int((torch.cumsum(v, 1) - v).sum()))
            if nblk == 1:
                base = row
            row["nb_x_one_ms"] = nblk * base["ms"]
            row["nb_x_one_device_ms"] = nblk * base["device_ms"]
            log(f"[time] K4 validate_blocks, NB = {nblk} blocks of {b} "
                f"({row['route']}, {1 if row['route'] == 'cta' else 2} "
                f"launches): {row['ms']:.6f} ms a call (NB x NB = 1: "
                f"{row['nb_x_one_ms']:.6f}), device {row['device_ms']:.8f} ms "
                f"(NB x NB = 1: {row['nb_x_one_device_ms']:.8f}), bound "
                f"{row['bound_ms']:.9f} ms ({row['bound_by']}), plain "
                f"{row['plain_ms']:.3f} ms; equal to the plain version")
    return rows


def _profile_window(e, sync, n_accounts, round_txs) -> dict:
    """One more round of ``e``, its first window under the profiler: the
    window's host time and the device's busy time inside it."""
    from torch.profiler import ProfilerActivity, profile
    wc = e.window_committer
    real = wc.commit_window
    got = {}

    def profiled(wire, ids):
        if got:
            return real(wire, ids)
        sync()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = real(wire, ids)
            sync()
        wall = time.perf_counter() - t0
        ev = _device_events(prof)
        busy = sum(x.self_device_time_total for x in ev) / 1e6
        got.update(blocks=int(wire.shape[0]), wall_s=wall, device_busy_s=busy,
                   busy_share=busy / wall, device_ops=sum(x.count
                                                          for x in ev))
        top = sorted(ev, key=lambda x: -x.self_device_time_total)[:5]
        got["top"] = [(x.key[:60], x.self_device_time_total / 1e3, x.count)
                      for x in top]
        return res

    wc.commit_window = profiled
    e.run_round(e.make_proposals(round_txs, seed=2, n_accounts=n_accounts))
    log(f"[pipeline] profiled window of {got['blocks']} blocks: "
        f"{got['wall_s']:.4f} s under the profiler, device busy "
        f"{got['device_busy_s']:.4f} s ({got['busy_share'] * 100:.2f} %) "
        f"over {got['device_ops']} device ops; top {got['top']}")
    return got


def device_split_ms(fn, groups: tuple, iters: int = 50) -> dict:
    """Device time a call of ``fn`` spends in the CUDA kernels whose names
    contain each of ``groups``, over ``iters`` calls of one profiled run."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = _device_events(prof)
    return {g: sum(ev.self_device_time_total for ev in evs if g in ev.key)
            / iters / 1e3 for g in groups}


def flash_bwd_timing(dev) -> dict:
    """Phase 3's timing of K5's backward (a ``timing`` entry): at each of
    FLASH_BWD_TIMED, in turns with SDPA's backward; the entry's own numbers
    are the first shape's, the training shape."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    # K5's backward beside its bound (``flash_bwd_work``) and SDPA's
    # backward (fwd+bwd - fwd), in turns: K5, SDPA fwd+bwd, SDPA fwd,
    # twice; the device time split over the three kernels.
    mean = lambda xs: sum(xs) / len(xs)
    t, turns = None, []
    for i, (bb, bs, bskv, bh, bkv, bd, causal) in enumerate(
            FLASH_BWD_TIMED):
        g_ = torch.Generator(device=dev).manual_seed(400 + i)
        bq, bk_, bv, bdo = (torch.randn((bb, n_s, n, bd), generator=g_,
                                        device=dev).bfloat16()
                            for n_s, n in ((bs, bh), (bskv, bkv),
                                           (bskv, bkv), (bs, bh)))
        bo, blse = fa_ops._forward(bq, bk_, bv, causal, with_lse=True)
        k5_bwd = lambda: fa_ops.flash_attention_bwd(
            bq, bk_, bv, bo, bdo, blse, causal=causal)
        bbytes, bflop = flash_bwd_work(bb, bs, bskv, bh, bkv, bd, causal)
        bq_t, bk_t, bv_t = (x.transpose(1, 2).contiguous().requires_grad_()
                            for x in (bq, bk_, bv))
        bdo_t = bdo.transpose(1, 2).contiguous()
        sdpa_f = lambda: F.scaled_dot_product_attention(
            bq_t, bk_t, bv_t, is_causal=causal, enable_gqa=True)
        sdpa_fb = lambda: torch.autograd.grad(sdpa_f(), (bq_t, bk_t, bv_t),
                                              bdo_t)
        ev = {"k5": [], "sdpa_fwd_bwd": [], "sdpa_fwd": []}
        for _ in range(2):
            ev["k5"].append(event_ms(k5_bwd, 100))
            ev["sdpa_fwd_bwd"].append(event_ms(sdpa_fb, 100))
            ev["sdpa_fwd"].append(event_ms(sdpa_f, 100))
        split = device_split_ms(k5_bwd, ("flash_bwd_dq", "flash_bwd_dkdv",
                                         "flash_bwd_delta"))
        bdev = device_call_ms(k5_bwd, ("flash_bwd",)) or float("nan")
        lib_dev = device_total_ms(sdpa_fb) - device_total_ms(sdpa_f)
        lib_ms = mean(ev["sdpa_fwd_bwd"]) - mean(ev["sdpa_fwd"])
        bound = bound_ms(bbytes, bflop, TC_BF16_OPS_PER_S)
        plain = event_ms(lambda: fa_ref.flash_attention_bwd_ref(
            bq, bk_, bv, bo, bdo, blse, causal), 3, warmup=1)
        shape = (bb, bs, bskv, bh, bkv, bd)
        turn = {"shape": shape, "causal": causal, "events_ms": ev,
                "device_ms": bdev, "plain_ms": plain,
                "device_split_ms": split, "bound_ms": bound[0],
                "sdpa_bwd_ms": lib_ms, "sdpa_bwd_device_ms": lib_dev,
                "tflops": bflop / bdev / 1e9, "flop": bflop}
        turns.append(turn)
        log(f"[time] flash_attention_bwd ((B, S, Skv, H, Hkv, D) = {shape} "
            f"bf16, causal={causal}): {mean(ev['k5']):.5f} ms a call "
            f"(events, turns "
            f"{ev['k5']}), device {bdev:.5f} ms ({bflop / bdev / 1e9:.1f} "
            f"TFLOP/s, {bound[0] / bdev * 100:.2f} % of its {bound[0]:.7f} "
            f"ms bound, {bound[1]}: {bflop / 1e9:.1f} GFLOP; dQ "
            f"{split['flash_bwd_dq']:.5f}, dK/dV "
            f"{split['flash_bwd_dkdv']:.5f}, delta "
            f"{split['flash_bwd_delta']:.5f} ms); SDPA's backward (fwd+bwd "
            f"- fwd) {lib_ms:.5f} ms (turns {ev['sdpa_fwd_bwd']} - "
            f"{ev['sdpa_fwd']}), device {lib_dev:.5f} ms; K5 / SDPA "
            f"{mean(ev['k5']) / lib_ms:.3f} (events), {bdev / lib_dev:.3f} "
            f"(device); plain {plain:.3f} ms")
        if i == 0:
            t = dict(
                name="flash_attention_bwd", kernel="flash_bwd",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="none (no Pallas entry: the JAX package "
                         "differentiates attn_naive, "
                         "src/repro/models/layers.py:172)",
                ms=mean(ev["k5"]), plain_ms=plain, library_ms=lib_ms,
                device_ms=bdev, bound=bound,
                shape=f"(B, S, Skv, H, Hkv, D) = {shape} bf16, causal")
        del bq, bk_, bv, bdo, bo, blse, bq_t, bk_t, bv_t, bdo_t, k5_bwd
        del sdpa_f, sdpa_fb
        torch.cuda.empty_cache()
    t["turns"] = turns
    return t


def _state_to_host(state) -> list:
    """Every leaf of a TrainState, copied to the host."""
    from repro_torch.training import train_step as ts_lib
    return [t.detach().to("cpu", copy=True)
            for group in ts_lib.state_leaves(state) for t in group]


def _same_state(state, host: list) -> bool:
    """A TrainState equal bit for bit to a host copy (``_state_to_host``)."""
    from repro_torch.training import train_step as ts_lib
    leaves = [t for group in ts_lib.state_leaves(state) for t in group]
    return len(leaves) == len(host) and all(
        torch.equal(t.detach().cpu(), h) for t, h in zip(leaves, host))


def flash_bwd_checks(dev, cases=FLASH_BWD_CASES) -> dict:
    """Phase 16 (d): K5's backward (``ops.flash_attention_bwd``, dQ, dK, dV
    from the kernel's own forward O and LSE) against the plain backward on
    the inputs cast to f32, with each dtype's limit from ``ref.py``; the
    forward's LSE against the plain version's; O with the LSE asked for
    equal bit for bit to O without it (serving's null pointer)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    out = {"max_abs_err": 0.0, "lse_max_abs_err": 0.0, "cases": []}
    for i, (shape, dtype, causal) in enumerate(cases):
        b_, s_, skv_, h_, kv_, d_ = shape
        g_ = torch.Generator(device=dev).manual_seed(300 + i)
        q, k, v, do = (torch.randn((b_, n_s, n, d_), generator=g_,
                                   device=dev).to(getattr(torch, dtype))
                       for n_s, n in ((s_, h_), (skv_, kv_), (skv_, kv_),
                                      (s_, h_)))
        o, lse = fa_ops._forward(q, k, v, causal, with_lse=True)
        o_plain = fa_ops._forward(q, k, v, causal, with_lse=False)[0]
        if not torch.equal(o, o_plain):
            raise AssertionError(f"K5's O at {shape} {dtype} changes when "
                                 f"the LSE is written")
        got = fa_ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
        qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
        o_ref, lse_ref = fa_ref.flash_attention_lse_ref(qf, kf, vf,
                                                        causal=causal)
        want = fa_ref.flash_attention_bwd_ref(qf, kf, vf, o_ref, dof,
                                              lse_ref, causal)
        atol, rtol = ((fa_ref.BWD_F32_TOL, fa_ref.BWD_F32_TOL)
                      if dtype == "float32"
                      else (fa_ref.BWD_BF16_ATOL, fa_ref.BWD_BF16_RTOL))
        lse_err = float((lse - lse_ref).abs().max())
        if lse_err > fa_ref.LSE_TOL * (1 + float(lse_ref.abs().max())):
            raise AssertionError(f"K5's LSE at {shape} {dtype}: "
                                 f"max_abs_err {lse_err}")
        row = {"shape": shape, "dtype": dtype, "causal": causal,
               "lse_max_abs_err": lse_err}
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            e = (a.float() - w).abs()
            row[name] = float(e.max())
            row[name + "_ratio"] = float((e / (atol + rtol * w.abs())).max())
            if not torch.allclose(a.float(), w, atol=atol, rtol=rtol):
                raise AssertionError(f"K5's backward {name} at {shape} "
                                     f"{dtype} causal={causal} disagrees "
                                     f"with its plain version: {row}")
        out["max_abs_err"] = max(out["max_abs_err"], row["dq"], row["dk"],
                                 row["dv"])
        out["lse_max_abs_err"] = max(out["lse_max_abs_err"], lse_err)
        out["cases"].append(row)
        share = max(row["dq_ratio"], row["dk_ratio"], row["dv_ratio"])
        log(f"[train-check] K5 backward {shape} {dtype} causal={causal}: "
            f"dq {row['dq']:.3e} dk {row['dk']:.3e} dv {row['dv']:.3e} "
            f"(worst share of the limit {share:.3f}; atol {atol}, rtol "
            f"{rtol}); LSE {lse_err:.3e}; O unchanged")
        del q, k, v, do, o, o_plain, lse, got, qf, kf, vf, dof, o_ref
        del lse_ref, want
    return out


def _words_sum(tensors, chunk: int = 1 << 26) -> torch.Tensor:
    """The sum of every tensor's raw 16- or 32-bit words as int64 (in
    slices of ``chunk`` words), one entry a tensor, on their device: a step
    that changes any element changes its entry (barring an exact
    cancellation)."""
    out = []
    for t in tensors:
        t = t.detach()
        words = t.view(torch.int16 if t.element_size() == 2
                       else torch.int32).reshape(-1)
        out.append(torch.stack([
            words[i:i + chunk].sum(dtype=torch.int64)
            for i in range(0, words.numel(), chunk)]).sum())
    return torch.stack(out)


def _jax_order_flags(params, flags) -> list:
    """Per-tensor flags (in ``tree_leaves`` order) gathered per JAX leaf
    (all of its layers' flags true), in the JAX flatten order."""
    from repro_torch.models.lm import jax_leaves, tree_leaves
    pos = {id(t): i for i, t in enumerate(tree_leaves(params))}
    flags = flags.cpu().tolist()
    return [all(flags[pos[id(t)]] for t in group)
            for group in jax_leaves(params)]


def _drop_recorder(real, sink):
    """``moe_mlp`` that records each call's routed and dropped assignments
    (a dict of its own) into the list ``sink()`` returns."""
    def call(*a, **kw):
        st = {}
        out = real(*a, **kw, stats=st)
        sink().append(st)
        return out
    return call


def _drop_shares(calls: list, n_layers: int) -> dict:
    """Routed and dropped assignments over ``moe_mlp`` calls recorded in
    layer order (call i at layer i % ``n_layers``): the totals, the share
    dropped and each layer's share."""
    a = [c["assignments"] for c in calls]
    d = [int(c["dropped"]) for c in calls]
    return {"assignments": sum(a), "dropped": sum(d),
            "share": sum(d) / sum(a) if a else None,
            "per_layer": [sum(d[i::n_layers]) / sum(a[i::n_layers])
                          for i in range(min(n_layers, len(a)))]}


def _alloc_counts(cuda: bool) -> tuple:
    """The caching allocator's device allocations (cudaMalloc) and its
    retries after freeing its cache, so far."""
    if not cuda:
        return 0, 0
    st = torch.cuda.memory_stats()
    return st.get("num_device_alloc", 0), st.get("num_alloc_retries", 0)


def _train_full_width(dev, arch, layers, enc_layers, counts, zero_counts,
                      path_launches, *, key, tag, seed, seq, batch, steps,
                      smoke=False) -> dict:
    """Phases 16 (a) and 21 (a): ``arch`` at full width (the smoke config
    with ``smoke``), bf16, cut to ``layers`` (+ ``enc_layers``) layers,
    built by ``launch.train.build`` with the port's pipeline. MoE: an
    untimed forward of the first batch counts each layer's routed and
    dropped assignments. Then a warm-up step, ``steps`` timed steps and a
    profiled one, every step under a recorder of each gradient leaf's
    finiteness (a wrapper of ``train_step.value_and_grad``), with the
    allocator's device allocations and retries and the garbage
    collector's pauses counted a step. Every step's ``skipped`` equals
    "some gradient or the loss non-finite"; a skipped step leaves params
    and moments as they were (their words' sums each step; bit for bit
    against a host copy when every step skipped); dense, moe and encdec:
    every loss finite, every microbatch endorsed. K5's forward and
    backward launched ``lm.attention_calls`` times a timed step (counters
    set to 0 before the timed steps, read after, into
    ``path_launches[key]``). Then a second run of 2 steps from the same
    seed, equal bit for bit to the first run's state after 2."""
    import gc
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import pipeline
    from repro_torch.launch import train
    from repro_torch.models import moe
    from repro_torch.models.lm import (LM, _jax_paths, attention_calls,
                                       tree_leaves)
    from repro_torch.training import train_step as ts_lib
    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg, built, tcfg, dcfg = train.build(arch, smoke=smoke, seq=seq,
                                         batch=batch, microbatches=1,
                                         lr=1e-3, total_steps=100,
                                         device=dev)
    cut = dict(n_layers=layers, dtype="bfloat16")
    if cfg.family == "encdec":
        cut["enc_layers"] = enc_layers
    cfg = dataclasses.replace(cfg, **cut)

    def fresh():
        model = LM(cfg, vocab_chunk=built.vocab_chunk,
                   moe_capacity_factor=built.moe_cf, device=dev)
        state = ts_lib.init_state(model, torch.Generator(dev).manual_seed(
            seed))
        return model, state, ts_lib.make_train_step(model, tcfg)

    t1 = time.perf_counter()
    model, state, step_fn = fresh()
    sync()
    init_s = time.perf_counter() - t1
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    batches = [train.device_batch(pipeline.global_batch_for_step(dcfg, i),
                                  dev) for i in range(steps + 2)]
    per_step = attention_calls(cfg)
    names = ["/".join(p) for p in _jax_paths(state.params)]
    kept = [t for g in ts_lib.state_leaves(state)[:-1] for t in g]
    kept = [t for t in kept if t.is_floating_point()]  # params, m, v
    drops = None
    if cfg.family == "moe":  # the warm-up step's forward, untimed
        calls, real_moe = [], moe.moe_mlp
        moe.moe_mlp = _drop_recorder(real_moe, lambda: calls)
        try:
            with torch.no_grad():
                model.loss(batches[0])
        finally:
            moe.moe_mlp = real_moe
        drops = _drop_shares(calls, cfg.n_layers)
        del calls
    records = []
    real_vg = ts_lib.value_and_grad

    def recording_vg(model_, params, batch_):
        loss, metrics, grads = real_vg(model_, params, batch_)
        fin = torch.stack([torch.isfinite(g).all() for g in grads])
        records.append((torch.isfinite(loss), fin))
        return loss, metrics, grads

    gc_pause, gc_at = [0.0], [0.0]

    def gc_timer(phase, info):
        if phase == "start":
            gc_at[0] = time.perf_counter()
        else:
            gc_pause[0] += time.perf_counter() - gc_at[0]

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    rows, step_s, host, after2 = [], [], None, None
    gc.collect()
    gc.callbacks.append(gc_timer)
    ts_lib.value_and_grad = recording_vg
    try:
        for i in range(steps + 2):  # warm-up, timed steps, profiled step
            if i == 1:
                sync()
                zero_counts()
            before = _words_sum(kept)
            if i == steps + 1:
                got = counts()
                prof = profile(activities=[ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if cuda else []))
                prof.__enter__()
            allocs, gc_pause[0] = _alloc_counts(cuda), 0.0
            t1 = time.perf_counter()
            state, m = step_fn(state, batches[i])
            sync()
            dt = time.perf_counter() - t1
            allocs = [b - a for a, b in zip(allocs, _alloc_counts(cuda))]
            if i == steps + 1:
                prof.__exit__(None, None, None)
                wall = dt
            elif i:
                step_s.append(dt)
            loss_ok, fin = records[-1]
            grads_ok = bool(fin.all())
            skipped = int(m["skipped"])
            same = bool(torch.equal(before, _words_sum(kept)))
            row = {"loss": float(m["loss"]), "skipped": skipped,
                   "endorsed_mb": float(m["endorsed_mb"]),
                   "loss_finite": bool(loss_ok), "grads_finite": grads_ok,
                   "nonfinite_leaves": [n for n, ok in zip(
                       names, _jax_order_flags(state.params, fin)) if not ok],
                   "state_unchanged": same, "ms": dt * 1e3,
                   "device_allocs": allocs[0], "alloc_retries": allocs[1],
                   "gc_ms": gc_pause[0] * 1e3}
            rows.append(row)
            if skipped != int(not (grads_ok and bool(loss_ok))):
                raise AssertionError(f"{arch} step {i}: skipped {skipped}, "
                                     f"but loss finite {bool(loss_ok)} and "
                                     f"gradients finite {grads_ok}")
            if skipped and not same:
                raise AssertionError(f"{arch} step {i} skipped but changed "
                                     f"params or moments")
            if cfg.family in ("dense", "moe", "encdec") and not (
                    math.isfinite(row["loss"]) and not skipped
                    and row["endorsed_mb"] == tcfg.microbatches):
                raise AssertionError(f"{arch} step {i}: {row}")
            if i == 0 and skipped:  # the fresh draw, kept as it was
                host = [t.detach().to("cpu", copy=True) for t in kept]
            if i == 1:
                after2 = _state_to_host(state)
    finally:
        ts_lib.value_and_grad = real_vg
        gc.callbacks.remove(gc_timer)
    if all(r["skipped"] for r in rows):
        # Every step skipped, the warm-up too: params and moments are still
        # the fresh draw, bit for bit.
        if not all(torch.equal(t.detach().cpu(), h)
                   for t, h in zip(kept, host)):
            raise AssertionError(f"{arch}: skipped steps changed the state")
    del host
    path_launches[key] = got
    if (got["flash_attention"] != per_step * steps
            or got["flash_attention_bwd"] != per_step * steps):
        raise AssertionError(f"{arch} training: K5 launches {got}, want "
                             f"{per_step} forward and backward a step")
    peak = torch.cuda.max_memory_allocated() if cuda else None
    evs = _device_events(prof)
    busy = sum(ev.self_device_time_total for ev in evs) / 1e6
    k5 = sum(ev.self_device_time_total for ev in evs
             if "flash_" in ev.key) / 1e6
    k5_bwd = sum(ev.self_device_time_total for ev in evs
                 if "flash_bwd" in ev.key) / 1e6
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:6]
    med = sorted(step_s)[len(step_s) // 2]
    tokens = batch * seq
    endorsed = sum(1 for r in rows if not r["skipped"])
    out = {"config": cfg.name, "family": cfg.family, "layers": layers,
           "enc_layers": cfg.enc_layers, "dtype": cfg.dtype,
           "params": n_params, "init_s": init_s, "seq": seq, "batch": batch,
           "enc_len": seq // dcfg.enc_frac if dcfg.enc_frac else 0,
           "tokens_per_step": tokens, "steps": rows, "step_s": step_s,
           "median_step_ms": med * 1e3,
           "tokens_per_s": tokens * len(step_s) / sum(step_s),
           "peak_bytes": peak, "launches": got, "k5_per_step": per_step,
           "endorsed_share": endorsed / len(rows), "moe_drops": drops,
           "profiled_step": {
               "wall_s": wall, "device_busy_s": busy,
               "busy_share": busy / wall, "busy_of_median": busy / med,
               "k5_s": k5, "k5_bwd_s": k5_bwd,
               "device_ops": sum(e.count for e in evs),
               "top": [(e.key[:70], e.self_device_time_total / 1e3, e.count)
                       for e in top]}}
    enc = (f" + {cfg.enc_layers} encoder layers over {batch} x "
           f"{out['enc_len']} frames" if cfg.enc_layers else "")
    log(f"[{tag}] {cfg.name} at {layers} layers{enc}, {n_params} "
        f"parameters (drawn in {init_s:.2f} s), bf16, batch {batch} x "
        f"{seq}: losses {[round(r['loss'], 4) for r in rows]}; steps "
        f"{[round(x * 1e3, 3) for x in step_s]} ms, median {med * 1e3:.3f} "
        f"ms, {out['tokens_per_s']:.1f} tokens/s; peak device memory "
        f"{(peak or 0) / 2**30:.3f} GiB; K5 {got['flash_attention']} "
        f"forward, {got['flash_attention_bwd']} backward launches over "
        f"{steps} steps ({per_step} a step); endorsed {endorsed} of "
        f"{len(rows)} steps")
    log(f"[{tag}] {cfg.name} each step (warm-up, timed, profiled): ms "
        f"{[round(r['ms'], 3) for r in rows]}; device allocations "
        f"{[r['device_allocs'] for r in rows]}; allocator retries "
        f"{[r['alloc_retries'] for r in rows]}; garbage-collector pauses ms "
        f"{[round(r['gc_ms'], 3) for r in rows]}")
    if drops:
        log(f"[{tag}] {cfg.name}: the first batch's forward dropped "
            f"{drops['share'] * 100:.3f} % of {drops['assignments']} routed "
            f"assignments; by layer "
            f"{[round(x * 100, 3) for x in drops['per_layer']]} %")
    if endorsed < len(rows):
        log(f"[{tag}] {cfg.name}: skipped steps' non-finite leaves "
            f"{rows[0]['nonfinite_leaves']} (loss finite "
            f"{rows[0]['loss_finite']}); params and moments unchanged")
    log(f"[{tag}] {cfg.name} profiled step: {wall:.4f} s, device busy "
        f"{busy:.4f} s ({busy / wall * 100:.2f} % of it, "
        f"{busy / med * 100:.2f} % of the median step) over "
        f"{out['profiled_step']['device_ops']} device ops; K5 "
        f"{k5 * 1e3:.4f} ms of it (backward {k5_bwd * 1e3:.4f})")
    for e in top:
        log(f"[{tag}]   {e.self_device_time_total / 1e3:10.3f} ms "
            f"{e.count:6d}x {e.key[:90]}")
    del state, step_fn, model, kept, records, prof, evs, top
    if cuda:
        torch.cuda.empty_cache()
    # The same seed again, 2 steps: bit for bit the first run's.
    model, state, step_fn = fresh()
    for i in range(2):
        state, _ = step_fn(state, batches[i])
    sync()
    out["repeat_identical"] = _same_state(state, after2)
    log(f"[{tag}] {cfg.name}: a second run of 2 steps from the same seed "
        f"bit-identical {out['repeat_identical']}")
    if not out["repeat_identical"]:
        raise AssertionError(f"{arch}: a second run of 2 steps from the "
                             f"same seed differs")
    del model, state, step_fn, after2, batches
    if cuda:
        torch.cuda.empty_cache()
    return out


def _grads_card_vs_cpu(dev, arch, counts, zero_counts, *, seed, seq,
                       smoke=False, cut=None, tag: str) -> dict:
    """Phases 16 (b) and 21 (b): ``arch`` (its smoke config with
    ``smoke``) as ``launch.train.build`` makes it, with ``cut`` applied,
    f32, drawn on ``dev`` from ``seed`` and copied to the CPU; one loss and
    gradient of the pipeline's batch 1 x ``seq`` on each (TF32 off): the
    same set of non-finite leaves, the finite ones within GRAD_TOL of each
    leaf's largest magnitude on the CPU, the loss (and, every leaf finite,
    the gradient norm) within TRAIN_LOSS_TOL; on the card K5 forward and
    backward ``lm.attention_calls`` times."""
    from repro_torch.data import pipeline
    from repro_torch.launch import train
    from repro_torch.models.lm import (LM, _jax_paths, attention_calls,
                                       jax_leaves, map_tree, tree_leaves,
                                       tree_unflatten)
    from repro_torch.training import optimizer
    from repro_torch.training import train_step as ts_lib
    cuda = torch.device(dev).type == "cuda"
    cfg, built, _, dcfg = train.build(arch, smoke=smoke, seq=seq, batch=1,
                                      microbatches=1, lr=1e-3,
                                      total_steps=100, device=dev)
    cfg = dataclasses.replace(cfg, dtype="float32", **(cut or {}))
    batch = pipeline.global_batch_for_step(dcfg, 0)
    kw = dict(vocab_chunk=built.vocab_chunk, moe_capacity_factor=built.moe_cf)
    model_g = LM(cfg, device=dev, **kw).init(
        torch.Generator(dev).manual_seed(seed))
    model_c = LM(cfg, device="cpu", **kw).load_params(
        map_tree(lambda t: t.detach().cpu(), model_g.params.tree()))
    names = ["/".join(p) for p in _jax_paths(model_c.params.tree())]
    res = {}
    for where, model, d_ in (("card", model_g, dev), ("cpu", model_c, "cpu")):
        model.params.requires_grad_(True)
        params = tree_leaves(model.params.tree())
        zero_counts()
        loss, _, grads = ts_lib.value_and_grad(
            model, params, train.device_batch(batch, d_))
        tree = tree_unflatten(model.params.tree(), grads)
        res[where] = (float(loss), float(optimizer.global_norm(grads)),
                      [[g.detach().cpu() for g in group]
                       for group in jax_leaves(tree)], counts())
    (lg, ng, gg, cg), (lc, nc, gc, _) = res["card"], res["cpu"]
    bad = {w: [n for n, group in zip(names, g)
               if not all(bool(torch.isfinite(x).all()) for x in group)]
           for w, g in (("card", gg), ("cpu", gc))}
    worst = 0.0
    for n, grp_g, grp_c in zip(names, gg, gc):
        if n in bad["cpu"]:
            continue
        for a, w in zip(grp_g, grp_c):
            scale = float(w.abs().max()) or 1.0
            worst = max(worst, float((a - w).abs().max()) / scale)
    per_step = attention_calls(cfg)
    out = {"config": cfg.name, "layers": cfg.n_layers,
           "enc_layers": cfg.enc_layers, "seq": seq, "loss": (lg, lc),
           "grad_norm": (ng, nc), "nonfinite": bad["cpu"],
           "leaves": len(names), "worst_grad_share": worst,
           "grad_tol": GRAD_TOL, "loss_tol": TRAIN_LOSS_TOL, "launches": cg}
    log(f"[{tag}] {cfg.name} at {cfg.n_layers} layers"
        f"{f' + {cfg.enc_layers}' if cfg.enc_layers else ''}, f32, batch 1 "
        f"x {seq}: loss card {lg} / CPU {lc}, grad norm {ng} / {nc}; "
        f"non-finite leaves card {len(bad['card'])} / CPU "
        f"{len(bad['cpu'])} of {len(names)} {bad['cpu'] or ''}; worst "
        f"finite gradient difference {worst:.3e} of its leaf's largest "
        f"magnitude (limit {GRAD_TOL}); K5 launches "
        f"{cg['flash_attention']} forward, {cg['flash_attention_bwd']} "
        f"backward")
    if not (bad["card"] == bad["cpu"] and worst <= GRAD_TOL
            and abs(lg - lc) <= TRAIN_LOSS_TOL * abs(lc)
            and (bad["cpu"] or abs(ng - nc) <= TRAIN_LOSS_TOL * abs(nc))
            ) or (cuda and (cg["flash_attention"] != per_step
                            or cg["flash_attention_bwd"] != per_step)):
        raise AssertionError(f"{cfg.name} gradients card against CPU: {out}")
    del model_g, model_c, res, gg, gc
    if cuda:
        torch.cuda.empty_cache()
    return out


def _train_restart(dev, *, seed, arch: str = TRAIN_ARCH,
                   dtypes=("float32", "bfloat16"), tag: str = "train-check"
                   ) -> dict:
    """Phase 16 (c) (and 21 (c)): ``arch``'s smoke config in each of
    ``dtypes``, built by ``launch.train.build``, 6 steps straight against 3
    + a Checkpointer save + restore into a fresh state + 3."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.data import pipeline
    from repro_torch.launch import train
    from repro_torch.models.lm import LM
    from repro_torch.training import train_step as ts_lib
    out = {}
    for dtype in dtypes:
        cfg, built, tcfg, dcfg = train.build(arch, smoke=True, seq=64,
                                             batch=8, microbatches=1,
                                             lr=1e-3, total_steps=10,
                                             device=dev)
        cfg = dataclasses.replace(cfg, dtype=dtype)
        batches = [train.device_batch(pipeline.global_batch_for_step(
            dcfg, i), dev) for i in range(6)]

        def start():
            model = LM(cfg, vocab_chunk=16, moe_capacity_factor=built.moe_cf,
                       device=dev)
            state = ts_lib.init_state(
                model, torch.Generator(dev).manual_seed(seed))
            return state, ts_lib.make_train_step(model, tcfg)

        s_a, step_a = start()
        for i in range(6):
            s_a, _ = step_a(s_a, batches[i])
        with tempfile.TemporaryDirectory() as tmp:
            ck = Checkpointer(os.path.join(tmp, "ck"))
            s_b, step_b = start()
            for i in range(3):
                s_b, _ = step_b(s_b, batches[i])
            ck.save(3, s_b, blocking=True)
            del s_b, step_b
            s_c, step_c = start()
            s_c, at = ck.restore(s_c)
            chain_ok = ck.verify_chain()
            for i in range(at, 6):
                s_c, _ = step_c(s_c, batches[i])
            ck.close()
        same = _same_state(s_c, _state_to_host(s_a))
        out[dtype] = {"restored_at": at, "chain_ok": chain_ok,
                      "identical": same}
        log(f"[{tag}] restart {cfg.name} {dtype}: 6 steps straight "
            f"against 3 + save + restore (step {at}) + 3: identical "
            f"{same}, chain verified {chain_ok}")
        if not (same and chain_ok and at == 3):
            raise AssertionError(f"training restart {dtype}: {out[dtype]}")
    return out


def training_phase(dev, counts, zero_counts, path_launches, *,
                   seed: int = 0, layers: int = TRAIN_LAYERS,
                   seq: int = TRAIN_SEQ, batch: int = TRAIN_BATCH,
                   steps: int = TRAIN_STEPS, check_seq: int = TRAIN_CHECK_SEQ,
                   full: bool = True, flash_cases=FLASH_BWD_CASES) -> dict:
    """Phase 16: LM training on the card. (a) ``_train_full_width`` of
    Qwen2-7B at full width, bf16, cut to ``layers`` layers: ``steps`` timed
    steps, every loss finite, every microbatch endorsed, K5's forward and
    backward launched once a layer a step, a second run of 2 steps from the
    same seed bit-identical. (b) ``_grads_card_vs_cpu`` at the same width
    cut to 1 layer, f32 (TF32 off), batch 1 at ``check_seq``. (c) The smoke config, f32 and
    bf16: 6 steps straight against 3 + a Checkpointer save + restore into
    a fresh state + 3, bit for bit, the chain verified. (a)-(c) run under
    torch's deterministic algorithms; then the embedding's backward is run
    twice without them, to say whether it needed them. (d)
    ``flash_bwd_checks``. ``full=False`` runs the smoke config in (a) and
    (b) (a rehearsal on the CPU)."""
    import warnings
    from repro_torch.data import pipeline
    from repro_torch.launch import train
    cuda = torch.device(dev).type == "cuda"
    out = {}
    # Every op of the steps on its deterministic implementation where torch
    # has one (the warnings name any that has none); cuBLAS's workspace was
    # fixed before CUDA started (main).
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out["full_width"] = _train_full_width(
                dev, TRAIN_ARCH, layers, 0, counts, zero_counts,
                path_launches, key="training", tag="train", seed=seed,
                seq=seq, batch=batch, steps=steps, smoke=not full)
            out["card_vs_cpu"] = _grads_card_vs_cpu(
                dev, TRAIN_ARCH, counts, zero_counts, seed=seed,
                seq=check_seq, smoke=not full, cut={"n_layers": 1},
                tag="train-check")
            out["restart"] = _train_restart(dev, seed=seed)
        out["nondeterministic_warnings"] = sorted(
            {str(w.message)[:200] for w in caught
             if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"[train] repeat run of 2 steps bit-identical (params, moments, "
        f"ledger head); restarts bit-identical; ops without a deterministic "
        f"implementation: {out['nondeterministic_warnings'] or 'none'}")
    # Would the step be repeatable without the flag? Its one op that sums
    # into shared rows is the embedding's backward (an index_put_ with
    # accumulate over repeated tokens): run it twice with the flag off.
    if cuda:
        cfg, _, _, dcfg = train.build(TRAIN_ARCH, smoke=not full, seq=seq,
                                      batch=batch, microbatches=1, lr=1e-3,
                                      total_steps=100, device=dev)
        g_ = torch.Generator(dev).manual_seed(seed)
        table = torch.randn((cfg.vocab_padded, cfg.d_model), generator=g_,
                            device=dev).to(cfg.torch_dtype).requires_grad_()
        toks = train.device_batch(pipeline.global_batch_for_step(dcfg, 0),
                                  dev).tokens.long()
        gy = torch.randn((*toks.shape, cfg.d_model), generator=g_,
                         device=dev).to(cfg.torch_dtype)
        emb = [torch.autograd.grad(table[toks], table, gy)[0]
               for _ in range(2)]
        out["embedding_backward_repeatable"] = bool(torch.equal(*emb))
        log(f"[train] embedding backward without the deterministic flag "
            f"repeatable: {out['embedding_backward_repeatable']}")
        del table, gy, emb
    out["flash_bwd"] = flash_bwd_checks(dev, flash_cases)
    return out


def profile_calls(calls: dict, tag: str) -> dict:
    """Each call timed alone (host clock around a synced call), then once
    under the profiler: the device's busy time, its share of the
    unprofiled time, K5's part and the 6 largest device ops, logged under
    ``[tag]``."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
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
        k5_evs = [ev for ev in evs if "flash_fwd" in ev.key]
        k5_s = sum(ev.self_device_time_total for ev in k5_evs) / 1e6
        top = sorted(evs, key=lambda e: -e.self_device_time_total)[:6]
        out[what] = {
            "wall_s": wall, "device_busy_s": busy_s,
            "busy_share": busy_s / wall, "device_ops": n_ops, "k5_s": k5_s,
            "k5_launches": sum(ev.count for ev in k5_evs),
            "top": [(ev.key[:90], ev.self_device_time_total / 1e3, ev.count)
                    for ev in top]}
        log(f"[{tag}] {what}: {wall:.4f} s alone; under the profiler device "
            f"busy {busy_s:.4f} s over {n_ops} device ops "
            f"({busy_s / wall * 100:.1f} % of the unprofiled time); K5 "
            f"{k5_s * 1e3:.3f} ms over {out[what]['k5_launches']} launches "
            f"({k5_s / busy_s * 100 if busy_s else 0:.1f} % of busy)")
        for key, ms, n in out[what]["top"]:
            log(f"[{tag}]   {ms:9.3f} ms {n:6d}x {key}")
    return out


def _weights_check(model, cfg, f32_leaves: set) -> int:
    """The model's weight count: cfg.n_params() plus the embedding rows
    that pad the vocabulary to a multiple of 256 (n_params counts
    ``vocab`` rows, the tables hold ``vocab_padded``); at a bf16 config
    only ``f32_leaves`` are f32. Returns the count."""
    n = sum(p.numel() for p in model.parameters())
    pad = (cfg.vocab_padded - cfg.vocab) * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    if n != cfg.n_params() + pad:
        raise AssertionError(f"{cfg.name}: {n} weights, config says "
                             f"{cfg.n_params()} + {pad} padding")
    f32 = {name.rsplit(".", 1)[-1] for name, p in model.named_parameters()
           if p.dtype == torch.float32}
    if cfg.dtype == "bfloat16" and f32 != f32_leaves:
        raise AssertionError(f"{cfg.name}: f32 leaves {sorted(f32)}")
    return n


def _route_recorder(moe_mod, rows):
    """A stand-in for ``moe.route`` that records, for each call, the kind of
    call and its rows' (request id, position) (``rows[0]``, set by the
    caller), the chosen experts and the margin between the k-th and
    (k+1)-th probability, all on the host. Returns (stand-in, records)."""
    orig = moe_mod.route
    records = []

    def route(router_w, x2d, top_k):
        out = orig(router_w, x2d, top_k)
        probs = torch.softmax(x2d.float() @ router_w.float(), dim=-1)
        top = torch.sort(probs, dim=-1, descending=True).values
        kind, where = rows[0]
        records.append((kind, list(where), out[1].cpu(),
                        (top[:, top_k - 1] - top[:, top_k]).cpu()))
        return out

    return route, records


def _route_flips(cpu_routes, card_routes) -> tuple[dict, float, list]:
    """Phase 17 (b)'s rule for routes, card against CPU, call by call: a
    row whose experts differ is an f32 tie when the CPU's margin between
    its k-th and (k+1)-th probability is below ROUTE_TIE, and its request
    is compared no further from that position (in a decode step, where the
    slots share capacity, every request of the step); any other
    difference fails. Returns ({request id: first flipped position}, the
    smallest margin seen, the ties)."""
    flipped, ties, least = {}, [], float("inf")
    for (kind, rows, c_e, c_m), (_, _, k_e, _) in zip(cpu_routes, card_routes,
                                                      strict=True):
        least = min(least, float(c_m.min()))
        differs = (c_e != k_e).any(dim=-1).nonzero()[:, 0].tolist()
        for i in differs:
            rid, pos = rows[i]
            if rid in flipped and pos >= flipped[rid]:
                continue  # after its own flip
            if float(c_m[i]) >= ROUTE_TIE:
                raise AssertionError(
                    f"moe route of request {rid} at position {pos} differs "
                    f"card/CPU (experts {k_e[i].tolist()} / "
                    f"{c_e[i].tolist()}) with a CPU margin of "
                    f"{float(c_m[i])}, not a tie")
            ties.append({"request": rid, "position": pos,
                         "margin": float(c_m[i])})
            for r, p in (rows if kind == "decode" else [rows[i]]):
                if r is not None:
                    flipped[r] = min(flipped.get(r, p), p)
    return flipped, least, ties


def serve_traffic(dev, cfg, counts, zero_counts, *, seed: int, tag: str,
                  model_kw=None, f32_leaves=frozenset(),
                  prompts=SERVE_PROMPTS, new: int = SERVE_NEW,
                  slots: int = SERVE_SLOTS,
                  max_len: int = SERVE_MAX_LEN) -> tuple:
    """Phases 9 and 17 (a): ``cfg`` drawn on ``dev`` from ``seed``
    (``model_kw`` go to LM) behind ServeEngine with ``slots`` slots of
    ``max_len`` positions, ``prompts`` random prompts of ``new`` tokens
    each; counters set to 0 before and read after. Admission (the
    prefills) and decode are timed apart, logged under ``[tag]``. Asserts
    every request done with ``new`` tokens, ledger versions 2, every logit
    finite, K5 once a layer a prompt and K2 launched, and the weight count
    (``_weights_check``). Returns (model, engine, requests, summary)."""
    from repro_torch.models.lm import LM
    from repro_torch.serving.engine import Request, ServeEngine
    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t1 = time.perf_counter()
    model = LM(cfg, device=dev, **(model_kw or {})).init(
        torch.Generator(device=dev).manual_seed(seed))
    sync()
    init_s = time.perf_counter() - t1
    n_weights = _weights_check(model, cfg, set(f32_leaves))
    srng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=srng.integers(0, cfg.vocab, n
                                                ).astype(np.int32),
                    max_new=new) for i, n in enumerate(prompts)]
    eng = ServeEngine(model, slots=slots, max_len=max_len)
    finite = []  # every prefill's and decode step's logits, checked after

    def finite_logits(fn):
        def call(*a):
            logits, cache = fn(*a)
            finite.append(torch.isfinite(logits).all())
            return logits, cache
        return call

    plain = eng.prefill_fn, eng.decode_fn
    eng.prefill_fn, eng.decode_fn = map(finite_logits, plain)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t1 = time.perf_counter()
    eng.submit(reqs)
    prefill_s, decode_ms = 0.0, []
    while True:  # ServeEngine.run, with admission and decode timed apart
        sync()
        ta = time.perf_counter()
        eng.admit()
        sync()
        tb = time.perf_counter()
        n_active = eng.decode()  # ends in a host copy of the tokens
        prefill_s += tb - ta
        if n_active:
            decode_ms.append((time.perf_counter() - tb) * 1e3)
        elif not eng.queue:
            break
    serve_s = time.perf_counter() - t1
    got = counts()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    eng.prefill_fn, eng.decode_fn = plain
    if not all(r.done and len(r.out) == new for r in reqs):
        raise AssertionError(f"{tag}: outputs {[len(r.out) for r in reqs]}")
    versions = [eng.request_version(r.rid) for r in reqs]
    if versions != [2] * len(reqs):
        raise AssertionError(f"{tag}: ledger versions {versions}")
    if not bool(torch.stack(finite).all()):
        raise AssertionError(f"{tag}: non-finite logits")
    if got["flash_attention"] != len(reqs) * cfg.n_layers or not \
            got["lookup"]:
        raise AssertionError(f"{tag}: launches {got}")
    decode_sorted = sorted(decode_ms)
    n_prompt = sum(len(r.prompt) for r in reqs)
    out = {
        "arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
        "weights": n_weights, "init_s": init_s,
        "requests": len(reqs), "prompt_tokens": n_prompt,
        "prefill_s": prefill_s, "prompt_tokens_per_s": n_prompt / prefill_s,
        "decode_steps": len(decode_ms),
        "decode_ms_p50": float(np.median(decode_ms)),
        "decode_ms_min": decode_sorted[0], "decode_ms_max": decode_sorted[-1],
        "output_tokens": eng.tokens_out,
        "output_tokens_per_s": eng.tokens_out / (sum(decode_ms) / 1e3),
        "wall_s": serve_s, "peak_mem_bytes": peak, "launches": got,
    }
    log(f"[{tag}] {cfg.name} {cfg.dtype}, {cfg.n_layers} layers "
        f"({n_weights} weights, drawn in {init_s:.2f} s): {len(reqs)} "
        f"requests, {n_prompt} prompt tokens prefilled in {prefill_s:.4f} s "
        f"({out['prompt_tokens_per_s']:.1f} tokens/s); {len(decode_ms)} "
        f"decode steps, p50 {out['decode_ms_p50']:.3f} ms (min "
        f"{decode_sorted[0]:.3f}, max {decode_sorted[-1]:.3f}), "
        f"{eng.tokens_out} tokens, {out['output_tokens_per_s']:.1f} "
        f"tokens/s; wall {serve_s:.3f} s; peak memory {peak / 2**30:.3f} "
        f"GiB; launches {got}; ledger versions all 2")
    return model, eng, reqs, out


def serve_profile(model, eng, prompt, tag: str) -> dict:
    """Where a serving phase's time goes: a prefill of ``prompt`` (batch
    1) and one decode step over ``eng``'s slots at their positions, by
    ``profile_calls``."""
    from repro_torch.models.lm import Batch
    dev = model.device
    p = torch.as_tensor(prompt.astype(np.int64), device=dev)[None]
    step_args = (torch.zeros(eng.n_slots, dtype=torch.long, device=dev),
                 torch.as_tensor(eng.pos.astype(np.int64), device=dev),
                 torch.ones(eng.n_slots, dtype=torch.bool, device=dev))
    return profile_calls({
        f"prefill {p.shape[1]}": lambda: model.prefill(
            Batch(tokens=p), model.init_cache(1, p.shape[1])),
        "decode step": lambda: eng.decode_fn(eng.cache, *step_args),
    }, tag)


def serve_check(dev, ccfg, counts, zero_counts, *, seed: int, tag: str,
                model_kw=None, check_prompts=CHECK_PROMPTS,
                check_new: int = CHECK_NEW) -> dict:
    """Phases 10 and 17 (b): ``ccfg`` (f32) drawn on the CPU from ``seed``
    and served there, then moved to ``dev`` and served again, one request
    a prompt of ``check_prompts`` (distinct lengths: a prefill finds its
    request by its length) with ``check_new`` greedy tokens; counters set
    to 0 before the card's run and read after. Prefill logits within
    LOGITS_TOL, greedy tokens and request ledgers identical, K5 once a
    layer a prompt. A MoE model's routes are compared call by call by
    ``_route_flips`` (a dense model routes nothing); a request with an f32
    tie is compared up to the tie. Logged under ``[tag]``; returns the
    summary (the card's launches under ``launches``)."""
    from repro_torch.core import u32
    from repro_torch.models import moe
    from repro_torch.models.lm import LM
    from repro_torch.serving.engine import Request, ServeEngine
    cmodel = LM(ccfg, device="cpu", **(model_kw or {})).init(
        torch.Generator().manual_seed(seed))
    crng = np.random.default_rng(seed + 1)
    cspecs = [(i, crng.integers(0, ccfg.vocab, n).astype(np.int32))
              for i, n in enumerate(check_prompts)]

    def check_run():
        e = ServeEngine(cmodel, slots=len(cspecs),
                        max_len=max(check_prompts) + 2 * check_new)
        rows = [None]
        route, records = _route_recorder(moe, rows)
        prefill_logits = {}

        def prefill(batch, cache):
            s = batch.tokens.shape[1]
            rid = next(i for i, p in cspecs if len(p) == s)
            rows[0] = ("prefill", [(rid, p) for p in range(s)])
            logits, cache = cmodel.prefill(batch, cache)
            prefill_logits[rid] = logits.cpu()
            return logits, cache

        def decode(cache, token, pos, active):
            rows[0] = ("decode", [(r.rid if r is not None else None, int(p))
                                  for r, p in zip(e.slot_req, pos.tolist())])
            return e_decode(cache, token, pos, active)

        e_decode = e.decode_fn
        e.prefill_fn, e.decode_fn = prefill, decode
        rs = [Request(rid=i, prompt=p, max_new=check_new) for i, p in cspecs]
        orig, moe.route = moe.route, route
        try:
            e.run(rs)
        finally:
            moe.route = orig
            # ``decode`` refers to ``e``: break the cycle, so that the
            # model leaves the card when the caller drops it, not at the
            # next garbage collection (a later phase's peak would hold it)
            e.prefill_fn = e.decode_fn = None
        return ({r.rid: r.out for r in rs}, prefill_logits,
                [u32.to_numpy(t) for t in e.state], records)

    t1 = time.perf_counter()
    cpu_res = check_run()
    cpu_s = time.perf_counter() - t1
    cmodel.to(dev)
    zero_counts()
    t1 = time.perf_counter()
    card_res = check_run()
    card_s = time.perf_counter() - t1
    got = counts()
    flipped, least, ties = _route_flips(cpu_res[3], card_res[3])
    lerr = 0.0
    for rid, prompt in cspecs:
        if rid in flipped:  # a tie in its prefill or decode
            first = flipped[rid] - len(prompt) + 1
        else:
            first = check_new
        if first > 0:
            lerr = max(lerr, float((card_res[1][rid] - cpu_res[1][rid])
                                   .abs().max()))
            if not torch.allclose(card_res[1][rid], cpu_res[1][rid],
                                  atol=LOGITS_TOL, rtol=LOGITS_TOL):
                raise AssertionError(f"{tag}: request {rid}'s prefill "
                                     f"logits differ between card and CPU")
        if card_res[0][rid][:max(first, 0)] != cpu_res[0][rid][:max(first,
                                                                     0)]:
            raise AssertionError(f"{tag}: request {rid}'s tokens differ "
                                 f"between card and CPU")
    if not all(np.array_equal(a, c) for a, c in zip(card_res[2],
                                                    cpu_res[2])):
        raise AssertionError(f"{tag}: request ledgers differ between card "
                             f"and CPU")
    if got["flash_attention"] != len(cspecs) * ccfg.n_layers:
        raise AssertionError(f"{tag}: launches {got}")
    out = {"logits_max_abs_err": lerr, "tokens": card_res[0],
           "card_s": card_s, "cpu_s": cpu_s, "launches": got}
    routes = ""
    if card_res[3]:
        out.update(route_calls=len(card_res[3]), least_margin=least,
                   ties=ties)
        routes = (f"; routes of {len(card_res[3])} moe calls compared, "
                  f"{len(ties)} f32 ties {ties}, smallest CPU margin between "
                  f"the k-th and (k+1)-th probability {least:.3e} (tie "
                  f"below {ROUTE_TIE})")
    log(f"[{tag}] {ccfg.name} cut to {ccfg.n_layers} layers, {ccfg.dtype}: "
        f"prefill logits max_abs_err {lerr} (tolerance {LOGITS_TOL}); tokens "
        f"card {card_res[0]} CPU {cpu_res[0]}{routes}; ledgers identical; "
        f"card {card_s:.2f} s, CPU {cpu_s:.2f} s; launches {got}")
    del cmodel
    return out


def moe_serving_phase(dev, counts, zero_counts, path_launches, *,
                      seed: int = 0, cfg=None, check_cfg=None,
                      prompts=SERVE_PROMPTS, new: int = SERVE_NEW,
                      slots: int = SERVE_SLOTS, max_len: int = SERVE_MAX_LEN,
                      check_prompts=CHECK_PROMPTS,
                      check_new: int = CHECK_NEW) -> dict:
    """Phase 17: MoE serving. (a) ``cfg`` (Qwen1.5-MoE-A2.7B at all 24
    layers, bf16, by default) at capacity factor MOE_CF through
    ``serve_traffic``; then, untimed, a replay of the same requests that
    must give the same tokens and counts the share of routed assignments
    dropped in prefill and in decode; the longest prompt's prefill twice,
    bit for bit (the first records each layer's busiest expert); the
    device's busy share and top ops of one prefill and one decode step.
    (b) ``check_cfg`` (the same cut to 2 layers, f32) through
    ``serve_check``. A rehearsal on the CPU passes smaller configs."""
    from repro_torch.configs import base as cfg_base
    from repro_torch.models import moe
    from repro_torch.models.lm import Batch
    from repro_torch.serving.engine import Request, ServeEngine
    cuda = torch.device(dev).type == "cuda"
    cfg = cfg or cfg_base.get(MOE_ARCH)
    model_kw = {"moe_capacity_factor": MOE_CF}
    model, eng, reqs, out = serve_traffic(
        dev, cfg, counts, zero_counts, seed=seed, tag="moe-serve",
        model_kw=model_kw, f32_leaves={"router"}, prompts=prompts, new=new,
        slots=slots, max_len=max_len)
    out["capacity_factor"] = MOE_CF
    path_launches["moe_serving"] = out["launches"]
    # The drop shares, from an untimed replay (the timed run called
    # moe_mlp plain): every moe_mlp call of a prefill or a decode step
    # records its routed and dropped assignments under that kind, one
    # call a layer in layer order.
    calls, kind, moe_mlp = {"prefill": [], "decode": []}, [None], moe.moe_mlp
    replay = ServeEngine(model, slots=slots, max_len=max_len)

    def tagged(fn, what):
        def call(*a):
            kind[0] = what
            return fn(*a)
        return call

    replay.prefill_fn = tagged(replay.prefill_fn, "prefill")
    replay.decode_fn = tagged(replay.decode_fn, "decode")
    again = [Request(rid=r.rid, prompt=r.prompt, max_new=new) for r in reqs]
    moe.moe_mlp = _drop_recorder(moe_mlp, lambda: calls[kind[0]])
    try:
        replay.run(again)
    finally:
        moe.moe_mlp = moe_mlp
    if [r.out for r in again] != [r.out for r in reqs]:
        raise AssertionError("moe serving: the untimed replay's tokens "
                             "differ from the timed run's")
    del replay
    drops = {kind: _drop_shares(c, cfg.n_layers)
             for kind, c in calls.items()}
    # The longest prompt's prefill twice: bit for bit. The first records
    # each layer's busiest expert (its share of the layer's assignments).
    longest = max(reqs, key=lambda r: len(r.prompt))
    plong = torch.as_tensor(longest.prompt.astype(np.int64),
                            device=dev)[None]
    loads, route = [], moe.route

    def load_route(router_w, x2d, top_k):
        out = route(router_w, x2d, top_k)
        ids = out[1].reshape(-1)
        loads.append(torch.zeros(router_w.shape[1], device=ids.device
                                 ).scatter_add_(0, ids, torch.ones_like(
                                     ids, dtype=torch.float32)).max()
                     / ids.numel())
        return out

    moe.route = load_route
    try:
        runs = [model.prefill(Batch(tokens=plong),
                              model.init_cache(1, plong.shape[1]))]
    finally:
        moe.route = route
    runs.append(model.prefill(Batch(tokens=plong),
                              model.init_cache(1, plong.shape[1])))
    busiest = torch.stack(loads).cpu()
    drops["busiest_expert_share"] = {
        "min": float(busiest.min()), "median": float(busiest.median()),
        "max": float(busiest.max()),
        "capacity_share": moe.capacity(MOE_CF, plong.shape[1], cfg.top_k,
                                       cfg.n_experts)
        / (plong.shape[1] * cfg.top_k)}
    repeat_identical = (torch.equal(runs[0][0], runs[1][0])
                        and torch.equal(runs[0][1].k, runs[1][1].k)
                        and torch.equal(runs[0][1].v, runs[1][1].v))
    del runs
    if not repeat_identical:
        raise AssertionError("moe serving: a repeated prefill differs")
    out.update(drops=drops, repeat_prefill_identical=repeat_identical)
    log(f"[moe-serve] cf {MOE_CF}; an untimed replay gave the same tokens "
        f"and dropped {drops['prefill']['share'] * 100:.3f} % of the "
        f"prefill's {drops['prefill']['assignments']} routed assignments "
        f"and {drops['decode']['share'] * 100:.3f} % of the decode's "
        f"{drops['decode']['assignments']}; the {plong.shape[1]}-token "
        f"prefill repeated bit for bit, its layers' busiest expert taking "
        f"{busiest.min() * 100:.2f}-{busiest.max() * 100:.2f} % (median "
        f"{busiest.median() * 100:.2f} %) of their assignments, capacity "
        f"{drops['busiest_expert_share']['capacity_share'] * 100:.2f} %")
    log(f"[moe-serve] prefill's dropped share by layer "
        f"{[round(x * 100, 3) for x in drops['prefill']['per_layer']]} %; "
        f"decode's {[round(x * 100, 3) for x in drops['decode']['per_layer']]}"
        f" %")
    if cuda:
        out["profile"] = serve_profile(model, eng, longest.prompt,
                                       "moe-serve-profile")
    del eng, model
    if cuda:
        torch.cuda.empty_cache()

    # (b) card against CPU: 2 layers, f32.
    ccfg = check_cfg or dataclasses.replace(cfg, n_layers=2,
                                            dtype="float32")
    out["vs_cpu"] = serve_check(dev, ccfg, counts, zero_counts, seed=seed,
                                tag="moe-serve-check", model_kw=model_kw,
                                check_prompts=check_prompts,
                                check_new=check_new)
    path_launches["moe_serving_vs_cpu"] = out["vs_cpu"]["launches"]
    return out


def ssm_phase(dev, counts, zero_counts, path_launches, *, seed: int = 0,
              cfg=None, check_cfg=None, batch: int = SSM_BATCH,
              seq: int = SSM_SEQ, new: int = SSM_NEW,
              check_prompts=SSM_CHECK_PROMPTS,
              check_new: int = CHECK_NEW) -> dict:
    """Phase 18: the SSM family. (a) ``cfg`` (Mamba2-2.7B at all 64 layers,
    bf16, by default) through ``_family_full_width``, no kernel launched;
    layer 0's SSD inputs (recorded in the warm-up prefill) through the
    chunked scan against ``ssd_sequential_reference`` on the card, y and
    the final state within SSD_TOL of their largest magnitude. (b)
    ``check_cfg`` (the same cut to 2 layers, f32) card against CPU through
    ``_family_check``, conv tails and SSM states within LOGITS_TOL. A
    rehearsal on the CPU passes smaller configs."""
    from repro_torch.configs import base as cfg_base
    from repro_torch.models import ssm
    cfg = cfg or cfg_base.get(SSM_ARCH)
    recorded, chunk = [], {}
    chunked = ssm.ssd_chunked

    def first_inputs(*a, **kw):
        if not recorded:
            recorded.extend(t.clone() for t in a)
            chunk["chunk"] = kw["chunk"]
        return chunked(*a, **kw)

    ssm.ssd_chunked = first_inputs
    try:
        out = _family_full_width(
            dev, cfg, counts, zero_counts, path_launches, key="ssm",
            tag="ssm", seed=seed, batch=batch, seq=seq, new=new,
            k5_per_prefill=0, f32_leaves=set(ssm.F32_LEAVES))
    finally:
        ssm.ssd_chunked = chunked
    y_c, st_c = ssm.ssd_chunked(*recorded, **chunk)
    y_s, st_s = ssm.ssd_sequential_reference(*recorded)
    ssd_err = {
        "y": float((y_c - y_s).abs().max() / y_s.abs().max()),
        "state": float((st_c - st_s).abs().max() / st_s.abs().max())}
    del recorded, y_c, y_s, st_c, st_s
    out["ssd_vs_sequential"] = ssd_err
    log(f"[ssm] layer 0's chunked scan against the sequential one: y "
        f"{ssd_err['y']:.3e}, final state {ssd_err['state']:.3e} of their "
        f"largest magnitude (limit {SSD_TOL})")
    if max(ssd_err.values()) > SSD_TOL:
        raise AssertionError(f"ssm: chunked scan against the sequential "
                             f"reference {ssd_err}")
    ccfg = check_cfg or dataclasses.replace(cfg, n_layers=2,
                                            dtype="float32")
    out["vs_cpu"] = _family_check(
        dev, ccfg, counts, zero_counts, path_launches, key="ssm_vs_cpu",
        tag="ssm-check", seed=seed, prompts=check_prompts,
        frames=(0,) * len(check_prompts), new=check_new,
        cache_tol=LOGITS_TOL)
    return out


def _family_full_width(dev, cfg, counts, zero_counts, path_launches, *,
                       key: str, tag: str, seed: int, batch: int, seq: int,
                       new: int, k5_per_prefill: int, f32_leaves: set,
                       enc_len: int = 0) -> dict:
    """Phases 18-20 (a): ``cfg`` drawn from ``seed`` on ``dev``; one
    ``LM.prefill`` of ``batch`` x ``seq`` tokens (over ``enc_len``
    standard-normal encoder frames, for encdec) into a cache of ``seq`` +
    ``new`` positions, then ``new`` greedy ``decode_step``s; an untimed
    prefill of the same inputs first warms the library's kernel choices
    for these shapes (the prefill rewrites the whole cache). Asserts the
    weight count, finite logits and K5 launched exactly ``k5_per_prefill``
    times in the prefill, no other kernel and nothing in decode (counts set
    to 0 before the prefill and read after it and after the last step,
    stored as ``path_launches[key]``); logs prompt tokens/s, decode
    p50/min/max and peak memory under ``[tag]``, then profiles a prefill
    and a decode step (``[tag-profile]``). The device memory that earlier
    phases still hold when it starts is logged beside the peak."""
    import gc
    from repro_torch.models.lm import LM, Batch
    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    gc.collect()
    held = torch.cuda.memory_allocated() if cuda else 0
    t1 = time.perf_counter()
    model = LM(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(seed))
    sync()
    init_s = time.perf_counter() - t1
    n_weights = _weights_check(model, cfg, f32_leaves)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq))).to(dev)
    enc = (torch.from_numpy(rng.standard_normal(
        (batch, enc_len, cfg.d_model), dtype=np.float32)).to(dev)
        if enc_len else None)
    inputs = Batch(tokens=toks, enc_embeds=enc)
    cache = model.init_cache(batch, seq + new, enc_len=enc_len)
    model.prefill(inputs, cache)  # warm-up, uncounted
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t1 = time.perf_counter()
    logits, cache = model.prefill(inputs, cache)
    sync()
    prefill_s = time.perf_counter() - t1
    at_prefill = counts()
    finite = [torch.isfinite(logits).all()]
    decode_ms = []
    tok = torch.argmax(logits, dim=-1)
    for i in range(new):
        t1 = time.perf_counter()
        logits, cache = model.decode_step(cache, tok, seq + i)
        tok = torch.argmax(logits, dim=-1)
        sync()
        decode_ms.append((time.perf_counter() - t1) * 1e3)
        finite.append(torch.isfinite(logits).all())
    got = counts()
    path_launches[key] = got
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    want = {k: 0 for k in got}
    want["flash_attention"] = k5_per_prefill
    if at_prefill != want or got != want:
        raise AssertionError(f"{key}: launches {at_prefill} after the "
                             f"prefill, {got} after decode; expected {want}")
    if not bool(torch.stack(finite).all()):
        raise AssertionError(f"{key}: non-finite logits")
    decode_sorted = sorted(decode_ms)
    out = {
        "arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
        "enc_layers": cfg.enc_layers, "weights": n_weights, "init_s": init_s,
        "batch": batch, "seq": seq, "enc_len": enc_len,
        "prefill_s": prefill_s, "prompt_tokens_per_s": batch * seq / prefill_s,
        "decode_steps": new, "decode_ms_p50": float(np.median(decode_ms)),
        "decode_ms_min": decode_sorted[0], "decode_ms_max": decode_sorted[-1],
        "output_tokens_per_s": batch * new / (sum(decode_ms) / 1e3),
        "peak_mem_bytes": peak, "held_at_start_bytes": held,
        "launches": got,
    }
    frames = f" over {batch} x {enc_len} frames" if enc_len else ""
    log(f"[{tag}] {cfg.name} {cfg.dtype}, {cfg.n_layers} layers"
        f"{f' + {cfg.enc_layers} encoder layers' if cfg.enc_layers else ''} "
        f"({n_weights} weights, drawn in {init_s:.2f} s): prefill of {batch} "
        f"x {seq} tokens{frames} in {prefill_s:.4f} s "
        f"({out['prompt_tokens_per_s']:.1f} tokens/s); {new} decode steps of "
        f"{batch}, p50 {out['decode_ms_p50']:.3f} ms (min "
        f"{decode_sorted[0]:.3f}, max {decode_sorted[-1]:.3f}), "
        f"{out['output_tokens_per_s']:.1f} tokens/s; peak memory "
        f"{peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB held by earlier "
        f"phases at the start); launches {got}")
    if cuda:
        pcache = model.init_cache(batch, seq + new, enc_len=enc_len)
        out["profile"] = profile_calls({
            f"prefill {batch}x{seq}": lambda: model.prefill(inputs, pcache),
            "decode step": lambda: model.decode_step(cache, tok, seq + new - 1),
        }, f"{tag}-profile")
        del pcache
    del model, cache, logits
    if cuda:
        torch.cuda.empty_cache()
    return out


def _family_check(dev, ccfg, counts, zero_counts, path_launches, *, key: str,
                  tag: str, seed: int, prompts, frames, new: int,
                  cache_tol: float, cache_scaled: bool = False) -> dict:
    """Phases 18-20 (b): ``ccfg`` drawn on the CPU from ``seed``, run on
    the CPU and then on ``dev``, one prompt at a time (batch 1; for encdec
    over ``frames`` standard-normal frames a prompt): the prefill and
    ``new`` greedy steps. Logits within LOGITS_TOL, greedy tokens
    identical, every cache field within ``cache_tol`` (with
    ``cache_scaled``, ``cache_tol`` of that field's largest magnitude on
    the CPU as the absolute part); on the card K5 once a site (hybrid),
    three times a layer (encdec) or never (ssm) a prompt. Logs under
    ``[tag]``."""
    from repro_torch.models.lm import LM, Batch
    cmodel = LM(ccfg, device="cpu").init(torch.Generator().manual_seed(seed))
    crng = np.random.default_rng(seed + 1)
    inputs = [(torch.from_numpy(crng.integers(0, ccfg.vocab, (1, n))),
               torch.from_numpy(crng.standard_normal(
                   (1, f, ccfg.d_model), dtype=np.float32)) if f else None)
              for n, f in zip(prompts, frames)]
    fields = ("hyb_k", "hyb_v", "conv", "ssm_state", "k", "v", "cross_k",
              "cross_v")

    def check_run(d):
        res = []
        for toks, enc in inputs:
            c = cmodel.init_cache(1, toks.shape[1] + new)
            logits, c = cmodel.prefill(
                Batch(tokens=toks.to(d),
                      enc_embeds=None if enc is None else enc.to(d)), c)
            run = [logits.cpu()]
            for i in range(new):
                logits, c = cmodel.decode_step(
                    c, torch.argmax(logits, dim=-1), toks.shape[1] + i)
                run.append(logits.cpu())
            res.append((run, {f: getattr(c, f).cpu() for f in fields
                              if getattr(c, f) is not None}))
        return res

    t1 = time.perf_counter()
    cpu_res = check_run("cpu")
    cpu_s = time.perf_counter() - t1
    cmodel.to(dev)
    zero_counts()
    t1 = time.perf_counter()
    card_res = check_run(dev)
    card_s = time.perf_counter() - t1
    got = counts()
    path_launches[key] = got
    per_prompt = (len(cmodel._hybrid_groups()) if ccfg.family == "hybrid"
                  else 3 * ccfg.n_layers if ccfg.family == "encdec" else 0)
    if torch.device(dev).type == "cuda":
        want = {k: 0 for k in got}
        want["flash_attention"] = per_prompt * len(prompts)
        if got != want:
            raise AssertionError(f"{key}: launches {got}, expected {want}")
    errs, scale, bad = {"logits": 0.0}, {}, []
    for n, (k_run, k_cache), (c_run, c_cache) in zip(prompts, card_res,
                                                     cpu_res):
        pairs = ([("logits", a, b, LOGITS_TOL, 1.0)
                  for a, b in zip(k_run, c_run)]
                 + [(f, k_cache[f], c_cache[f], cache_tol,
                     float(c_cache[f].abs().max()) if cache_scaled else 1.0)
                    for f in c_cache])
        for what, k, c, tol, s in pairs:
            if k.shape != c.shape:
                raise AssertionError(f"{key}: {what} of the {n}-token prompt "
                                     f"has shape {k.shape} on the card, "
                                     f"{c.shape} on the CPU")
            errs[what] = max(errs.get(what, 0.0), float((k - c).abs().max()))
            if what != "logits":
                scale[what] = min(scale.get(what, s), s)
            if not torch.allclose(k, c, atol=tol * s, rtol=tol):
                bad.append(f"{what} of the {n}-token prompt")
        if [int(a.argmax()) for a in k_run] != [int(a.argmax())
                                                 for a in c_run]:
            bad.append(f"greedy tokens of the {n}-token prompt")
    if bad:
        raise AssertionError(f"{key}: {bad} differ between card and CPU "
                             f"(max_abs_err {errs})")
    out = {"max_abs_err": errs, "card_s": card_s, "cpu_s": cpu_s,
           "cache_tol": cache_tol, "cache_scaled": cache_scaled,
           **({"cache_scale": scale} if cache_scaled else {}),
           "prompts": list(prompts), "frames": list(frames),
           "n_layers": ccfg.n_layers, "enc_layers": ccfg.enc_layers,
           "launches": got}
    log(f"[{tag}] {ccfg.name} cut to {ccfg.n_layers}"
        f"{f' + {ccfg.enc_layers}' if ccfg.enc_layers else ''} layers, f32, "
        f"prompts of {list(prompts)} tokens"
        f"{f' over {list(frames)} frames' if any(frames) else ''} + {new} "
        f"greedy steps: max_abs_err {errs} (logits tolerance {LOGITS_TOL}, "
        f"caches {cache_tol}"
        f"{f' of their largest magnitude {scale}' if cache_scaled else ''}); "
        f"tokens identical; card {card_s:.2f} s, CPU "
        f"{cpu_s:.2f} s; launches {got}")
    del cmodel
    return out


def hybrid_phase(dev, counts, zero_counts, path_launches, *, seed: int = 0,
                 cfg=None, check_cfg=None, batch: int = FAMILY_BATCH,
                 seq: int = FAMILY_SEQ, new: int = FAMILY_NEW,
                 check_prompts=FAMILY_CHECK_PROMPTS,
                 check_new: int = CHECK_NEW) -> dict:
    """Phase 19: the hybrid family. (a) ``cfg`` (Zamba2-1.2B at all 38
    layers, bf16, by default) through ``_family_full_width``: K5 once a
    site a prefill (7). (b) ``check_cfg`` (the same cut to 8 layers, 2
    sites, f32) card against CPU through ``_family_check``, the sites' K/V,
    conv tails and SSM states within LOGITS_TOL (phase 18 (b)'s limits).
    A rehearsal on the CPU passes smaller configs."""
    from repro_torch.configs import base as cfg_base
    from repro_torch.models.lm import LM
    cfg = cfg or cfg_base.get(HYBRID_ARCH)
    sites = len(LM(cfg, device="cpu")._hybrid_groups())
    out = _family_full_width(
        dev, cfg, counts, zero_counts, path_launches, key="hybrid",
        tag="hybrid", seed=seed, batch=batch, seq=seq, new=new,
        k5_per_prefill=sites, f32_leaves={"dt_bias", "A_log", "D"})
    out["sites"] = sites
    ccfg = check_cfg or dataclasses.replace(
        cfg, n_layers=HYBRID_CHECK_LAYERS, dtype="float32")
    out["vs_cpu"] = _family_check(
        dev, ccfg, counts, zero_counts, path_launches, key="hybrid_vs_cpu",
        tag="hybrid-check", seed=seed, prompts=check_prompts,
        frames=(0,) * len(check_prompts), new=check_new,
        cache_tol=LOGITS_TOL)
    return out


def encdec_phase(dev, counts, zero_counts, path_launches, *, seed: int = 0,
                 cfg=None, check_cfg=None, batch: int = FAMILY_BATCH,
                 seq: int = FAMILY_SEQ, new: int = FAMILY_NEW,
                 check_prompts=FAMILY_CHECK_PROMPTS,
                 check_frames=ENCDEC_CHECK_FRAMES,
                 check_new: int = CHECK_NEW) -> dict:
    """Phase 20: the encoder-decoder family. (a) ``cfg``
    (SeamlessM4T-medium at 12 + 12 layers, bf16, by default) over seq // 4
    frames through ``_family_full_width``: K5 three times a layer a prefill
    (36). (b) ``check_cfg`` (the same cut to 2 + 2 layers, f32) card
    against CPU through ``_family_check``, k/v and cross_k/v within
    ENCDEC_CACHE_TOL of each field's largest magnitude. A rehearsal on the
    CPU passes smaller configs."""
    from repro_torch.configs import base as cfg_base
    cfg = cfg or cfg_base.get(ENCDEC_ARCH)
    out = _family_full_width(
        dev, cfg, counts, zero_counts, path_launches, key="encdec",
        tag="encdec", seed=seed, batch=batch, seq=seq, new=new,
        k5_per_prefill=3 * cfg.n_layers, f32_leaves=set(),
        enc_len=seq // 4)
    ccfg = check_cfg or dataclasses.replace(
        cfg, n_layers=ENCDEC_CHECK_LAYERS, enc_layers=ENCDEC_CHECK_LAYERS,
        dtype="float32")
    out["vs_cpu"] = _family_check(
        dev, ccfg, counts, zero_counts, path_launches, key="encdec_vs_cpu",
        tag="encdec-check", seed=seed, prompts=check_prompts,
        frames=check_frames, new=check_new, cache_tol=ENCDEC_CACHE_TOL,
        cache_scaled=True)
    return out


def family_training_phase(dev, counts, zero_counts, path_launches, *,
                          seed: int = 0, families=FAMILY_TRAIN,
                          seq: int = TRAIN_SEQ, batch: int = TRAIN_BATCH,
                          steps: int = FAMILY_TRAIN_STEPS,
                          check_seq: int = FAMILY_CHECK_SEQ,
                          smoke_seq: int = FAMILY_SMOKE_SEQ,
                          full: bool = True) -> dict:
    """Phase 21: training the moe, ssm, hybrid and encdec families on the
    card, under torch's deterministic algorithms (strict, as
    ``launch.train`` sets them; cuBLAS's workspace fixed at start). For
    each of ``families`` ((arch, layers, encoder layers)): (a)
    ``_train_full_width``; (b) ``_grads_card_vs_cpu`` at the
    published width cut to 1 layer (hybrid: 1 group; encdec: 1 + 1) at
    ``check_seq`` and at the smoke config at ``smoke_seq`` (every leaf
    finite there); (c) ``_train_restart`` of the smoke config in bf16.
    ``full=False`` runs (a) and (b)'s first part at the smoke configs (a
    rehearsal on the CPU)."""
    from repro_torch.configs import base as cfg_base
    out = {}
    torch.use_deterministic_algorithms(True)
    try:
        for arch, layers, enc_layers in families:
            fam = {}
            base = cfg_base.get(arch) if full else cfg_base.get_smoke(arch)
            fam["full_width"] = _train_full_width(
                dev, arch, layers, enc_layers, counts, zero_counts,
                path_launches, key=f"train_{base.family}",
                tag="family-train", seed=seed, seq=seq, batch=batch,
                steps=steps, smoke=not full)
            one = dict(n_layers=1)
            if base.family == "hybrid":
                one["n_layers"] = base.attn_every
            if base.family == "encdec":
                one["enc_layers"] = 1
            fam["published_vs_cpu"] = _grads_card_vs_cpu(
                dev, arch, counts, zero_counts, seed=seed, seq=check_seq,
                smoke=not full, cut=one, tag="family-check")
            fam["smoke_vs_cpu"] = _grads_card_vs_cpu(
                dev, arch, counts, zero_counts, seed=seed, seq=smoke_seq,
                smoke=True, tag="family-check")
            if fam["smoke_vs_cpu"]["nonfinite"]:
                raise AssertionError(f"{arch} smoke gradients non-finite at "
                                     f"S = {smoke_seq}")
            fam["restart"] = _train_restart(dev, seed=seed, arch=arch,
                                            dtypes=("bfloat16",),
                                            tag="family-check")
            out[base.family] = fam
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the serving phases' weights and prompts")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # cuBLAS's workspace fixed before CUDA starts, so that phase 16 can run
    # with torch's deterministic algorithms on (torch asks for it there).
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.nn.functional as F
    from repro_torch.configs import base as cfg_base
    from repro_torch.core import (committer, crypto, engine, ledger,
                                  orderer, types, u32, unmarshal)
    from repro_torch.core import world_state as ws
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.hash_table import ops as ht_ops, ref as ht_ref
    from repro_torch.kernels.mvcc_validate import cases as mv_cases
    from repro_torch.kernels.mvcc_validate import ops as mv_ops
    from repro_torch.kernels.mvcc_validate import ref as mv_ref
    from repro_torch.kernels.sig_mac import ops as mac_ops, ref as mac_ref
    from repro_torch.models.lm import Batch
    from repro_torch.obs import Obs, Registry
    from repro_torch.storage import journal, recovery, snapshot

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

    counts, zero_counts = launch_counts, zero_launch_counts

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
                    or "Compiling entry" in line or "Performance Loss" in line):
                log(f"[build] {name}: {line.strip()}")
    # K5's wgmma kernels: registers a thread at launch (the warpgroups then
    # move them with setmaxnreg: producer 24, consumers 240 in the forward;
    # 40 and 232 in the backward's dQ and dK/dV), spills, and the forward's
    # shared memory (static, plus the dynamic Q tile and K/V ring).
    smem_of = build.libraries()["flash_attention"].flash_attention_wgmma_smem
    smem_of.argtypes, smem_of.restype = [ctypes.c_int], ctypes.c_int
    fa_log = build.build_log("flash_attention").splitlines()
    for i, line in enumerate(fa_log):
        for kname in ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                      "flash_bwd_dkdv_wgmma_kernel"):
            if "Compiling entry" not in line or kname not in line:
                continue
            d_ = int(line.split(kname + "ILi")[1].split("E")[0])
            info = [x.strip() for x in fa_log[i + 1:i + 4]
                    if "spill" in x or "Used" in x]
            smem = (f"; dynamic shared memory {smem_of(d_)} bytes"
                    if kname.startswith("flash_fwd") else "")
            log(f"[build] {kname} D = {d_}: {'; '.join(info)}{smem}")
    phase_done("1 build", t0)

    # -- 2. kernels against their plain versions ----------------------------
    t0 = time.perf_counter()
    errs = {"mac_many": 0, "lookup": 0, "commit": 0, "validate": 0,
            "flash_attention": 0.0, "flash_attention_bwd": None}

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
    # K1's ordered schedule: one block, `step` rows a step with a barrier
    # between steps, as the serial (1) and tiled (16; 7 and 3 do not divide
    # the rows) checks and the serial admission run it; 1000 x 22 spans
    # several staged tiles of 8,192 words, 3 x 9000 is too long to stage;
    # and the floor.
    for what, msg, (r, s), steps in (
            ("verify 100x22x3", msg_block, (r3, s3), (1, 3, 7, 16, 99)),
            ("admission 1000x3x1",
             T(rng.integers(0, 1 << 32, (1000, 3), dtype=np.uint32)),
             (r1, s1), (1, 7)),
            ("extreme words and keys 1000x22x4", T(edge), keys_edge,
             (1, 33, 1024)),
            ("1x1x1", T(np.array([[0xFFFFFFFF]], np.uint32)), (r1, s1),
             (1,)),
            ("rows too long to stage 3x9000x3",
             T(rng.integers(0, 1 << 32, (3, 9000), dtype=np.uint32)),
             (r3, s3), (1, 2))):
        want = mac_ref.mac_many_ref(msg, r, s)
        for st in steps:
            check("mac_many", [mac_ops.mac_many(msg, r, s, st)], [want],
                  f"{what} step {st}")

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
    q8192 = queries(8192, 2)
    for what, qs in (("200 queries", q200), ("8192 queries", q8192)):
        check("lookup", ht_ops.lookup(*table, qs),
              ht_ref.lookup_ref(*table, qs), what)

    def small_table(nb_, s_, vw_, seed):
        """A table of nb_ x s_ slots, half full, two buckets full, one
        key stored twice in a row; numpy arrays."""
        g = np.random.default_rng(seed)
        k_ = g.integers(1, 1 << 32, (nb_ * s_ // 2 + 2 * s_, 2),
                        dtype=np.uint32)
        k_[-2 * s_:, 0] = ((k_[-2 * s_:, 0] & ~np.uint32(nb_ - 1))
                           | np.repeat([1, 2], s_).astype(np.uint32))
        keys_ = np.zeros((nb_, s_, 2), np.uint32)
        fill = np.zeros(nb_, int)
        for key in k_:
            b_ = int(key[0]) & (nb_ - 1)
            if fill[b_] < s_:
                keys_[b_, fill[b_]] = key
                fill[b_] += 1
        keys_[3, -1] = keys_[3, 0]
        return (keys_, g.integers(1, 1 << 32, (nb_, s_), dtype=np.uint32),
                g.integers(0, 1 << 32, (nb_, s_, vw_), dtype=np.uint32))

    # Other slot counts: S = 3 (VW = 3, the generic instance, a group of
    # 4 lanes) and S = 40 (a row walked in two 32-lane segments).
    for nb_, s_, vw_ in ((1 << 10, 3, 3), (256, 40, 4)):
        st_ = small_table(nb_, s_, vw_, s_)
        occ_ = np.argwhere(st_[0][..., 0] != 0)
        g = np.random.default_rng(s_)
        qs = st_[0][tuple(occ_[g.integers(0, len(occ_), 300)].T)]
        qs[::3] = g.integers(0, 1 << 32, (100, 2), dtype=np.uint32)
        qs[1] = (0, qs[0, 1])
        qs[4] = st_[0][3, 0]
        qs[5] = st_[0][2, -1]
        tab = [T(a) for a in st_]
        check("lookup", ht_ops.lookup(*tab, T(qs)),
              ht_ref.lookup_ref(*tab, T(qs)),
              f"S = {s_}, VW = {vw_}, 300 queries")

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
    # The schedule's edges, the plain version on CPU copies: two parts (33
    # writes), 128 parts (4,096), past the 1,024-part limit (33,000), a hot
    # bucket that one part stages in several passes (3,000 writes of 5
    # keys), S = 16 (16-lane groups) and S = 40 (a row wider than a warp,
    # walked in memory): 2,000 writes, and a hot bucket of 300 writes of 45
    # keys (5 stored, one of them twice, and 40 new) that overflows.
    w_hot3k = writes(3000, 13, 0, p_inactive=0.1)
    w_hot3k[0][:] = in_bucket(
        g.integers(1, 1 << 32, (5, 2), dtype=np.uint32),
        np.full(5, three_free[1]))[g.integers(0, 5, 3000)]
    small = {s_: small_table(1 << 10, s_, dims.vw, 100 + s_)
             for s_ in (16, 40)}

    def small_writes(st_, k, seed):
        g_ = np.random.default_rng(seed)
        occ_ = np.argwhere(st_[0][..., 0] != 0)
        wk = g_.integers(1, 1 << 32, (k, 2), dtype=np.uint32)
        wk[:k // 2] = st_[0][tuple(occ_[g_.integers(0, len(occ_),
                                                    k // 2)].T)]
        wk[g_.random(k) < 0.05, 0] = 0
        return (wk, g_.integers(0, 1 << 32, (k, dims.vw), dtype=np.uint32),
                g_.random(k) >= 0.1)

    edge_cases = [("33 writes, two parts", table, writes(33, 14, 16)),
                  ("K = 4096, 128 parts", table, writes(4096, 15, 2048)),
                  ("K = 33000, past the 1,024-part limit", table,
                   writes(33000, 16, 8000)),
                  ("3000 writes of 5 keys into one bucket, staged in "
                   "passes", table, w_hot3k)]
    edge_cases += [(f"S = {s_}, 2000 writes", [T(a) for a in small[s_]],
                    small_writes(small[s_], 2000, s_)) for s_ in (16, 40)]
    g40 = np.random.default_rng(40)
    pool40 = np.concatenate([small[40][0][3, :5], in_bucket(
        g40.integers(1, 1 << 32, (40, 2), dtype=np.uint32), np.full(40, 3))])
    hot40 = (pool40[g40.integers(0, 45, 300)],
             g40.integers(0, 1 << 32, (300, dims.vw), dtype=np.uint32),
             g40.random(300) >= 0.1)
    hot40[0][g40.random(300) < 0.05, 0] = 0
    edge_cases.append(("S = 40, 300 writes of 45 keys into one bucket",
                       [T(a) for a in small[40]], hot40))
    for what, tab, (wk, wv, act) in edge_cases:
        ins = (T(wk), T(wv), torch.from_numpy(act).to(dev))
        kern = [t.clone() for t in tab]
        ovf = ht_ops.commit(*kern, *ins)
        got = [t.cpu() for t in kern + [ovf]]
        del kern
        plain = [t.cpu() for t in tab]
        want = plain + [ht_ref.commit_ref(*plain, *(t.cpu() for t in ins))]
        check("commit", got, want, what)
        log(f"[check] commit {what}: overflow {bool(ovf)}")
        del got, plain, want

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

    def mv_cuda(arrays):
        rk_, rv_, wk_, cur_, ok0_ = arrays
        return [T(a) for a in (rk_, rv_, wk_, cur_)] + [
            torch.from_numpy(ok0_).to(dev)]

    mv_block = mvcc_inputs(100, 3, 0.5)
    mv_1024 = mv_cuda(mv_cases.random_block(1024, 9, n_accounts=400))
    mv_checks = [("block of 100", mv_block),
                 ("block of 1", mvcc_inputs(1, 4, 0.0)),
                 ("block of 1024", mvcc_inputs(1024, 5, 0.3)),
                 ("dense block of 1024", mv_1024),
                 # key counts other than the paths' 2 and 2 are read at
                 # run time by another instance of the kernel
                 ("RK = WK = 4, block of 1024", mv_cuda(mv_cases.random_block(
                     1024, 10, nr=4, nw=4, n_accounts=600))),
                 ("RK = 3, WK = 1, block of 333",
                  mv_cuda(mv_cases.random_block(333, 12, nr=3, nw=1)))]
    # the chunk borders of the one-warp scan (32 txs a chunk), dense
    # conflicts among 48 accounts
    mv_checks += [(f"block of {b_}", mv_cuda(mv_cases.random_block(b_, b_)))
                  for b_ in (31, 32, 33, 63, 64, 65, 1023)]
    # past 32 chunks and past one CTA's shared memory (conflict words in a
    # scratch buffer on the tiled route)
    mv_big = {b_: mv_cuda(mv_cases.random_block(b_, 20 + b_,
                                                n_accounts=b_ * 2 // 5))
              for b_ in (2048, 4096)}
    mv_checks += [("block of 1025", mvcc_inputs(1025, 6, 0.3)),
                  ("block of 2048", mv_big[2048]),
                  ("block of 4096", mv_big[4096]),
                  ("RK = WK = 8, block of 1024 (262,272 bytes of shared "
                   "memory on one CTA)", mv_cuda(mv_cases.random_block(
                       1024, 11, nr=8, nw=8, n_accounts=600)))]

    def mv_check(what, ins, want, route=None):
        b_, nr_, _ = ins[0].shape
        taken = route or mv_ops.route_for(b_, nr_, ins[2].shape[1], dev)
        got = mv_ops.validate(*ins, route=route)
        check("validate", [got], [want], f"{what} ({taken} route)")
        log(f"[check] validate {what} ({taken} route): {int(got.sum())} of "
            f"{b_} valid")

    # every block on the route the wrapper takes (one CTA up to 160 txs),
    # and on the other route where the block fits it
    for what, ins in mv_checks:
        b_, nr_, _ = ins[0].shape
        nw_ = ins[2].shape[1]
        want = mv_ref.validate_ref(*ins)
        taken = mv_ops.route_for(b_, nr_, nw_, dev)
        mv_check(what, ins, want)
        other = "tiled" if taken == "cta" else "cta"
        if other == "tiled" or mv_ops.fits_one_cta(b_, nr_, nw_, dev):
            mv_check(what, ins, want, other)
    # hand-made blocks with known verdicts, on both routes: a chain whose
    # verdicts ripple across chunk borders, one key for all, write-write
    # only, empty keys, a key written twice, all reads stale
    for what, make in mv_cases.CASES.items():
        arrays, want = make()
        for route in mv_ops.ROUTES:
            mv_check(f"hand-made {what}", mv_cuda(arrays),
                     torch.from_numpy(want).to(dev), route)

    # K5: the serving shapes (a 2,048-token Qwen2-7B prompt, a ragged one),
    # MHA at D = 96 and MQA in f32, the hybrid and encdec families' D = 64
    # shapes, causal or not, Skv = S or not; SDPA's distance from the plain
    # version for information.
    def qkv(shape, dtype, seed):
        b_, s_, skv_, h_, kv_, d_ = shape
        g_ = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn((b_, n_s, n, d_), generator=g_, device=dev
                            ).to(getattr(torch, dtype))
                for n_s, n in ((s_, h_), (skv_, kv_), (skv_, kv_))]

    def sdpa(q_, k_, v_, causal):
        return F.scaled_dot_product_attention(
            q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
            is_causal=causal, enable_gqa=True).transpose(1, 2)

    for i, (shape, dtype, causal) in enumerate(FLASH_CASES):
        q_, k_, v_ = qkv(shape, dtype, i)
        got = fa_ops.flash_attention(q_, k_, v_, causal=causal).float()
        want = fa_ref.flash_attention_ref(q_.float(), k_.float(), v_.float(),
                                          causal=causal)
        atol, rtol = ((fa_ref.F32_TOL, fa_ref.F32_TOL) if dtype == "float32"
                      else (fa_ref.BF16_ATOL, fa_ref.BF16_RTOL))
        e = float((got - want).abs().max())
        e_lib = float((sdpa(q_, k_, v_, causal).float() - want).abs().max())
        errs["flash_attention"] = max(errs["flash_attention"], e)
        mask = "causal" if causal else "no mask"
        log(f"[check] flash_attention (B, S, Skv, H, Hkv, D) = {shape} "
            f"{dtype} {mask}: max_abs_err {e} (atol {atol}, rtol {rtol}); "
            f"SDPA's max_abs_err {e_lib}")
        if not torch.allclose(got, want, atol=atol, rtol=rtol):
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version at {shape} {dtype} {mask}")
        del q_, k_, v_, got, want
    torch.cuda.synchronize()
    phase_done("2 kernels vs plain", t0)

    # -- 3. timing at the main path's shapes -------------------------------
    t0 = time.perf_counter()
    ne, w = r3.shape[0], msg_block.shape[1]
    b = mv_block[0].shape[0]
    wk_path, wv_path, act_path = w_path
    ins_path = (T(wk_path), T(wv_path), torch.from_numpy(act_path).to(dev))
    applied = act_path & (wk_path[:, 0] != 0)
    n_applied = int(applied.sum())
    chain = int(np.bincount(wk_path[applied, 0] & (nb - 1)).max())
    t_commit = [t.clone() for t in table]  # written by every timed call
    # one untimed application first: every timed call, and each bound,
    # sees the table as the writes leave it
    ht_ops.commit(*t_commit, *ins_path)

    def lookup_bound(qs):
        """The queries read, the bucket row of keys of each non-empty
        query read once however many queries share it, each slot a query
        hits read once (version and values), and the outputs written; two
        word compares a slot a query."""
        live = qs[:, 0] != 0
        qn = int(live.sum())
        rows = int(torch.unique(qs[live, 0] & (nb - 1)).numel())
        found_, _, _, slot_ = ht_ops.lookup(*table, qs)
        hit_slots = int(torch.unique(
            (qs[found_, 0] & (nb - 1)).long() * slots
            + slot_[found_].long()).numel())
        q_ = qs.shape[0]
        return bound_ms(8 * q_ + 8 * slots * rows
                        + 4 * (1 + dims.vw) * hit_slots
                        + q_ * (1 + 4 + 4 * dims.vw + 4), 2 * slots * qn)

    def commit_bound(tab, wk, wv, act):
        """The writes read once; each bucket row that an applying write
        goes to read once (keys); each slot that ends up written written
        once (key, version, values), with its version read where the key
        was stored already; two word compares a slot for each applying
        write. The written slots of a bucket are its distinct stored keys
        that the writes update plus as many of its distinct new keys as it
        has empty slots; counted on ``tab`` as the timed calls see it."""
        app = act & (wk[:, 0] != 0)
        wka = wk[app]
        ub, inv = np.unique(wka[:, 0] & np.uint32(nb - 1),
                            return_inverse=True)
        rows = u32.to_numpy(tab[0][torch.from_numpy(ub.astype(np.int64))
                                   .to(dev)].cpu())
        n_slots = n_upd = 0
        for r, row in enumerate(rows):
            keys_ = {tuple(x) for x in wka[inv == r]}
            stored = {tuple(x) for x in row if x[0] != 0}
            upd = len(keys_ & stored)
            n_upd += upd
            n_slots += upd + min(len(keys_ - stored),
                                 int((row[:, 0] == 0).sum()))
        return bound_ms(wk.size * 4 + wv.size * 4 + act.size + 4
                        + 8 * slots * len(ub) + 4 * n_upd
                        + n_slots * (8 + 4 + 4 * dims.vw),
                        2 * slots * int(app.sum())) + (len(ub), n_slots)

    def validate_bound(ins):
        """The keys, versions and flags read once, the verdicts written;
        the compares each tx's keys need against the valid txs before
        it."""
        b_, nr_, _ = ins[0].shape
        nw_ = ins[2].shape[1]
        v_ = mv_ref.validate_ref(*ins).long()
        return bound_ms(4 * b_ * (2 * nr_ + 2 * nr_ + 2 * nw_) + 2 * b_,
                        2 * nw_ * (nr_ + nw_) * int((torch.cumsum(v_, 0)
                                                     - v_).sum()))
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
            bound=lookup_bound(q200),
            shape="200 queries on a 2^20 x 8 table"),
        "commit": dict(
            name="hash_table.commit", kernel="commit_runs_kernel",
            source="src/repro_torch/kernels/csrc/hash_table.cu",
            replaces="src/repro/kernels/hash_table/kernel.py:167",
            fn=lambda: ht_ops.commit(*t_commit, *ins_path),
            plain=lambda: ht_ref.commit_ref(*t_commit, *ins_path),
            bound=commit_bound(t_commit, *w_path),
            shape="200 writes into a 2^20 x 8 table"),
        "validate": dict(
            name="mvcc_validate.validate", kernel="mvcc_kernel",
            source="src/repro_torch/kernels/csrc/mvcc_validate.cu",
            replaces="src/repro/kernels/mvcc_validate/kernel.py:71",
            fn=lambda: mv_ops.validate(*mv_block),
            plain=lambda: mv_ref.validate_ref(*mv_block),
            bound=validate_bound(mv_block),
            shape="block of 100, RK = WK = 2"),
    }
    # K5 at one Qwen2-7B layer's prefill of a 2,048-token prompt: Q, K, V
    # read and O written once; 4 operations (QK^T and PV multiply-adds) for
    # each of the S(S+1)/2 causal (query, key) pairs of each head and dim.
    (fb, fs, _, fh, fkv, fd), _, _ = FLASH_CASES[0]
    fq, fk, fv = qkv(FLASH_CASES[0][0], "bfloat16", 100)
    fq_t, fk_t, fv_t = (x.transpose(1, 2).contiguous() for x in (fq, fk, fv))
    timing["flash_attention"] = dict(
        name="flash_attention",
        kernel="flash_fwd",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:94",
        fn=lambda: fa_ops.flash_attention(fq, fk, fv, causal=True),
        plain=lambda: fa_ref.flash_attention_ref(fq, fk, fv, causal=True),
        library=lambda: F.scaled_dot_product_attention(
            fq_t, fk_t, fv_t, is_causal=True, enable_gqa=True),
        bound=bound_ms(2 * fb * fs * (2 * fh + 2 * fkv) * fd,
                       4 * fb * fs * (fs + 1) // 2 * fh * fd,
                       TC_BF16_OPS_PER_S),
        shape=f"(B, S, H, Hkv, D) = {(fb, fs, fh, fkv, fd)} bf16, causal")
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
    # K5 and SDPA in turns (K5, SDPA, K5, SDPA) at each timed shape.
    fa_t["turns"] = []
    for *shape, causal in FLASH_TIMED:
        tq, tk, tv = qkv(shape, "bfloat16", 200)
        tq_t, tk_t, tv_t = (x.transpose(1, 2).contiguous()
                            for x in (tq, tk, tv))
        n_bytes, flop = flash_fwd_work(*shape, causal)
        t_bound, t_by = bound_ms(n_bytes, flop, TC_BF16_OPS_PER_S)
        k5, lib = [], []
        for _ in range(2):
            k5.append(event_ms(
                lambda: fa_ops.flash_attention(tq, tk, tv, causal=causal),
                500))
            lib.append(event_ms(lambda: F.scaled_dot_product_attention(
                tq_t, tk_t, tv_t, is_causal=causal, enable_gqa=True), 500))
        k5_ms, lib_ms = sum(k5) / 2, sum(lib) / 2
        k5_dev = device_total_ms(
            lambda: fa_ops.flash_attention(tq, tk, tv, causal=causal))
        lib_dev = device_total_ms(lambda: F.scaled_dot_product_attention(
            tq_t, tk_t, tv_t, is_causal=causal, enable_gqa=True))
        fa_t["turns"].append({
            "shape": shape, "causal": causal, "ms": k5, "sdpa_ms": lib,
            "bound_ms": t_bound, "bound_by": t_by, "device_ms": k5_dev,
            "sdpa_device_ms": lib_dev, "tflops": flop / k5_dev / 1e9,
            "sdpa_tflops": flop / lib_dev / 1e9})
        mask = "causal" if causal else "no mask"
        log(f"[time] flash_attention (B, S, Skv, H, Hkv, D) = {tuple(shape)} "
            f"bf16 {mask}, in turns with "
            f"SDPA: K5 {k5} ms, SDPA {lib} ms (events, K5 / SDPA "
            f"{k5_ms / lib_ms:.3f}); device K5 {k5_dev:.5f} ms "
            f"({flop / k5_dev / 1e9:.1f} TFLOP/s, {t_bound / k5_dev * 100:.2f} "
            f"% of its {t_bound:.7f} ms bound, by {t_by}), SDPA "
            f"{lib_dev:.5f} ms ({flop / lib_dev / 1e9:.1f} TFLOP/s); K5 / "
            f"SDPA {k5_dev / lib_dev:.3f}")
        del tq, tk, tv, tq_t, tk_t, tv_t
    timing["flash_attention_bwd"] = flash_bwd_timing(dev)
    # K1's ordered schedule: the verify block at step 1 (the serial check),
    # 16 (a tile) and 100 (whole), the serial admission of a ladder round,
    # and the launch floor; device time per step (the launch's device time
    # over its ceil(b / step) steps).
    mac_t = timing["mac_many"]
    mac_t["extra"] = {"schedules": []}
    adm_msg = T(rng.integers(0, 1 << 32, (LADDER_TXS, 3), dtype=np.uint32))
    for what, msg, (r, s), st in (
            ("verify 100x22x3", msg_block, (r3, s3), 1),
            ("verify 100x22x3", msg_block, (r3, s3), 16),
            ("verify 100x22x3", msg_block, (r3, s3), 100),
            (f"admission {LADDER_TXS}x3x1", adm_msg, (r1, s1), 1),
            ("launch floor 1x1x1", T(np.array([[7]], np.uint32)), (r1, s1),
             1)):
        def fn(msg=msg, r=r, s=s, st=st):
            return mac_ops.mac_many(msg, r, s, st)
        rows, words = msg.shape
        n_steps = -(-rows // st)
        bnd = bound_ms(4 * (msg.numel() + 2 * r.numel() + rows * r.numel()),
                       2 * rows * r.numel() * words)
        ms_ = event_ms(fn, 200)
        dev_ = device_ms(fn, "mac_kernel")
        mac_t["extra"]["schedules"].append({
            "shape": what, "step": st, "steps": n_steps, "ms": ms_,
            "device_ms": dev_, "bound_ms": bnd[0], "bound_by": bnd[1],
            "device_us_per_step": dev_ / n_steps * 1e3 if dev_ else None})
        log(f"[time] sig_mac.mac_many {what} step {st} ({n_steps} ordered "
            f"steps, one launch): {ms_:.6f} ms per call, device {dev_} ms, "
            f"{dev_ / n_steps * 1e3 if dev_ else None} us of device time a "
            f"step; bound {bnd[0]:.9f} ms ({bnd[1]})")
    # K4: the scan is ceil(b / 32) dependent chunk steps in one warp after
    # the parallel conflict words; report the device time per chunk (the
    # launch's device time over its chunks) at 100 and 1024 txs.
    # K4 past the main path's block: 1,024 txs on one CTA, 2,048 and 4,096
    # on the tiled route (two launches); device time a call (both
    # kernels) and a chunk.
    floor = next(x for x in mac_t["extra"]["schedules"]
                 if x["shape"].startswith("launch floor"))["device_ms"]
    mv_t = timing["validate"]
    mv_t["extra"] = {"launch_floor_ms": floor}
    for bb, ins in ((1024, mv_1024), (2048, mv_big[2048]),
                    (4096, mv_big[4096])):
        nr_, nw_ = ins[0].shape[1], ins[2].shape[1]
        route = mv_ops.route_for(bb, nr_, nw_, dev)
        bnd = validate_bound(ins)
        ms_ = event_ms(lambda: mv_ops.validate(*ins), 200)
        dev_ = device_call_ms(lambda: mv_ops.validate(*ins), ("mvcc_",))
        # the tiled route's two kernels apart: conflict words, then scan
        parts = {n: device_call_ms(lambda: mv_ops.validate(*ins), (n,))
                 for n in ("mvcc_conf_kernel", "mvcc_scan_kernel")
                 } if route == "tiled" else {}
        nch = -(-bb // 32)
        mv_t["extra"][f"b{bb}"] = {
            "route": route, "launches": 1 if route == "cta" else 2,
            "ms": ms_, "device_ms": dev_, "bound_ms": bnd[0],
            "bound_by": bnd[1], "chunks": nch,
            "device_us_per_chunk": dev_ / nch * 1e3, "kernels_ms": parts}
        log(f"[time] mvcc_validate.validate (block of {bb}, RK = WK = 2, "
            f"{route} route, {1 if route == 'cta' else 2} launches): "
            f"{ms_:.6f} ms per call, device {dev_:.8f} ms "
            f"({dev_ / nch * 1e3:.5f} us a chunk over {nch}; {parts}), "
            f"bound {bnd[0]:.9f} ms ({bnd[1]})")
    log(f"[time] mvcc_validate.validate: block of {b}, "
        f"{-(-b // 32)} chunk steps, "
        f"{mv_t['device_ms'] / -(-b // 32) * 1e3:.5f} us of device time a "
        f"chunk")
    # K4 over NB independent blocks in one call (phase 14 (d)).
    mv_t["extra"]["blocks"] = k4_blocks(dev)
    # K4's two routes, each forced, at the block sizes where the wrapper
    # chooses between them (RK = WK = 2, dense conflicts): wrapper and
    # device time a call, the route the wrapper takes beside them.
    mv_t["extra"]["routes"] = []
    for bb in ROUTE_SWEEP:
        ins = mv_cuda(mv_cases.random_block(bb, 40 + bb,
                                            n_accounts=max(48, bb * 2 // 5)))
        row = {"txs": bb, "taken": mv_ops.route_for(bb, 2, 2, dev)}
        for route in mv_ops.ROUTES:
            def fn(ins=ins, route=route):
                return mv_ops.validate(*ins, route=route)
            row[route] = {"ms": event_ms(fn, 200),
                          "device_ms": device_call_ms(fn, ("mvcc_",))}
        mv_t["extra"]["routes"].append(row)
        log(f"[time] mvcc_validate.validate routes, block of {bb}: one CTA "
            f"{row['cta']['ms']:.6f} ms per call, device "
            f"{row['cta']['device_ms']:.8f} ms; tiled "
            f"{row['tiled']['ms']:.6f} ms per call, device "
            f"{row['tiled']['device_ms']:.8f} ms; the wrapper takes "
            f"{row['taken']}")
    # K2 at 8,192 queries; K3 at 2,048 and 4,096 writes and on the hot
    # bucket (64 writes of 6 keys into one bucket, a run of 58 active
    # writes); each beside the launch floor (K1 at 1 x 1 x 1).
    lk_t, cm_t = timing["lookup"], timing["commit"]
    lk_t["extra"] = {"launch_floor_ms": floor}
    bnd = lookup_bound(q8192)
    ms_ = event_ms(lambda: ht_ops.lookup(*table, q8192), 200)
    dev_ = device_call_ms(lambda: ht_ops.lookup(*table, q8192),
                          ("lookup_kernel",))
    lk_t["extra"]["q8192"] = {"ms": ms_, "device_ms": dev_,
                              "bound_ms": bnd[0], "bound_by": bnd[1]}
    log(f"[time] hash_table.lookup (8192 queries): {ms_:.6f} ms per call, "
        f"device {dev_:.8f} ms, bound {bnd[0]:.9f} ms ({bnd[1]}); launch "
        f"floor {floor} ms")
    cm_t["extra"] = {"launch_floor_ms": floor}
    for what, (wk, wv, act) in (("k2048", writes(2048, 12, 1024)),
                                ("k4096", writes(4096, 15, 2048)),
                                ("hot_bucket", w_hot)):
        ins = (T(wk), T(wv), torch.from_numpy(act).to(dev))
        ht_ops.commit(*t_commit, *ins)
        bnd = commit_bound(t_commit, wk, wv, act)
        ms_ = event_ms(lambda: ht_ops.commit(*t_commit, *ins), 200)
        dev_ = device_call_ms(lambda: ht_ops.commit(*t_commit, *ins),
                              ("commit_",))
        cm_t["extra"][what] = {"ms": ms_, "device_ms": dev_,
                               "bound_ms": bnd[0], "bound_by": bnd[1],
                               "writes": len(wk), "rows": bnd[2],
                               "slots_written": bnd[3]}
        log(f"[time] hash_table.commit ({what}, {len(wk)} writes): "
            f"{ms_:.6f} ms per call, device {dev_:.8f} ms, bound "
            f"{bnd[0]:.9f} ms ({bnd[1]}; {bnd[2]} rows read, {bnd[3]} slots "
            f"written); launch floor {floor} ms")
    cbnd = timing["commit"]["bound"]
    log(f"[time] hash_table.commit: {n_applied} applied writes, longest "
        f"same-bucket chain {chain}; bound {cbnd[0]:.9f} ms ({cbnd[2]} rows "
        f"read, {cbnd[3]} slots written)")
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
    want_k = k1_k4_launches(stats)
    if any(launches[k] != n for k, n in want_k.items()):
        raise AssertionError(f"fastfabric: K1/K4 launches {launches}, "
                             f"expected {want_k}")
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
    # The baseline recovery, for phase 11: verify and replay the whole
    # unpruned chain on the card.
    t1 = time.perf_counter()
    full = recovery.full_replay(eng.store, dims, n_buckets=nb, slots=slots)
    torch.cuda.synchronize()
    full_replay_s = time.perf_counter() - t1
    if not np.array_equal(full.state_digest, on_card["peer"][0]):
        raise AssertionError("full_replay's state differs from the peer's")
    full_replay_blocks = full.replayed_records
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
                e.run_round(conflicting_proposals(LADDER_CONFLICT_TXS, 3,
                                                  e.device)),
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
        want_k = k1_k4_launches(st)
        if any(got[k] != n for k, n in want_k.items()):
            raise AssertionError(f"{name}: K1/K4 launches {got}, expected "
                                 f"{want_k}")
        if not all(lverdict.values()):
            raise AssertionError(f"{name}: verify() failed on the card: "
                                 f"{lverdict}")
        if (st[1].n_valid != st[1].n_txs
                or not 0 < st[2].n_valid < LADDER_CONFLICT_TXS):
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

    # -- 8. large blocks: P-I+II, blocks of 2,048, card against CPU --------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    bcfg = engine.EngineConfig(
        dims=dims, orderer=orderer.OrdererConfig(block_size=BIG_BLOCK),
        peer=committer.OPT_P2, n_buckets=nb, slots=slots)
    k4_route = mv_ops.route_for(BIG_BLOCK, dims.rk, dims.wk, dev)

    def big_round(e):
        return e.run_round(e.make_proposals(BIG_ROUND, seed=5,
                                            n_accounts=N_ACCOUNTS))

    zero_counts()
    e = engine.FabricEngine(bcfg)
    bst = big_round(e)
    bverdict = e.verify()
    got = counts()
    path_launches["large_blocks"] = got
    card_res = results(e)
    e.store.close()
    del e
    card_s = time.perf_counter() - t0
    want_k = k1_k4_launches([bst], 1 if k4_route == "cta" else 2)
    if not all(got[k] for k in ("mac_many", "lookup", "commit",
                                "validate")):
        raise AssertionError(f"large blocks: a kernel of the path never "
                             f"ran: {got}")
    if any(got[k] != n for k, n in want_k.items()):
        raise AssertionError(f"large blocks: K1/K4 launches {got}, "
                             f"expected {want_k}")
    if not all(bverdict.values()) or bst.n_valid != bst.n_txs:
        raise AssertionError(f"large blocks: verify {bverdict}, "
                             f"{bst.n_valid} of {bst.n_txs} valid")
    t1 = time.perf_counter()
    e_cpu = engine.FabricEngine(bcfg, device="cpu")
    cbst = big_round(e_cpu)
    if e_cpu.verify() != bverdict:
        raise AssertionError("large blocks: CPU verify() differs")
    same_results(card_res, results(e_cpu), "large blocks")
    e_cpu.store.close()
    del e_cpu
    large = {"block_size": BIG_BLOCK, "k4_route": k4_route,
             "round": bst._asdict(), "peer_tps": bst.n_txs / bst.commit_s,
             "cpu_round": cbst._asdict(), "launches": got,
             "verify": bverdict, "card_s": card_s,
             "cpu_s": time.perf_counter() - t1}
    log(f"[large] P-I+II, blocks of {BIG_BLOCK}: {bst.n_txs} txs in "
        f"{bst.n_blocks} blocks, {bst.n_valid} valid, {bst.tps:.2f} tx/s, "
        f"order {bst.order_s:.4f} s, commit {bst.commit_s:.4f} s, replay "
        f"{bst.replay_s:.4f} s; K4 on its {k4_route} route; launches {got}; "
        f"verify all True; CPU identical (chain and validity bits, log "
        f"head, journal head, state digest; {cbst.tps:.2f} tx/s, "
        f"{large['cpu_s']:.1f} s)")
    phase_done("8 large blocks, card against CPU", t0)

    # -- 9. serving at full width: Qwen2-7B, bf16, on the card -------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    scfg = cfg_base.get(SERVE_ARCH)
    model, eng, reqs, serving = serve_traffic(
        dev, scfg, counts, zero_counts, seed=args.seed, tag="serve")
    path_launches["serving"] = serving["launches"]
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
    serving["alone_agree"] = agree = sum(a == b for a, b in zip(alone,
                                                                r.out))
    log(f"[serve] request {r.rid} alone agrees on {agree} of {SERVE_NEW} "
        f"tokens")
    # Where the time goes: one prefill (the 2,048-token prompt) and one
    # decode step over the 4 slots.
    serving["profile"] = serve_profile(model, eng, reqs[0].prompt,
                                       "serve-profile")
    del eng, model, cache, logits
    torch.cuda.empty_cache()
    phase_done("9 serving at full width", t0)

    # -- 10. serving, card against CPU: 2 layers, full width, f32 -----------
    t0 = time.perf_counter()
    serving["vs_cpu"] = serve_check(
        dev, dataclasses.replace(scfg, n_layers=2, dtype="float32"), counts,
        zero_counts, seed=args.seed, tag="serve-check")
    path_launches["serving_vs_cpu"] = serving["vs_cpu"]["launches"]
    torch.cuda.empty_cache()
    phase_done("10 serving, card against CPU", t0)

    # -- 11. durability on the card: journal, snapshots, recovery ----------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    tmp = tempfile.TemporaryDirectory()

    def durable_cfg(root):
        return dataclasses.replace(
            cfg, snapshot_every_blocks=DURABLE_EVERY,
            snapshot_dir=os.path.join(root, "snap"),
            journal_dir=os.path.join(root, "jrnl"),
            block_dir=os.path.join(root, "blocks"))

    def durable_rounds(e):
        return [e.run_round(e.make_proposals(n, seed=s,
                                             n_accounts=N_ACCOUNTS))
                for s, n in enumerate(DURABLE_ROUNDS)]

    def heads(e):
        ps = e.peer_state
        return {"digest": u32.to_numpy(ws.state_digest(ps.hash_state)),
                "journal_head": u32.to_numpy(ps.journal_head),
                "ledger_head": u32.to_numpy(ps.ledger_head),
                "next_block_no": e.next_block_no,
                "overflow_bits": e.overflow_bits()}

    def same_heads(a, b, what, keys=None):
        for k in keys or a:
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f"{what}: {k} {a[k]} != {b[k]}")

    def same_files(da, db, what):
        """Same names; in each npz the same keys, dtypes and arrays."""
        names = sorted(os.listdir(da))
        if names != sorted(os.listdir(db)):
            raise AssertionError(f"{what}: files differ: {names} vs "
                                 f"{sorted(os.listdir(db))}")
        for name in names:
            with np.load(os.path.join(da, name)) as za, \
                    np.load(os.path.join(db, name)) as zb:
                if sorted(za.files) != sorted(zb.files) or not all(
                        za[k].dtype == zb[k].dtype
                        and np.array_equal(za[k], zb[k]) for k in za.files):
                    raise AssertionError(f"{what}: {name} differs")
        return names

    def sizes(root):
        out = {}
        for sub in ("snap", "jrnl", "blocks"):
            names = os.listdir(os.path.join(root, sub))
            out[sub] = {"files": len(names), "bytes": sum(
                os.path.getsize(os.path.join(root, sub, n)) for n in names)}
        return out

    def tampered_restore(src, dst, path_of, key, what):
        """Copy ``src``, flip one bit of ``key`` in the file ``path_of``
        names (in the first occupied slot of a shard), and require
        restore() to refuse the copy."""
        shutil.copytree(src, dst)
        path = path_of(dst)
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        at = (tuple(int(i) for i in np.argwhere(
            arrays["keys"][..., 0] != 0)[0]) + (0,)
              if "keys" in arrays else (0,) * arrays[key].ndim)
        arrays[key][at] ^= np.uint32(1)
        np.savez(path, **arrays)
        try:
            engine.FabricEngine.restore(durable_cfg(dst))
        except recovery.RecoveryError as err:
            log(f"[durable] tampered {what} ({os.path.basename(path)}, "
                f"{key}{list(at)}): restore refused: {err}")
        else:
            raise AssertionError(f"restore accepted a tampered {what}")
        finally:
            shutil.rmtree(dst)

    card_root = os.path.join(tmp.name, "card")
    reg = Registry()
    zero_counts()
    e = engine.FabricEngine(dataclasses.replace(durable_cfg(card_root),
                                                obs=Obs(registry=reg)))
    dst = durable_rounds(e)
    got = counts()
    path_launches["durable"] = got
    want_k = k1_k4_launches(dst)
    if not all(got[k] for k in ("mac_many", "lookup", "validate")):
        raise AssertionError(f"durable: a kernel of the path never ran: "
                             f"{got}")
    if any(got[k] != n for k, n in want_k.items()):
        raise AssertionError(f"durable: K1/K4 launches {got}, expected "
                             f"{want_k}")
    n_blocks = sum(st.n_blocks for st in dst)
    snap_blocks = [sn.block_no for sn in e.snapshots]
    if (e.journal is None or n_blocks != 25 or snap_blocks != [9, 19]
            or e.store.base_block_no != 9):
        raise AssertionError(f"durable: {n_blocks} blocks, snapshots "
                             f"{snap_blocks}, chain base "
                             f"{e.store.base_block_no}")
    t1 = time.perf_counter()
    dverdict = e.verify()
    dverify_s = time.perf_counter() - t1
    if not all(dverdict.values()):
        raise AssertionError(f"durable: verify() failed on the card: "
                             f"{dverdict}")
    t1 = time.perf_counter()
    rec = e.recover()
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t1
    live = heads(e)
    if (rec.snapshot_block_no, rec.block_no, rec.replayed_records) != (
            19, 24, 5) or not rec.state.keys.is_cuda:
        raise AssertionError(f"durable: recover() from block "
                             f"{rec.snapshot_block_no} replayed "
                             f"{rec.replayed_records} records to "
                             f"{rec.block_no}")
    t1 = time.perf_counter()
    snap_again = snapshot.take(
        e.peer_state.hash_state, block_no=24,
        journal_head=e.peer_state.journal_head,
        ledger_head=e.peer_state.ledger_head)
    take_s = time.perf_counter() - t1
    if not np.array_equal(snap_again.state_digest, live["digest"]):
        raise AssertionError("durable: a snapshot's digest differs from "
                             "the peer's")
    del snap_again
    storage = sizes(card_root)
    log(json.dumps({"storage": storage, "table_words": nb * slots * (
        3 + dims.vw), "blocks": n_blocks, "snapshots": snap_blocks}))

    # The same rounds on the CPU, into their own directories.
    t1 = time.perf_counter()
    cpu_root = os.path.join(tmp.name, "cpu")
    ec = engine.FabricEngine(durable_cfg(cpu_root), device="cpu")
    cdst = durable_rounds(ec)
    ec.store.drain()
    same_heads(live, heads(ec), "durable, card against CPU")
    if [st.n_valid for st in cdst] != [st.n_valid for st in dst]:
        raise AssertionError("durable: valid counts differ on the CPU")
    files = {sub: same_files(os.path.join(card_root, sub),
                             os.path.join(cpu_root, sub),
                             f"durable {sub}, card against CPU")
             for sub in ("snap", "jrnl", "blocks")}
    for bno in (9, 19):
        a, b = (snapshot.load_manifest(snapshot.path_for(
            os.path.join(r, "snap"), bno)) for r in (card_root, cpu_root))
        if not all(np.array_equal(getattr(a, f), getattr(b, f))
                   for f in a._fields):
            raise AssertionError(f"durable: manifest {bno} differs")
    if len(e.journal.records) != len(ec.journal.records) or not all(
            x.block_no == y.block_no and all(
                np.array_equal(getattr(x, f), getattr(y, f))
                for f in ("write_keys", "write_vals", "valid", "prev_head",
                          "head"))
            for x, y in zip(e.journal.records, ec.journal.records)):
        raise AssertionError("durable: journal records differ")
    ec.store.close()
    del ec
    shutil.rmtree(cpu_root)
    cpu_s = time.perf_counter() - t1
    log(f"[durable] CPU identical: manifests {files['snap']}, "
        f"{len(files['jrnl'])} journal records, {len(files['blocks'])} "
        f"spilled blocks, heads and digests; {cpu_s:.1f} s")

    # Tampered copies are refused.
    tampered_restore(
        card_root, os.path.join(tmp.name, "bad_journal"),
        lambda r: os.path.join(r, "jrnl", "journal_00000024.npz"),
        "write_vals", "journal record")
    tampered_restore(
        card_root, os.path.join(tmp.name, "bad_snapshot"),
        lambda r: snapshot.shard_path_for(os.path.join(r, "snap"), 19, 0),
        "values", "snapshot shard")

    # Restore on the card from a copy of the directories alone.
    rest_root = os.path.join(tmp.name, "restore")
    shutil.copytree(card_root, rest_root)
    t1 = time.perf_counter()
    r = engine.FabricEngine.restore(durable_cfg(rest_root))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    same_heads(live, heads(r), "restore against the live engine")
    rverdict = r.verify()
    if not all(rverdict.values()) or r.store.base_block_no != 19 or [
            sb.block_no for sb in r.store.chain] != list(range(20, 25)):
        raise AssertionError(f"restore: verify {rverdict}, chain base "
                             f"{r.store.base_block_no}")
    for x in (e, r):
        x.run_round(x.make_proposals(DURABLE_AFTER, seed=len(DURABLE_ROUNDS),
                                     n_accounts=N_ACCOUNTS))
        x.store.drain()
    same_heads(heads(e), heads(r), "one round after restore",
               ("digest", "journal_head", "ledger_head", "next_block_no"))
    after = heads(r)
    e.store.close()
    r.store.close()
    del e, r
    tmp.cleanup()
    timed = dst[1]
    append = reg.histogram("journal.append.latency").snapshot()
    save = reg.histogram("snapshot.save.latency")
    durability = {
        "card": card,
        "rounds": [st._asdict() for st in dst],
        "timed": {"tps": timed.tps, "order_s": timed.order_s,
                  "commit_s": timed.commit_s, "wall_s": timed.wall_s},
        "phase4_timed": {k: summary[k] for k in ("tps", "order_s",
                                                 "commit_s", "wall_s")},
        "snapshot": {"take_s": take_s, "save_s": save.sum,
                     "saves": save.count,
                     "gc_s": reg.histogram("snapshot.gc.latency").sum,
                     "bytes": reg.counter("snapshot.bytes").value,
                     "on_disk": storage["snap"]},
        "recover_s": recover_s, "recovered_records": rec.replayed_records,
        "full_replay_s": full_replay_s,
        "full_replay_blocks": full_replay_blocks,
        "restore_s": restore_s,
        "journal_append_latency_s": append,
        "journal_appends": reg.counter("journal.appends").value,
        "verify": dverdict, "verify_s": dverify_s,
        "restored_verify": rverdict, "launches": got, "cpu_s": cpu_s,
        "after_restore": {"ledger_head": after["ledger_head"],
                          "journal_head": after["journal_head"]},
    }
    for label, st in zip(("warm-up", "timed", "last"), dst):
        log(f"[durable] {label}: {st.n_txs} txs, {st.tps:.1f} tx/s, order "
            f"{st.order_s:.4f} s, commit {st.commit_s:.4f} s, replay "
            f"{st.replay_s:.4f} s")
    log(f"[durable] journal off (phase 4): {summary['tps']:.1f} tx/s, order "
        f"{summary['order_s']:.4f} s, commit {summary['commit_s']:.4f} s; "
        f"snapshot take {take_s:.3f} s, save {save.sum:.3f} s over "
        f"{save.count}; recover {recover_s:.3f} s ({rec.replayed_records} "
        f"records); full replay {full_replay_s:.3f} s ({full_replay_blocks} "
        f"blocks); restore {restore_s:.3f} s; journal append mean "
        f"{append.get('mean', 0) * 1e3:.3f} ms; launches {got}")
    phase_done("11 durability on the card", t0)

    # -- 12. observability and elastic state on the card -------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    tmp12 = tempfile.TemporaryDirectory()

    def path_ok(name, got, st):
        """Every kernel of the path ran; K1 and K4 as in phase 4."""
        path_launches[name] = got
        want = k1_k4_launches(st)
        if not all(got[k] for k in ("mac_many", "lookup", "validate")):
            raise AssertionError(f"{name}: a kernel of the path never ran: "
                                 f"{got}")
        if any(got[k] != n for k, n in want.items()):
            raise AssertionError(f"{name}: K1/K4 launches {got}, expected "
                                 f"{want}")

    def tripped(e, reason, rec_dir):
        """The recorder tripped on ``reason`` and auto-dumped all five
        files."""
        reasons = [t["reason"] for t in e.recorder.trips]
        if reason not in reasons or set(os.listdir(rec_dir)) != DUMP_FILES:
            raise AssertionError(f"{reason}: trips {reasons}, dump "
                                 f"{sorted(os.listdir(rec_dir))}")
        return reasons

    # (a) Obs on at phase 4's size, in turns with obs off (one engine a
    # turn, a warm-up and a timed round each); the first obs-on engine is
    # the checked one, its launches counted.
    turns, checked = [], None
    for mode in OBS_TURNS:
        c = dataclasses.replace(cfg, obs=mode == "on", recorder_dir=(
            os.path.join(tmp12.name, "rec_a") if mode == "on" else None))
        if checked is None and mode == "on":
            zero_counts()
        e = engine.FabricEngine(c)
        st = [e.run_round(e.make_proposals(ROUND_TXS, seed=s,
                                           n_accounts=N_ACCOUNTS))
              for s in SEEDS]
        turns.append({"obs": mode, **st[-1]._asdict(), "tps": st[-1].tps})
        if checked is None and mode == "on":
            checked = (e, st, counts())
        else:
            e.store.close()
            del e
        torch.cuda.empty_cache()
    e, st, got = checked
    path_ok("obs", got, st)
    same_results(on_card, results(e), "obs on against phase 4's obs off")
    spans = {}
    for r in e.tracer.records():
        spans.setdefault(r["name"], []).append(r)
    n_blocks = sum(s.n_blocks for s in st)
    want_spans = {"round.order": len(st), "round.commit": len(st),
                  "round.endorser_replay": len(st), "block.ship": n_blocks}
    if {k: len(spans.get(k, ())) for k in want_spans} != want_spans or any(
            r["depth"] != 0 for k in ("round.order", "round.commit",
                                      "round.endorser_replay")
            for r in spans[k]) or any(
            (r["depth"], r["parent"]) != (1, "round.commit")
            for r in spans["block.ship"]):
        raise AssertionError(f"obs: spans {sorted(spans)} with counts "
                             f"{ {k: len(v) for k, v in spans.items()} }")
    span_vs_stats = []
    for so, sc, s in zip(spans["round.order"], spans["round.commit"], st):
        pair = {"order": (so["dur"], s.order_s),
                "commit": (sc["dur"], s.commit_s)}
        span_vs_stats.append(pair)
        if any(abs(a - b) > 0.05 * b for a, b in pair.values()):
            raise AssertionError(f"obs: span durations {pair} off "
                                 f"RoundStats by more than 5 %")
    m = e.metrics()
    n_tx, n_valid = sum(s.n_txs for s in st), sum(s.n_valid for s in st)
    phases = ("queue", "order", "validate", "commit")
    phase_sum = sum(m[f"tx.phase.{p}"]["sum"] for p in phases)
    if (any(m[f"tx.phase.{p}"]["count"] != n_tx for p in phases)
            or abs(phase_sum - m["tx.e2e"]["sum"])
            > 1e-9 * m["tx.e2e"]["sum"]
            or m.get("tx.outcome{outcome=valid}") != n_valid):
        raise AssertionError(f"obs: tx phases/outcomes off: {n_tx} txs, "
                             f"{n_valid} valid, metrics {m}")
    verdict = e.health()
    if verdict.status != "healthy" or e.recorder.tripped:
        raise AssertionError(f"obs: health {verdict}, trips "
                             f"{e.recorder.trips}")
    span_summary = {k: {"count": len(v), "ms": sum(r["dur"] for r in v) * 1e3}
                    for k, v in sorted(spans.items())}
    log("[obs] spans: " + ", ".join(
        f"{k} {v['count']}x {v['ms']:.3f} ms"
        for k, v in span_summary.items()))
    # The policy pass's stacked read at 2^20 x 8, then one manual resize of
    # this table to 2^21 (224 MiB -> 448 MiB a table, peer and replica).
    e._shard_stats((0,))
    t1 = time.perf_counter()
    for _ in range(5):
        e._shard_stats((0,))
    stats_read_s = (time.perf_counter() - t1) / 5
    digest = u32.to_numpy(ws.state_digest(e.peer_state.hash_state))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    info = e.resize(nb * 2)
    torch.cuda.synchronize()
    resize_s = time.perf_counter() - t1
    if (info["old_n_buckets"], info["new_n_buckets"],
            e.peer_state.hash_state.n_buckets) != (nb, 2 * nb, 2 * nb) or \
            not np.array_equal(u32.to_numpy(ws.state_digest(
                e.peer_state.hash_state)), digest) or \
            not all(e.verify().values()):
        raise AssertionError(f"obs: resize to 2^21 gave {info}")
    e.store.close()
    del e
    torch.cuda.empty_cache()
    med = lambda mode, k: float(np.median([t[k] for t in turns
                                           if t["obs"] == mode]))
    obs_cost = {k: med("on", k) / med("off", k) - 1
                for k in ("wall_s", "order_s", "commit_s", "replay_s")}
    for t in turns:
        log(f"[obs] turn obs {t['obs']}: {t['tps']:.1f} tx/s, wall "
            f"{t['wall_s']:.4f} s = order {t['order_s']:.4f} + commit "
            f"{t['commit_s']:.4f}; replay {t['replay_s']:.4f} s")
    log("[obs] obs-on cost (medians, on / off - 1): "
        + ", ".join(f"{k} {v * 100:+.2f} %" for k, v in obs_cost.items())
        + f"; policy-pass read at {nb} x {slots} {stats_read_s * 1e3:.3f} "
        f"ms; resize {nb} -> {2 * nb} buckets {resize_s:.4f} s; launches "
        f"{got}")

    # (b) Elastic and durable: the policy grows a small table between
    # rounds; card against CPU, verify, recovery from genesis across every
    # re-anchor, restore from the directories.
    def elastic_cfg(root):
        return dataclasses.replace(
            cfg, n_buckets=ELASTIC_START, obs=True,
            resize_policy=engine.ResizePolicy(grow_free_slots=2),
            snapshot_every_blocks=ELASTIC_EVERY,
            snapshot_dir=os.path.join(root, "snap"),
            journal_dir=os.path.join(root, "jrnl"),
            block_dir=os.path.join(root, "blocks"),
            recorder_dir=os.path.join(root, "rec"))

    def elastic_run(e):
        st = [e.run_round(e.make_proposals(ROUND_TXS, seed=s,
                                           n_accounts=N_ACCOUNTS))
              for s in range(ELASTIC_ROUNDS)]
        e.store.drain()
        return st, {
            "epochs": [r["args"] for r in e.tracer.records()
                       if r["name"] == "resize.epoch"],
            "reanchor_log": list(e.reanchor_log), "n_buckets": e.n_buckets,
            "reanchor_head": np.asarray(e.journal.reanchor_head),
            "valid": [s.n_valid for s in st], **heads(e)}

    card_b = os.path.join(tmp12.name, "elastic_card")
    zero_counts()
    eb = engine.FabricEngine(elastic_cfg(card_b))
    bst, bview = elastic_run(eb)
    path_ok("elastic", counts(), bst)
    n_epochs = len(bview["epochs"])
    if n_epochs < 2 or eb.overflowed() or any(
            ep["new_n_buckets"] != 2 * ep["old_n_buckets"]
            for ep in bview["epochs"]):
        raise AssertionError(f"elastic: epochs {bview['epochs']}, overflow "
                             f"{eb.overflow_bits()}")
    bverdict = eb.verify()
    if not all(bverdict.values()):
        raise AssertionError(f"elastic: verify {bverdict}")
    t1 = time.perf_counter()
    genesis = recovery.recover(eb.journal, n_buckets=ELASTIC_START,
                               slots=slots, value_width=dims.vw)
    torch.cuda.synchronize()
    genesis_s = time.perf_counter() - t1
    if (genesis.crossed_reanchors, genesis.n_buckets) != (
            n_epochs, eb.n_buckets) or not np.array_equal(
            genesis.state_digest, bview["digest"]) or not np.array_equal(
            genesis.journal_head, bview["journal_head"]):
        raise AssertionError(f"elastic: recovery from genesis crossed "
                             f"{genesis.crossed_reanchors} re-anchors to "
                             f"{genesis.n_buckets} buckets")
    rest_b = os.path.join(tmp12.name, "elastic_restore")
    shutil.copytree(card_b, rest_b)
    rb = engine.FabricEngine.restore(elastic_cfg(rest_b))
    same_heads(heads(eb), heads(rb), "elastic restore against the live "
               "engine")
    rverdict = rb.verify()
    if rb.n_buckets != eb.n_buckets or rb.peer_state.hash_state.n_buckets \
            != eb.n_buckets or not all(rverdict.values()):
        raise AssertionError(f"elastic restore: {rb.n_buckets} buckets, "
                             f"verify {rverdict}")
    rb.store.close()
    del rb
    cpu_b = os.path.join(tmp12.name, "elastic_cpu")
    ec = engine.FabricEngine(elastic_cfg(cpu_b), device="cpu")
    _, cview = elastic_run(ec)
    for k in bview:
        if not (np.array_equal(bview[k], cview[k])
                if isinstance(bview[k], np.ndarray) else
                bview[k] == cview[k]):
            raise AssertionError(f"elastic: {k} differs between card and "
                                 f"CPU: {bview[k]} vs {cview[k]}")
    efiles = {sub: same_files(os.path.join(card_b, sub),
                              os.path.join(cpu_b, sub),
                              f"elastic {sub}, card against CPU")
              for sub in ("snap", "jrnl", "blocks")}
    if len(eb.journal.records) != len(ec.journal.records) or not all(
            x.block_no == y.block_no and all(
                np.array_equal(getattr(x, f), getattr(y, f))
                for f in ("write_keys", "write_vals", "valid", "prev_head",
                          "head"))
            for x, y in zip(eb.journal.records, ec.journal.records)) or [
            tuple(np.asarray(a).tolist() if isinstance(a, np.ndarray)
                  else a for a in r) for r in eb.journal.reanchors] != [
            tuple(np.asarray(a).tolist() if isinstance(a, np.ndarray)
                  else a for a in r) for r in ec.journal.reanchors]:
        raise AssertionError("elastic: journal records differ")
    ec.store.close()
    del ec
    log(f"[elastic] {n_epochs} resize epochs {bview['reanchor_log']} to "
        f"{eb.n_buckets} buckets; card = CPU (epochs, digest, heads, "
        f"{len(efiles['snap'])} snapshot files, {len(efiles['jrnl'])} "
        f"journal files, {len(efiles['blocks'])} blocks); recovery from "
        f"genesis across {genesis.crossed_reanchors} re-anchors "
        f"{genesis_s:.3f} s; restore resumed {eb.n_buckets} buckets")

    # (c) Fault edges: an overflow latch, a resize refused at the ceiling,
    # a verify() contract broken by a flipped journal word.
    rec_o = os.path.join(tmp12.name, "rec_overflow")
    zero_counts()
    es = engine.FabricEngine(dataclasses.replace(
        cfg, n_buckets=8, slots=2, obs=True, recorder_dir=rec_o))
    sst = [es.run_round(es.make_proposals(2 * cfg.orderer.block_size, seed=0,
                                          n_accounts=N_ACCOUNTS))]
    path_ok("overflow", counts(), sst)
    sverdict = es.health()
    if not es.overflowed() or sverdict.status != "critical" or not any(
            "shard" in r and "overflow" in r for r in sverdict.reasons) or \
            es.metrics()["health.status"] != 2:
        raise AssertionError(f"overflow: health {sverdict}")
    tripped(es, "overflow_latch", rec_o)
    es.store.close()
    rec_r = os.path.join(tmp12.name, "rec_refused")
    zero_counts()
    er = engine.FabricEngine(dataclasses.replace(
        cfg, n_buckets=8, slots=2, obs=True, recorder_dir=rec_r,
        resize_policy=engine.ResizePolicy(grow_free_slots=0,
                                          max_buckets=8)))
    rst = [er.run_round(er.make_proposals(2 * cfg.orderer.block_size, seed=s,
                                          n_accounts=N_ACCOUNTS))
           for s in (0, 1)]
    path_ok("refused", counts(), rst)
    reasons = tripped(er, "resize_refused", rec_r)
    if reasons.count("resize_refused") != 1 or er.n_buckets != 8:
        raise AssertionError(f"refused: trips {reasons}")
    er.store.close()
    good = eb.journal.records[-1]
    vals = good.write_vals.copy()
    vals[0, 0, 0] ^= np.uint32(1)
    eb.journal.records[-1] = good._replace(write_vals=vals)
    try:
        tverdict = eb.verify()
    finally:
        eb.journal.records[-1] = good
    why = eb.recorder.trips[-1]["ctx"].get("journal_reason", "")
    tripped(eb, "verify_contract", os.path.join(card_b, "rec"))
    if all(tverdict.values()) or "recomputed head mismatch" not in why:
        raise AssertionError(f"tamper: verify {tverdict}, reason {why!r}")
    eb.store.close()
    del eb
    tmp12.cleanup()
    observability = {
        "card": card, "turns": turns, "obs_cost": obs_cost,
        "spans": span_summary, "span_vs_stats": span_vs_stats,
        "launches": {k: path_launches[k] for k in
                     ("obs", "elastic", "overflow", "refused")},
        "policy_read_s": stats_read_s, "resize_s": resize_s,
        "elastic": {"epochs": bview["epochs"], "verify": bverdict,
                    "genesis_recover_s": genesis_s,
                    "rounds": [s._asdict() for s in bst]},
        "faults": {"overflow": sverdict.to_dict(), "refused": reasons,
                   "verify_contract": why}}
    log(f"[faults] overflow_latch, resize_refused and verify_contract "
        f"tripped and dumped {sorted(DUMP_FILES)}; journal reason: {why}")
    phase_done("12 observability and elastic state", t0)

    # -- 13. the block pipeline on the card ---------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    pipeline = window_phase(cfg, on_card, counts, zero_counts, same_results,
                            path_launches, dev)
    pipeline["card"] = card
    phase13_view = pipeline.pop("view")
    phase_done("13 block pipeline", t0)

    # -- 14. several channels on one card -----------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    channels = channels_phase(cfg, counts, zero_counts, same_results,
                              path_launches, dev, card=card)
    channels["k4_blocks"] = mv_t["extra"]["blocks"]
    phase_done("14 several channels", t0)

    # -- 15. bucket-sharded world state on one card -------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    sharding = sharding_phase(cfg, phase13_view, counts, zero_counts,
                              same_results, path_launches, dev, card=card)
    phase_done("15 sharded state", t0)

    # -- 16. LM training on the card ----------------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    training = training_phase(dev, counts, zero_counts, path_launches,
                              seed=args.seed)
    training["card"] = card
    errs["flash_attention_bwd"] = training["flash_bwd"]["max_abs_err"]
    phase_done("16 training", t0)

    # -- 17. MoE serving at full width --------------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    moe_serving = moe_serving_phase(dev, counts, zero_counts, path_launches,
                                    seed=args.seed)
    moe_serving["card"] = card
    phase_done("17 moe serving", t0)

    # -- 18. Mamba2 at full width -------------------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    ssm_run = ssm_phase(dev, counts, zero_counts, path_launches,
                        seed=args.seed)
    ssm_run["card"] = card
    phase_done("18 ssm", t0)

    # -- 19. Zamba2 (hybrid) at full width -----------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    hybrid = hybrid_phase(dev, counts, zero_counts, path_launches,
                          seed=args.seed)
    hybrid["card"] = card
    phase_done("19 hybrid", t0)

    # -- 20. SeamlessM4T (encoder-decoder) at full width ---------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    encdec = encdec_phase(dev, counts, zero_counts, path_launches,
                          seed=args.seed)
    encdec["card"] = card
    phase_done("20 encdec", t0)

    # -- 21. training the moe, ssm, hybrid and encdec families --------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    family_training = family_training_phase(dev, counts, zero_counts,
                                            path_launches, seed=args.seed)
    family_training["card"] = card
    phase_done("21 family training", t0)

    # -- 22. shards and channels over a (data, model) mesh ------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    mesh_run = mesh_phase(cfg, counts, zero_counts, path_launches,
                          card_mesh(), card=card)
    phase_done("22 mesh", t0)

    # -- 23. the program contracts on the card -------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    from repro_torch.analysis import gate as contract_gate
    analysis = contracts_phase(contract_gate.make_mesh("cuda"), zero_counts,
                               path_launches, card=card)
    phase_done("23 contracts", t0)

    kernels = [{
        "name": t["name"], "route": "cuda", "source": t["source"],
        "replaces": t["replaces"],
        "launches": sum(c.get(key, 0) for c in path_launches.values()),
        "launches_by_path": {p: c.get(key, 0)
                             for p, c in path_launches.items()},
        "max_abs_err": errs[key], "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
        "library_ms": t["library_ms"], "device_ms": t["device_ms"],
        **({"turns": t["turns"]} if "turns" in t else {}),
        **t.get("extra", {}),
    } for key, t in timing.items()]
    log(json.dumps({"engine": summary}, default=str))
    log(json.dumps({"ladder": ladder}, default=str))
    log(json.dumps({"large_blocks": large}, default=str))
    log(json.dumps({"serving": serving}, default=str))
    log(json.dumps({"durability": durability}, default=str))
    log(json.dumps({"observability": observability}, default=str))
    log(json.dumps({"pipeline": pipeline}, default=str))
    log(json.dumps({"channels": channels}, default=str))
    log(json.dumps({"sharding": sharding}, default=str))
    log(json.dumps({"training": training}, default=str))
    log(json.dumps({"moe_serving": moe_serving}, default=str))
    log(json.dumps({"ssm": ssm_run}, default=str))
    log(json.dumps({"hybrid": hybrid}, default=str))
    log(json.dumps({"encdec": encdec}, default=str))
    log(json.dumps({"family_training": family_training}, default=str))
    log(json.dumps({"mesh": mesh_run}, default=str))
    log(json.dumps({"analysis": analysis}, default=str))
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
