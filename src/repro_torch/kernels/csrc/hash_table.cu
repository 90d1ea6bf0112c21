// World-state hash table (Opt P-I): the probe and the sequential commit.
//
// ---- Probe (ht_lookup) ----
//
// Replaces the Pallas kernel src/repro/kernels/hash_table/kernel.py:lookup
// (_lookup_kernel, _probe_row). Q paired keys (k0, k1) are probed against a
// bucket-major table: keys (NB, S, 2), versions (NB, S), values (NB, S, VW),
// bucket = k0 & (NB - 1). A slot matches when both words are equal; a query
// with k0 == 0 (the empty key) never matches. Outputs per query: found, the
// version and value words of the FIRST matching slot (zeros when none), and
// that slot (0 when none, as argmax of an all-false mask gives), which the
// vectorized commit needs (repro.core.world_state.lookup).
//
// The TPU kernel keeps the whole table resident in VMEM and shards it when it
// does not fit. On Hopper the table (224 MiB at 2^20 buckets x 8 slots) lives
// in HBM and a probe needs only its bucket row. Bound: at the main path's
// 200 queries about 25 KB, some 8 ns of HBM time; what a probe costs is
// latency, the launch and its dependent round trips to HBM.
// Design: a group of G lanes probes one query (G = S rounded up to a power
// of two, at most 32; four queries a warp at S = 8). Lane t starts all of
// its loads at once, before any compare: slot t's key, its version and, at
// VW = 4, its four value words as one 16-byte load. So a probe is one HBM
// round trip after the query's own load. A ballot over the group finds the
// hits; its lowest set bit is the first matching slot, and that lane
// writes found, slot, version and the values (one 16-byte store). A miss
// is written by lane 0. The version and value loads of the lanes that miss
// cost bytes, not time: 160 B a query at S = 8, VW = 4. S > 32 walks the
// row 32 slots at a time and keeps the first segment that hits; other VW
// load the values after the hit.

// ---- Sequential commit (ht_commit) ----
//
// Replaces the Pallas kernel src/repro/kernels/hash_table/kernel.py:commit
// (_commit_kernel), which the engine runs as
// repro.core.world_state.commit_sequential under OPT_P1 and OPT_P2. K writes
// (keys (K, 2), values (K, VW), active (K,) bytes) are applied IN PLACE, one
// at a time in flat order. Write i applies when active[i] and k0 != 0: the
// first slot of bucket k0 & (NB - 1) whose two words match takes version + 1
// (u32 wrap); if none matches, the first empty slot (k0 == 0) takes the key
// and version 1; if there is none either, the write is dropped and the
// sticky overflow word is set. Keys and values are written.
//
// The TPU kernel walks all K writes in one grid step on a VMEM-resident
// table. Only the order of writes WITHIN a bucket matters, so buckets go in
// parallel, and each bucket's run of writes is applied with its row in
// registers (commit_runs_kernel):
// * Partition. The buckets are split into P parts by a multiplicative hash
//   (P a power of two, about K/32, at most 1,024), one CTA a part, so a
//   CTA gets about 32 writes and one launch spreads any K over the card.
// * Phase 1, per CTA. Its threads read the writes in tiles of 256
//   (coalesced, four tiles a round trip) and
//   keep the applying writes of the CTA's part, in flat order, in shared
//   memory (a ballot and a prefix over the warps): index, key, bucket.
//   Then each staged write finds, by a scan of shared memory, whether it
//   leads its bucket's run (no earlier staged write has its bucket) and the
//   next write of its run. Inactive and empty-key writes are never staged,
//   so they join no run and cannot move a first-empty choice.
// * Phase 2. A group of G lanes (S rounded up to a power of two) takes
//   each run leader: lane t loads slot t's key and version once, then the
//   group walks the run (reading each next write while it applies one),
//   and for each write takes a ballot of the slots that match; the first
//   match bumps its version, else the lowest slot of the group's mask of
//   empty slots takes the key and version 1 and leaves the mask, else the
//   write is dropped. A lane remembers the last write it took; at the
//   end only those lanes write back their key, version and that write's
//   values. A chain of writes to one bucket costs a ballot and a
//   shared-memory read a write, not an HBM round trip. Groups own disjoint
//   buckets: no races; a group that dropped a write sets the overflow word
//   with one atomicOr.
// * S > 32: a row is more slots than a warp has lanes, so the 32-lane group
//   walks it in memory, 32 slots at a time, for each write of the run (the
//   first segment with a match, else the first with an empty slot), and
//   the lane of the slot it takes writes it at once. Same partition, runs
//   and choices as above.
// * A CTA stages at most 1,024 writes at a time; when more of its part's
//   writes come, it applies what it holds (in order) before staging more,
//   so no K is refused.
// Bound: bytes (the writes read once, each bucket row that a write applies
// to read once, each slot written once), about 20 KB at the main path's
// K = 200: latency-bound, three dependent round trips (the writes, the
// rows, the values) after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLookupThreads = 128;
constexpr int kCommitThreads = 256;
constexpr int kCap = 1024;  // writes a commit CTA stages at a time
constexpr int kLoadTiles = 4;  // tiles of writes a commit CTA loads at once
constexpr uint32_t kGolden = 0x9E3779B1u;  // hashes a bucket to its part
constexpr int kPartWrites = 32;  // writes a part gets, about
constexpr int kMaxPartBits = 10;  // at most 1,024 parts

__device__ __forceinline__ unsigned group_bits(unsigned ballot, int base_lane,
                                               unsigned gmask) {
  return (ballot & gmask) >> base_lane;
}

template <int kG>
__device__ __forceinline__ unsigned group_mask(int base_lane) {
  return (kG == 32 ? kFull : ((1u << kG) - 1u)) << base_lane;
}

// kG lanes a query; kVW = 4 loads the values with the keys as one uint4
// (the table's and output's values 16-byte aligned), 0 loads VW = vw words
// after the hit.
template <int kG, int kVW>
__global__ void __launch_bounds__(kLookupThreads)
lookup_kernel(const uint32_t* __restrict__ tkeys,
              const uint32_t* __restrict__ tvers,
              const uint32_t* __restrict__ tvals,
              const uint32_t* __restrict__ queries,
              uint8_t* __restrict__ found, uint32_t* __restrict__ vers,
              uint32_t* __restrict__ vals, int32_t* __restrict__ slot, int q,
              uint32_t nb_mask, int s, int vw) {
  const int qi = (blockIdx.x * blockDim.x + threadIdx.x) / kG;
  const int t = threadIdx.x & (kG - 1);
  const int base_lane = (threadIdx.x & 31) & ~(kG - 1);
  const unsigned gmask = group_mask<kG>(base_lane);
  const bool live = qi < q;
  const uint32_t k0 = live ? queries[2 * qi] : 0u;
  const uint32_t k1 = live ? queries[2 * qi + 1] : 0u;
  const size_t row = static_cast<size_t>(k0 & nb_mask) * s;
  int hit = -1;
  bool owner = false;
  uint32_t ver = 0;
  uint4 val = make_uint4(0, 0, 0, 0);
  for (int seg = 0; seg < s; seg += kG) {  // once when S <= kG
    const int sl = seg + t;
    const bool in_row = live && sl < s;
    uint32_t kx = 0, ky = 0, v = 0;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (in_row) {
      if (kVW == 4) {
        const uint2 kk = reinterpret_cast<const uint2*>(tkeys)[row + sl];
        kx = kk.x;
        ky = kk.y;
        x = reinterpret_cast<const uint4*>(tvals)[row + sl];
      } else {
        kx = tkeys[2 * (row + sl)];
        ky = tkeys[2 * (row + sl) + 1];
      }
      v = tvers[row + sl];
    }
    const bool m = in_row && k0 != 0 && kx == k0 && ky == k1;
    const unsigned bits =
        group_bits(__ballot_sync(kFull, m), base_lane, gmask);
    if (hit < 0 && bits) {
      const int first = __ffs(bits) - 1;
      hit = seg + first;
      if (t == first) {
        owner = true;
        ver = v;
        val = x;
      }
    }
  }
  if (!live) return;
  if (hit < 0) {
    if (t != 0) return;
    found[qi] = 0;
    slot[qi] = 0;
    vers[qi] = 0;
    if (kVW == 4) {
      reinterpret_cast<uint4*>(vals)[qi] = val;
    } else {
      for (int w = 0; w < vw; ++w) vals[static_cast<size_t>(qi) * vw + w] = 0;
    }
    return;
  }
  if (!owner) return;
  found[qi] = 1;
  slot[qi] = hit;
  vers[qi] = ver;
  if (kVW == 4) {
    reinterpret_cast<uint4*>(vals)[qi] = val;
  } else {
    const uint32_t* src = tvals + (row + hit) * vw;
    for (int w = 0; w < vw; ++w)
      vals[static_cast<size_t>(qi) * vw + w] = src[w];
  }
}

// One run of a row wider than a warp (S > 32), from its leader p, by a
// whole warp: each write walks the row in memory 32 slots at a time, and the
// lane of the slot it takes writes key, version and values before the next
// write reads the row. Returns whether a write was dropped.
__device__ bool apply_run_in_memory(uint32_t* keys, uint32_t* vers,
                                    uint32_t* vals,
                                    const uint32_t* __restrict__ wvals, int s,
                                    int vw, int p, const int* s_idx,
                                    const uint2* s_key, const int* s_next) {
  const int t = threadIdx.x & 31;
  bool dropped = false;
  for (; p >= 0; p = s_next[p]) {
    const uint2 a = s_key[p];  // a.x != 0: an empty slot never matches
    int sl = -1;
    bool match = false;
    for (int seg = 0; seg < s && sl < 0; seg += 32) {
      const int x = seg + t;
      const unsigned bits = __ballot_sync(
          kFull, x < s && keys[2 * x] == a.x && keys[2 * x + 1] == a.y);
      if (bits) {
        sl = seg + __ffs(bits) - 1;
        match = true;
      }
    }
    for (int seg = 0; seg < s && sl < 0; seg += 32) {
      const int x = seg + t;
      const unsigned bits = __ballot_sync(kFull, x < s && keys[2 * x] == 0);
      if (bits) sl = seg + __ffs(bits) - 1;
    }
    if (sl < 0) {
      dropped = true;
      continue;
    }
    if (t == (sl & 31)) {
      vers[sl] = match ? vers[sl] + 1u : 1u;
      keys[2 * sl] = a.x;
      keys[2 * sl + 1] = a.y;
      const uint32_t* from = wvals + static_cast<size_t>(s_idx[p]) * vw;
      uint32_t* to = vals + static_cast<size_t>(sl) * vw;
      for (int w = 0; w < vw; ++w) to[w] = from[w];
    }
    __syncwarp();
  }
  return dropped;
}

// Phase 2 of the commit on the `n` writes the CTA has staged (see the top).
template <int kG>
__device__ void apply_runs(uint32_t* tkeys, uint32_t* tvers, uint32_t* tvals,
                           const uint32_t* __restrict__ wvals,
                           uint32_t* overflow, int n, int s, int vw,
                           const int* s_idx, const uint2* s_key,
                           const uint32_t* s_bkt, int* s_next,
                           uint8_t* s_lead) {
  const int tid = threadIdx.x;
  for (int p = tid; p < n; p += kCommitThreads) {
    const uint32_t bp = s_bkt[p];
    bool lead = true;
    for (int r = 0; r < p && lead; ++r) lead = s_bkt[r] != bp;
    int next = -1;
    for (int r = p + 1; r < n && next < 0; ++r)
      if (s_bkt[r] == bp) next = r;
    s_lead[p] = lead;
    s_next[p] = next;
  }
  __syncthreads();
  const int t = tid & (kG - 1);
  const int base_lane = (tid & 31) & ~(kG - 1);
  const unsigned gmask = group_mask<kG>(base_lane);
  constexpr int kGroups = kCommitThreads / kG;
  for (int p = tid / kG; p < n; p += kGroups) {
    if (!s_lead[p]) continue;  // the whole group
    const size_t row = static_cast<size_t>(s_bkt[p]) * s;
    if (kG == 32 && s > 32) {
      if (apply_run_in_memory(tkeys + 2 * row, tvers + row, tvals + row * vw,
                              wvals, s, vw, p, s_idx, s_key, s_next) &&
          t == 0)
        atomicOr(overflow, 1u);
      continue;
    }
    const bool in_row = t < s;
    uint32_t kx = 0, ky = 0, ver = 0;
    if (in_row) {
      kx = tkeys[2 * (row + t)];
      ky = tkeys[2 * (row + t) + 1];
      ver = tvers[row + t];
    }
    int src = -1;  // the last write this lane's slot took
    bool dropped = false;
    // The empty slots, kept as a mask: an insert takes the lowest.
    unsigned empty = group_bits(__ballot_sync(gmask, in_row && kx == 0),
                                base_lane, gmask);
    uint2 a = s_key[p];  // a.x != 0: staged writes are non-empty
    int idx = s_idx[p];
    int next = s_next[p];
    for (;;) {
      // The run's next write and the one after it, read while this one is
      // applied (past the run's end, a harmless read of this write).
      const int ahead = next < 0 ? p : next;
      const uint2 an = s_key[ahead];
      const int idn = s_idx[ahead];
      const int next2 = s_next[ahead];
      const unsigned m = group_bits(
          __ballot_sync(gmask, in_row && kx == a.x && ky == a.y), base_lane,
          gmask);
      if (m) {
        if (t == __ffs(m) - 1) {
          ver += 1u;
          src = idx;
        }
      } else if (empty) {
        if (t == __ffs(empty) - 1) {
          kx = a.x;
          ky = a.y;
          ver = 1u;
          src = idx;
        }
        empty &= empty - 1u;
      } else {
        dropped = true;
      }
      if (next < 0) break;
      a = an;
      idx = idn;
      next = next2;
    }
    if (src >= 0) {
      tkeys[2 * (row + t)] = kx;
      tkeys[2 * (row + t) + 1] = ky;
      tvers[row + t] = ver;
      const uint32_t* from = wvals + static_cast<size_t>(src) * vw;
      uint32_t* to = tvals + (row + t) * vw;
      for (int w = 0; w < vw; ++w) to[w] = from[w];
    }
    if (dropped && t == 0) atomicOr(overflow, 1u);
  }
  __syncthreads();
}

template <int kG>
__global__ void __launch_bounds__(kCommitThreads)
commit_runs_kernel(uint32_t* tkeys, uint32_t* tvers, uint32_t* tvals,
                   const uint32_t* __restrict__ wkeys,
                   const uint32_t* __restrict__ wvals,
                   const uint8_t* __restrict__ active, uint32_t* overflow,
                   int k, uint32_t nb_mask, int s, int vw, int part_bits) {
  __shared__ int s_idx[kCap];
  __shared__ uint2 s_key[kCap];
  __shared__ uint32_t s_bkt[kCap];
  __shared__ int s_next[kCap];
  __shared__ uint8_t s_lead[kCap];
  __shared__ int s_count[kCommitThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t part = blockIdx.x;
  int n = 0;  // staged writes, the same in every thread
  // kLoadTiles tiles of writes are loaded at once (one round trip), then
  // staged tile by tile.
  for (int base = 0; base < k; base += kLoadTiles * kCommitThreads) {
    uint8_t a[kLoadTiles];
    uint32_t k0[kLoadTiles], k1[kLoadTiles];
#pragma unroll
    for (int u = 0; u < kLoadTiles; ++u) {
      const int i = base + u * kCommitThreads + tid;
      const bool in = i < k;
      a[u] = in ? active[i] : 0;
      k0[u] = in ? wkeys[2 * i] : 0u;
      k1[u] = in ? wkeys[2 * i + 1] : 0u;
    }
#pragma unroll
    for (int u = 0; u < kLoadTiles; ++u) {
      const int tile = base + u * kCommitThreads;
      if (tile >= k) break;  // the whole CTA
      const uint32_t bkt = k0[u] & nb_mask;
      const uint32_t mine =
          part_bits ? (bkt * kGolden) >> (32 - part_bits) : 0u;
      const bool take = a[u] && k0[u] != 0 && mine == part;
      const unsigned bal = __ballot_sync(kFull, take);
      if (lane == 0) s_count[warp] = __popc(bal);
      __syncthreads();
      int at = n, total = n;
      for (int w = 0; w < kCommitThreads / 32; ++w) {
        at += w < warp ? s_count[w] : 0;
        total += s_count[w];
      }
      if (take) {
        const int p = at + __popc(bal & ((1u << lane) - 1u));
        s_idx[p] = tile + tid;
        s_key[p] = make_uint2(k0[u], k1[u]);
        s_bkt[p] = bkt;
      }
      n = total;
      __syncthreads();
      if (n > kCap - kCommitThreads || tile + kCommitThreads >= k) {
        if (n)
          apply_runs<kG>(tkeys, tvers, tvals, wvals, overflow, n, s, vw,
                         s_idx, s_key, s_bkt, s_next, s_lead);
        n = 0;
      }
    }
  }
}

// G for S slots: S rounded up to a power of two, at most 32.
int group_lanes(int s) {
  int g = 1;
  while (g < s && g < 32) g *= 2;
  return g;
}

template <int kVW>
void launch_lookup(int g, int blocks, const uint32_t* tkeys,
                   const uint32_t* tvers, const uint32_t* tvals,
                   const uint32_t* queries, uint8_t* found, uint32_t* vers,
                   uint32_t* vals, int32_t* slot, int q, uint32_t mask, int s,
                   int vw, cudaStream_t stream) {
#define HT_LOOKUP(G)                                                        \
  lookup_kernel<G, kVW><<<blocks, kLookupThreads, 0, stream>>>(             \
      tkeys, tvers, tvals, queries, found, vers, vals, slot, q, mask, s, vw)
  switch (g) {
    case 1: HT_LOOKUP(1); break;
    case 2: HT_LOOKUP(2); break;
    case 4: HT_LOOKUP(4); break;
    case 8: HT_LOOKUP(8); break;
    case 16: HT_LOOKUP(16); break;
    default: HT_LOOKUP(32); break;
  }
#undef HT_LOOKUP
}

}  // namespace

// The parts (CTAs) of a commit of k writes: a power of two near k / 32, at
// most 1,024; returned as its log2.
extern "C" int ht_commit_part_bits(int k) {
  int bits = 0;
  while (bits < kMaxPartBits && (kPartWrites << bits) < k) ++bits;
  return bits;
}

extern "C" int ht_commit(uint32_t* tkeys, uint32_t* tvers, uint32_t* tvals,
                         const uint32_t* wkeys, const uint32_t* wvals,
                         const uint8_t* active, uint32_t* overflow, int k,
                         int nb, int s, int vw, cudaStream_t stream) {
  const uint32_t mask = static_cast<uint32_t>(nb - 1);
  const int bits = ht_commit_part_bits(k);
#define HT_COMMIT(G)                                                        \
  commit_runs_kernel<G><<<1 << bits, kCommitThreads, 0, stream>>>(          \
      tkeys, tvers, tvals, wkeys, wvals, active, overflow, k, mask, s, vw,  \
      bits)
  switch (group_lanes(s)) {
    case 1: HT_COMMIT(1); break;
    case 2: HT_COMMIT(2); break;
    case 4: HT_COMMIT(4); break;
    case 8: HT_COMMIT(8); break;
    case 16: HT_COMMIT(16); break;
    default: HT_COMMIT(32); break;
  }
#undef HT_COMMIT
  return static_cast<int>(cudaGetLastError());
}

// vec4: VW == 4 and the table's and output's values are 16-byte aligned.
extern "C" int ht_lookup(const uint32_t* tkeys, const uint32_t* tvers,
                         const uint32_t* tvals, const uint32_t* queries,
                         uint8_t* found, uint32_t* vers, uint32_t* vals,
                         int32_t* slot, int q, int nb, int s, int vw, int vec4,
                         cudaStream_t stream) {
  const int g = group_lanes(s);
  const int per_block = kLookupThreads / g;
  const int blocks = (q + per_block - 1) / per_block;
  const uint32_t mask = static_cast<uint32_t>(nb - 1);
  if (vec4)
    launch_lookup<4>(g, blocks, tkeys, tvers, tvals, queries, found, vers,
                     vals, slot, q, mask, s, vw, stream);
  else
    launch_lookup<0>(g, blocks, tkeys, tvers, tvals, queries, found, vers,
                     vals, slot, q, mask, s, vw, stream);
  return static_cast<int>(cudaGetLastError());
}
