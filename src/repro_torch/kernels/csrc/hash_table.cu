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
// in HBM and a probe reads only its bucket row: 64 B of keys, then 4 B of
// version and 16 B of value on a hit. Bound: at the main path's 200 queries
// that is about 50 KB, some 15 ns of HBM time, far below launch latency.
// Design: one thread per query; the row is read once, straight from HBM,
// with no shared memory.

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
// table. Here the table stays in HBM and only the order of writes WITHIN a
// bucket matters, so buckets go in parallel: thread i is its bucket's leader
// when no earlier active write maps to that bucket; the leader walks writes
// i..K-1 in order and applies those of its bucket, the other threads exit.
// Leaders own disjoint buckets, so there are no races, and each bucket sees
// the reference's order. Bound: bytes (the writes read once, one bucket row
// read and one slot written per active write), about 20 KB at the main
// path's K = 200, far below launch latency; a chain of same-bucket writes is
// serial by the semantics, and the all-in-one-bucket case is K dependent
// steps on one thread. Each thread also scans the writes before it to find
// whether it leads (K^2 / 2 key reads, in L1/L2). No shared memory; the
// overflow word is an atomicOr into a word the wrapper zeroes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void lookup_kernel(const uint32_t* __restrict__ tkeys,
                              const uint32_t* __restrict__ tvers,
                              const uint32_t* __restrict__ tvals,
                              const uint32_t* __restrict__ queries,
                              uint8_t* __restrict__ found,
                              uint32_t* __restrict__ vers,
                              uint32_t* __restrict__ vals,
                              int32_t* __restrict__ slot, int q,
                              uint32_t nb_mask, int s, int vw) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  const uint32_t k0 = queries[2 * i];
  const uint32_t k1 = queries[2 * i + 1];
  const size_t row = static_cast<size_t>(k0 & nb_mask) * s;
  int hit = -1;
  if (k0 != 0) {
    const uint2* keys = reinterpret_cast<const uint2*>(tkeys) + row;
    for (int j = 0; j < s; ++j) {
      const uint2 k = keys[j];
      if (k.x == k0 && k.y == k1) {
        hit = j;
        break;
      }
    }
  }
  found[i] = hit >= 0;
  slot[i] = hit >= 0 ? hit : 0;
  vers[i] = hit >= 0 ? tvers[row + hit] : 0u;
  const uint32_t* src = tvals + (row + (hit >= 0 ? hit : 0)) * vw;
  for (int v = 0; v < vw; ++v) vals[static_cast<size_t>(i) * vw + v] =
      hit >= 0 ? src[v] : 0u;
}

__global__ void commit_kernel(uint32_t* tkeys, uint32_t* tvers,
                              uint32_t* tvals,
                              const uint32_t* __restrict__ wkeys,
                              const uint32_t* __restrict__ wvals,
                              const uint8_t* __restrict__ active,
                              uint32_t* overflow, int k, uint32_t nb_mask,
                              int s, int vw) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  const uint32_t k0 = wkeys[2 * i];
  if (!active[i] || k0 == 0) return;
  const uint32_t b = k0 & nb_mask;
  for (int j = 0; j < i; ++j) {
    const uint32_t kj = wkeys[2 * j];
    if (active[j] && kj != 0 && (kj & nb_mask) == b) return;  // not leader
  }
  uint2* keys = reinterpret_cast<uint2*>(tkeys) + static_cast<size_t>(b) * s;
  uint32_t* vers = tvers + static_cast<size_t>(b) * s;
  uint32_t* vals = tvals + static_cast<size_t>(b) * s * vw;
  bool dropped = false;
  for (int j = i; j < k; ++j) {
    const uint32_t a0 = wkeys[2 * j];
    const uint32_t a1 = wkeys[2 * j + 1];
    if (!active[j] || a0 == 0 || (a0 & nb_mask) != b) continue;
    int match = -1, empty = -1;
    for (int t = 0; t < s; ++t) {
      const uint2 kt = keys[t];
      if (kt.x == a0 && kt.y == a1) {  // a0 != 0, so the slot is occupied
        match = t;
        break;
      }
      if (kt.x == 0 && empty < 0) empty = t;
    }
    const int slot = match >= 0 ? match : empty;
    if (slot < 0) {
      dropped = true;
      continue;
    }
    vers[slot] = match >= 0 ? vers[slot] + 1u : 1u;
    keys[slot] = make_uint2(a0, a1);
    for (int v = 0; v < vw; ++v)
      vals[static_cast<size_t>(slot) * vw + v] =
          wvals[static_cast<size_t>(j) * vw + v];
  }
  if (dropped) atomicOr(overflow, 1u);
}

}  // namespace

extern "C" int ht_commit(uint32_t* tkeys, uint32_t* tvers, uint32_t* tvals,
                         const uint32_t* wkeys, const uint32_t* wvals,
                         const uint8_t* active, uint32_t* overflow, int k,
                         int nb, int s, int vw, cudaStream_t stream) {
  const int threads = 128;
  commit_kernel<<<(k + threads - 1) / threads, threads, 0, stream>>>(
      tkeys, tvers, tvals, wkeys, wvals, active, overflow, k,
      static_cast<uint32_t>(nb - 1), s, vw);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ht_lookup(const uint32_t* tkeys, const uint32_t* tvers,
                         const uint32_t* tvals, const uint32_t* queries,
                         uint8_t* found, uint32_t* vers, uint32_t* vals,
                         int32_t* slot, int q, int nb, int s, int vw,
                         cudaStream_t stream) {
  const int threads = 128;
  lookup_kernel<<<(q + threads - 1) / threads, threads, 0, stream>>>(
      tkeys, tvers, tvals, queries, found, vers, vals, slot, q,
      static_cast<uint32_t>(nb - 1), s, vw);
  return static_cast<int>(cudaGetLastError());
}
