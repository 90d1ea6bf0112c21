// World-state hash table probe (Opt P-I).
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

}  // namespace

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
