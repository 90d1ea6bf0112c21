// MVCC block validation: read freshness, in-block conflicts, validity scan.
//
// Replaces the Pallas kernel src/repro/kernels/mvcc_validate/kernel.py:
// validate_blocks (_mvcc_kernel). For each block of B transactions:
//   ok[i]    = ok0[i] & (every non-empty read key's current version equals
//              the version the endorser recorded)
//   conf[j,i] = a non-empty write key of tx j equals a read or write key of
//              tx i
//   valid[i] = ok[i] & !exists j < i (valid[j] & conf[j,i])
// The last line is a B-step dependent chain: tx i's verdict needs every
// earlier verdict.
//
// The TPU kernel builds the whole (B, B) conflict matrix in VMEM and then
// walks the chain one grid step at a time. Here one thread block holds one
// block, one thread per transaction, every key in shared memory. Freshness
// is one parallel pass. The chain runs as B barrier steps: at step i each
// earlier thread j that is valid tests conf[j,i] against tx i's keys (all
// threads read the same shared words, a broadcast) and __syncthreads_or
// combines the votes; thread i keeps its verdict in a register. So the
// conflict bits are computed in parallel at each step instead of being
// stored, and the kernel needs (RK+WK)*2 words of shared memory per tx.
//
// Bound: at the main path's B = 100, RK = WK = 2 the block reads about
// 5 KB and makes about 80k key compares, a nanosecond or two at the card's
// rates; what bounds it is the 100 dependent barrier steps and the launch.
// B <= 1024 (one thread per transaction); the wrapper raises above that.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ bool same(const uint32_t* a, const uint32_t* b) {
  return a[0] == b[0] && a[1] == b[1];
}

__global__ void mvcc_kernel(const uint32_t* __restrict__ rk,
                            const uint32_t* __restrict__ rv,
                            const uint32_t* __restrict__ wk,
                            const uint32_t* __restrict__ cur,
                            const uint8_t* __restrict__ ok0,
                            uint8_t* __restrict__ valid, int b, int nr,
                            int nw) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_rk = smem;                 // (B, RK, 2)
  uint32_t* s_wk = smem + b * nr * 2;    // (B, WK, 2)
  const size_t blk = blockIdx.x;
  const int i = threadIdx.x;
  rk += blk * b * nr * 2;
  rv += blk * b * nr;
  cur += blk * b * nr;
  wk += blk * b * nw * 2;
  ok0 += blk * b;
  valid += blk * b;

  for (int t = i; t < b * nr * 2; t += blockDim.x) s_rk[t] = rk[t];
  for (int t = i; t < b * nw * 2; t += blockDim.x) s_wk[t] = wk[t];

  bool ok = false;
  if (i < b) {
    ok = ok0[i] != 0;
    for (int r = 0; r < nr; ++r)
      if (rk[(i * nr + r) * 2] != 0 && cur[i * nr + r] != rv[i * nr + r])
        ok = false;
  }
  __syncthreads();

  bool mine = false;  // this thread's verdict, fixed at step i
  for (int step = 0; step < b; ++step) {
    bool hit = false;
    if (i < step && mine) {
      for (int w = 0; w < nw && !hit; ++w) {
        const uint32_t* key = s_wk + (i * nw + w) * 2;
        if (key[0] == 0) continue;
        for (int r = 0; r < nr && !hit; ++r)
          hit = same(key, s_rk + (step * nr + r) * 2);
        for (int v = 0; v < nw && !hit; ++v)
          hit = same(key, s_wk + (step * nw + v) * 2);
      }
    }
    const int blocked = __syncthreads_or(hit);
    if (i == step) mine = ok && !blocked;
  }
  if (i < b) valid[i] = mine;
}

}  // namespace

extern "C" int mvcc_validate(const uint32_t* rk, const uint32_t* rv,
                             const uint32_t* wk, const uint32_t* cur,
                             const uint8_t* ok0, uint8_t* valid, int nblk,
                             int b, int nr, int nw, cudaStream_t stream) {
  const int threads = ((b + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(b) * (nr + nw) * 2 * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mvcc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  mvcc_kernel<<<nblk, threads, smem, stream>>>(rk, rv, wk, cur, ok0, valid,
                                               b, nr, nw);
  return static_cast<int>(cudaGetLastError());
}
