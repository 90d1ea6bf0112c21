// MVCC block validation: read freshness, in-block conflicts, validity scan.
//
// Replaces the Pallas kernel src/repro/kernels/mvcc_validate/kernel.py:
// validate_blocks (_mvcc_kernel). For each block of B transactions:
//   ok[i]     = ok0[i] & (every non-empty read key's current version equals
//               the version the endorser recorded)
//   conf[j,i] = a non-empty write key of tx j equals a read or write key of
//               tx i
//   valid[i]  = ok[i] & !exists j < i (valid[j] & conf[j,i])
// The last line is a B-step dependent chain: tx i's verdict needs every
// earlier verdict.
//
// Design: one thread block a block, 1024 threads, two phases.
// Phase 1 (every warp, in parallel, once): the keys go to shared memory, a
// ballot of the freshness tests gives the ok bits of each 32-tx chunk, and
// the strict lower triangle of conf becomes bit words,
//   C[k*B + i] bit t = conf[32k+t, i] for 32k+t < i,
// one word per ballot of a warp whose lane t holds tx j = 32k+t's write
// keys in registers and tests them against tx i's keys (a broadcast read
// of shared memory). So each word has one owner and no atomics; the
// j >= i bits (the diagonal, where a tx's write meets itself) are cleared
// by the lane's own test. RK = WK = 2 (the paths) is compiled with fixed
// loop counts; other shapes read them at run time.
// Phase 2 (warp 0, the dependent chain): B <= 1024 is at most 32 chunks, so
// lane k keeps chunk k's valid word V[k] in a register. For chunk c, lane t
// (tx i = 32c+t) ORs C[k*B+i] & V[k] over k < c, with V[k] taken from lane
// k by a shuffle, and is a candidate if it is ok and nothing blocked it.
// The chain inside the chunk runs on register bits: v bit t = candidate t
// and !(C[c*B+i] & v). Since C[c*B+i] holds only bits below t, iterating
// v <- ballot(candidate && !(C[c*B+i] & v)) from v = candidates fixes bit
// t after t+1 rounds, and its first fixed point is the chain's answer: at
// most 33 ballots, as many as the longest chain of conflicts among the
// candidates plus one. Lane c keeps V[c] = v. Bit t of word k is tx 32k+t
// everywhere.
//
// Bound: at the main path's B = 100, RK = WK = 2 the block reads about
// 5 KB and makes about 40k key compares, nanoseconds at the card's rates.
// What is left is the launch, two barriers, phase 1's ~7 ballot words a
// warp, and 4 chunk steps of shuffles and ballots in one warp; there is no
// barrier per transaction (the previous design paid a CTA-wide
// __syncthreads_or per transaction, ~0.5 us each). At B = 1024 phase 1's
// ~17k words, B^2/2 * WK * (RK+WK) compares on one SM, set the time.
// Shared memory: B*(RK+WK)*2 key words, B*ceil(B/32) conflict words and
// ceil(B/32) ok words (mvcc_validate_smem); above 48 KB it is opted into
// once per device, and the wrapper refuses shapes above the device's limit
// (227 KB on an H100).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

// kNR, kNW: the read and write keys a tx, fixed at compile time for the
// shape the paths use (the loops unroll and a lane keeps its tx's write
// keys in registers), or 0 to read them from nr, nw at run time.
template <int kNR, int kNW>
__global__ void __launch_bounds__(kThreads)
mvcc_kernel(const uint32_t* __restrict__ rk, const uint32_t* __restrict__ rv,
            const uint32_t* __restrict__ wk, const uint32_t* __restrict__ cur,
            const uint8_t* __restrict__ ok0, uint8_t* __restrict__ valid,
            int b, int nr_, int nw_) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int nr = kNR ? kNR : nr_;
  const int nw = kNW ? kNW : nw_;
  const int nch = (b + 31) / 32;
  uint2* s_rk = reinterpret_cast<uint2*>(smem);  // (B, RK) keys
  uint2* s_wk = s_rk + b * nr;                     // (B, WK) keys
  uint32_t* s_conf = smem + b * (nr + nw) * 2;     // (nch, B) words
  uint32_t* s_ok = s_conf + nch * b;               // (nch,) ok bits
  const size_t blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  rk += blk * b * nr * 2;
  rv += blk * b * nr;
  cur += blk * b * nr;
  wk += blk * b * nw * 2;
  ok0 += blk * b;
  valid += blk * b;

  // Word copies: a tensor view need not be 8-byte aligned in device memory.
  for (int t = tid; t < b * nr * 2; t += blockDim.x) smem[t] = rk[t];
  for (int t = tid; t < b * nw * 2; t += blockDim.x)
    smem[b * nr * 2 + t] = wk[t];

  // Freshness: warp w owns chunks w, w + nwarps, ...; lane t tests tx
  // 32c+t, and the ballot is chunk c's ok word (zero past B).
  for (int c = warp; c < nch; c += nwarps) {
    const int i = c * 32 + lane;
    bool ok = false;
    if (i < b) {
      ok = ok0[i] != 0;
      for (int r = 0; r < nr; ++r)
        if (rk[(i * nr + r) * 2] != 0 && cur[i * nr + r] != rv[i * nr + r])
          ok = false;
    }
    const uint32_t word = __ballot_sync(kFull, ok);
    if (lane == 0) s_ok[c] = word;
  }
  __syncthreads();

  // Conflict words: for chunk k, lane t stands for tx j = 32k+t and the
  // warp walks txs i >= 32k (words with i < 32k are never read). Tx i's
  // keys are broadcast reads; an empty one (first word 0) is skipped by
  // the whole warp, since it equals no non-empty write key. Lanes with
  // j >= b read a clamped row and are cleared by j < i.
  constexpr int kRegW = kNW ? kNW : 1;
  for (int k = 0; k < nch; ++k) {
    const int j = k * 32 + lane;
    const int jc = j < b ? j : b - 1;
    uint2 wj[kRegW];
    if (kNW) {
#pragma unroll
      for (int w = 0; w < kRegW; ++w) wj[w] = s_wk[jc * kNW + w];
    }
    for (int i = k * 32 + warp; i < b; i += nwarps) {
      bool hit = false;
#pragma unroll
      for (int q = 0; q < nr + nw; ++q) {
        const uint2 ki = q < nr ? s_rk[i * nr + q] : s_wk[i * nw + q - nr];
        if (ki.x == 0) continue;
        if (kNW) {
#pragma unroll
          for (int w = 0; w < kRegW; ++w)
            hit |= wj[w].x == ki.x && wj[w].y == ki.y;
        } else {
          for (int w = 0; w < nw; ++w) {
            const uint2 kj = s_wk[jc * nw + w];
            hit |= kj.x == ki.x && kj.y == ki.y;
          }
        }
      }
      const uint32_t word = __ballot_sync(kFull, hit && j < i);
      if (lane == 0) s_conf[k * b + i] = word;
    }
  }
  __syncthreads();
  if (warp != 0) return;

  // The chain, one warp: lane k keeps V[k], chunk k's valid word.
  uint32_t vk = 0;
  for (int c = 0; c < nch; ++c) {
    const int i = c * 32 + lane;
    const bool in = i < b;
    uint32_t blocked = 0;
#pragma unroll 4
    for (int k = 0; k < c; ++k) {
      const uint32_t v_k = __shfl_sync(kFull, vk, k);
      blocked |= (in ? s_conf[k * b + i] : 0u) & v_k;
    }
    const bool cand = ((s_ok[c] >> lane) & 1u) && blocked == 0;
    const uint32_t diag = in ? s_conf[c * b + i] : 0u;
    // v = f(v), f(v) bit t = candidate t & !(diag_t & v): diag_t holds only
    // bits below t, so bit t is right after t + 1 rounds and the unique
    // fixed point is the chain's answer. One ballot a round: at most 33,
    // and as many as the longest chain of conflicts among candidates + 1.
    uint32_t v = __ballot_sync(kFull, cand);
    for (;;) {
      const uint32_t nv = __ballot_sync(kFull, cand && (diag & v) == 0);
      if (nv == v) break;
      v = nv;
    }
    if (lane == c) vk = v;
    if (in) valid[i] = (v >> lane) & 1u;
  }
}

template <int kNR, int kNW>
int launch(const uint32_t* rk, const uint32_t* rv, const uint32_t* wk,
           const uint32_t* cur, const uint8_t* ok0, uint8_t* valid,
           int nblk, int b, int nr, int nw, size_t smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    // Opt in once per device and instance, to the most the device allows.
    static int opted[kMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= kMaxDevices || opted[dev] < static_cast<int>(smem)) {
      int most = 0;
      e = cudaDeviceGetAttribute(
          &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (e != cudaSuccess) return static_cast<int>(e);
      e = cudaFuncSetAttribute(mvcc_kernel<kNR, kNW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (dev < kMaxDevices) opted[dev] = most;
    }
  }
  mvcc_kernel<kNR, kNW><<<nblk, kThreads, smem, stream>>>(
      rk, rv, wk, cur, ok0, valid, b, nr, nw);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory a launch with b, nr, nw needs.
size_t smem_bytes(int b, int nr, int nw) {
  const size_t nch = (static_cast<size_t>(b) + 31) / 32;
  return (static_cast<size_t>(b) * (nr + nw) * 2 + nch * b + nch) *
         sizeof(uint32_t);
}

}  // namespace

extern "C" long long mvcc_validate_smem(int b, int nr, int nw) {
  return static_cast<long long>(smem_bytes(b, nr, nw));
}

extern "C" int mvcc_validate(const uint32_t* rk, const uint32_t* rv,
                             const uint32_t* wk, const uint32_t* cur,
                             const uint8_t* ok0, uint8_t* valid, int nblk,
                             int b, int nr, int nw, cudaStream_t stream) {
  const size_t smem = smem_bytes(b, nr, nw);
  if (nr == 2 && nw == 2)
    return launch<2, 2>(rk, rv, wk, cur, ok0, valid, nblk, b, nr, nw, smem,
                        stream);
  return launch<0, 0>(rk, rv, wk, cur, ok0, valid, nblk, b, nr, nw, smem,
                      stream);
}
