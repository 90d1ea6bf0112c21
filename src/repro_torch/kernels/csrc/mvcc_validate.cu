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
// Two routes, chosen by the wrapper from the shape; both take any B and
// give the same bits.
//
// ---- One CTA (mvcc_kernel): the keys and conflict words fit shared memory
//
// One thread block a block, 1024 threads, two phases.
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
// Phase 2 (warp 0, the dependent chain): chunk c's ok word is replaced in
// shared memory by its valid word V[c] once the chunk is done. For chunk
// c, lane t (tx i = 32c+t) ORs C[k*B+i] & V[k] over k < c (V[k] a
// broadcast read), and is a candidate if it is ok and nothing blocked it.
// The chain inside the chunk runs on register bits: v bit t = candidate t
// and !(C[c*B+i] & v). Since C[c*B+i] holds only bits below t, iterating
// v <- ballot(candidate && !(C[c*B+i] & v)) from v = candidates fixes bit
// t after t+1 rounds, and its first fixed point is the chain's answer: at
// most 33 ballots, as many as the longest chain of conflicts among the
// candidates plus one. Bit t of word k is tx 32k+t everywhere.
//
// Bound: at the main path's B = 100, RK = WK = 2 the block reads about
// 5 KB and makes about 40k key compares, nanoseconds at the card's rates.
// What is left is the launch, two barriers, phase 1's ~7 ballot words a
// warp, and 4 chunk steps of ballots in one warp; there is no barrier per
// transaction. At B = 1024 phase 1's ~17k words, B^2/2 * WK * (RK+WK)
// compares on one SM, set the time. Shared memory: B*(RK+WK)*2 key words,
// B*ceil(B/32) conflict words and ceil(B/32) ok words (mvcc_validate_smem);
// above 48 KB it is opted into once per device (227 KB on an H100: B <=
// 1,235 at RK = WK = 2). The wrapper takes this route up to 160 txs, where
// it is faster than the tiled one (ops.CTA_MAX_TXS); forced, it takes any
// block that fits.
//
// ---- Tiled (mvcc_conf_kernel, then mvcc_scan_kernel): any other block
//
// The same two phases as two launches, with the conflict words and the ok
// words in a scratch buffer the wrapper allocates (B*ceil(B/32) + ceil(B/32)
// words: 0.5 MB at B = 2,048, 2 MB at 4,096), which stays in L2.
// Phase 1 is a grid of CTAs, one per (chunk row k, tile of 128 txs i);
// each warp writes the words C[k*B+i] of its i's as above, reading tx i's
// keys with warp-uniform loads (one transaction a key, from L1). Tiles
// wholly below 32k write nothing: those words are never read. The CTAs of
// row 0 also write the ok words.
// Phase 2 is one CTA of 32 warps. The OR over k < c is split across the
// warps (warp w takes k = w, w+32, ...) and reduced in shared memory, and
// it is computed one chunk ahead: while warp 0 runs chunk c's chain, the
// other warps already OR chunk c+1's words over k < c, whose V[k] are
// known; after the barrier that publishes V[c], warp c % 32 adds the one
// term k = c from a word it loaded beforehand. A chunk costs two barriers,
// 32 shared-memory reads and the ballots of its chain, and the warps'
// loads of chunk c+1's words from L2 complete before the second barrier,
// so one L2 round trip remains in each chunk's step (~1 us a chunk on an
// H100 at B = 2,048). Warp 0 prefetches the next diagonal word.
//
// ---- Several independent blocks (NB) in one launch, on both routes
//
// Blocks that do not depend on each other (the same window position of
// several channels) share a launch: the one-CTA route runs NB CTAs, one a
// block; the tiled route gives phase 1 a third grid dimension (blockIdx.z
// = the block) and phase 2 a grid of NB scan CTAs, each block with its own
// slice of the scratch buffer. So a call is one launch, or two, for any NB.
// Block n's inputs start at n times one block's size in every array.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
constexpr int kTileTx = 128;       // txs i of one phase-1 CTA (tiled route)
constexpr int kConfThreads = 256;  // its threads: 8 warps
constexpr int kDefaultSmem = 48 * 1024;

// Opt a kernel into `smem` bytes of dynamic shared memory (once per device
// and kernel, to the most the device allows) when it needs more than 48 KB.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem, int* opted) {
  if (smem <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && opted[dev] >= static_cast<int>(smem))
    return cudaSuccess;
  int most = 0;
  e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           most);
  if (e == cudaSuccess && dev < kMaxDevices) opted[dev] = most;
  return e;
}

// tx i is fresh: ok0 and every non-empty read key has its recorded version.
__device__ __forceinline__ bool fresh(const uint32_t* __restrict__ rk,
                                      const uint32_t* __restrict__ rv,
                                      const uint32_t* __restrict__ cur,
                                      const uint8_t* __restrict__ ok0, int i,
                                      int nr) {
  bool ok = ok0[i] != 0;
  for (int r = 0; r < nr; ++r)
    if (rk[(i * nr + r) * 2] != 0 && cur[i * nr + r] != rv[i * nr + r])
      ok = false;
  return ok;
}

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
  uint32_t* s_ok = s_conf + nch * b;  // (nch,) ok words, then valid words
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
    const uint32_t word =
        __ballot_sync(kFull, i < b && fresh(rk, rv, cur, ok0, i, nr));
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

  // The chain, one warp; s_ok[k] holds V[k] once chunk k is done.
  for (int c = 0; c < nch; ++c) {
    const int i = c * 32 + lane;
    const bool in = i < b;
    uint32_t blocked = 0;
#pragma unroll 4
    for (int k = 0; k < c; ++k)
      blocked |= (in ? s_conf[k * b + i] : 0u) & s_ok[k];
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
    if (lane == 0) s_ok[c] = v;  // every lane has read s_ok[c] by now
    if (in) valid[i] = (v >> lane) & 1u;
    __syncwarp();
  }
}

// Tiled route, phase 1: CTA (tile x, chunk row k, block z) writes C[k*B+i]
// for the txs i >= 32k of tile x of block z; the CTAs of row 0 also write
// the tile's ok words.
template <int kNR, int kNW>
__global__ void __launch_bounds__(kConfThreads)
mvcc_conf_kernel(const uint32_t* __restrict__ rk,
                 const uint32_t* __restrict__ rv,
                 const uint32_t* __restrict__ wk,
                 const uint32_t* __restrict__ cur,
                 const uint8_t* __restrict__ ok0, uint32_t* __restrict__ conf,
                 uint32_t* __restrict__ okw, int b, int nr_, int nw_) {
  const int nr = kNR ? kNR : nr_;
  const int nw = kNW ? kNW : nw_;
  const int nch = (b + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t blk = blockIdx.z;
  rk += blk * b * nr * 2;
  rv += blk * b * nr;
  cur += blk * b * nr;
  wk += blk * b * nw * 2;
  ok0 += blk * b;
  conf += blk * (static_cast<size_t>(nch) * b + nch);
  okw += blk * (static_cast<size_t>(nch) * b + nch);
  const int i0 = blockIdx.x * kTileTx;
  const int i1 = min(b, i0 + kTileTx);
  const int k = blockIdx.y;
  if (k == 0 && warp < kTileTx / 32) {
    const int c = i0 / 32 + warp;
    if (c < nch) {  // warp-uniform
      const int i = c * 32 + lane;
      const uint32_t word =
          __ballot_sync(kFull, i < b && fresh(rk, rv, cur, ok0, i, nr));
      if (lane == 0) okw[c] = word;
    }
  }
  const int start = max(i0, 32 * k);
  if (start >= i1) return;  // the whole CTA: these words are never read
  const int j = 32 * k + lane;
  const int jc = j < b ? j : b - 1;
  constexpr int kRegW = kNW ? kNW : 1;
  uint2 wj[kRegW];
  if (kNW) {
#pragma unroll
    for (int w = 0; w < kRegW; ++w)
      wj[w] = make_uint2(wk[(jc * kNW + w) * 2], wk[(jc * kNW + w) * 2 + 1]);
  }
  uint32_t* row = conf + static_cast<size_t>(k) * b;
  for (int i = start + warp; i < i1; i += kConfThreads / 32) {
    bool hit = false;
#pragma unroll
    for (int q = 0; q < nr + nw; ++q) {
      const uint32_t* key = q < nr ? rk + (i * nr + q) * 2
                                   : wk + (i * nw + q - nr) * 2;
      const uint32_t kx = key[0];
      if (kx == 0) continue;
      const uint32_t ky = key[1];
      if (kNW) {
#pragma unroll
        for (int w = 0; w < kRegW; ++w) hit |= wj[w].x == kx && wj[w].y == ky;
      } else {
        for (int w = 0; w < nw; ++w)
          hit |= wk[(jc * nw + w) * 2] == kx && wk[(jc * nw + w) * 2 + 1] == ky;
      }
    }
    const uint32_t word = __ballot_sync(kFull, hit && j < i);
    if (lane == 0) row[i] = word;
  }
}

// Tiled route, phase 2: the chunk scan, one CTA of 32 warps a block (see
// the top). Shared memory: 32 x 32 partial words, then nch valid words, nch
// ok words.
__global__ void __launch_bounds__(kThreads)
mvcc_scan_kernel(const uint32_t* __restrict__ conf,
                 const uint32_t* __restrict__ okw, uint8_t* __restrict__ valid,
                 int b) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int nch = (b + 31) / 32;
  uint32_t* s_part = smem;
  uint32_t* s_v = smem + kThreads;
  uint32_t* s_ok = s_v + nch;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t bb = b;
  const size_t blk = blockIdx.x;
  conf += blk * (nch * bb + nch);
  okw += blk * (nch * bb + nch);
  valid += blk * bb;
  for (int t = tid; t < nch; t += kThreads) s_ok[t] = okw[t];
  uint32_t part = 0;  // OR of C[k*B+i] & V[k] over this warp's k < c
  uint32_t held = 0;  // C[c*B+i] for i in chunk c+1 (warp c % 32)
  uint32_t diag = warp == 0 && lane < b ? conf[lane] : 0u;  // chunk 0's
  __syncthreads();
  for (int c = 0; c < nch; ++c) {
    s_part[tid] = part;
    __syncthreads();
    const int inext = 32 * (c + 1) + lane;
    const bool nin = c + 1 < nch && inext < b;
    if (warp == 0) {
      const int i = 32 * c + lane;
      const bool in = i < b;
      uint32_t blocked = 0;
#pragma unroll 8
      for (int w = 0; w < 32; ++w) blocked |= s_part[w * 32 + lane];
      const bool cand = in && ((s_ok[c] >> lane) & 1u) && blocked == 0;
      const uint32_t d = diag;
      diag = nin ? conf[(c + 1) * bb + inext] : 0u;
      uint32_t v = __ballot_sync(kFull, cand);
      for (;;) {
        const uint32_t nv = __ballot_sync(kFull, cand && (d & v) == 0);
        if (nv == v) break;
        v = nv;
      }
      if (lane == 0) s_v[c] = v;
      if (in) valid[i] = (v >> lane) & 1u;
    }
    // Chunk c+1's words over k < c, whose V[k] are known.
    part = 0;
    if (nin) {
      for (int k = warp; k < c; k += 32)
        part |= conf[k * bb + inext] & s_v[k];
      if (warp == c % 32) held = conf[c * bb + inext];
    }
    __syncthreads();  // V[c] is published
    if (nin && warp == c % 32) part |= held & s_v[c];
  }
}

int opted_cta[2][kMaxDevices];
int opted_scan[kMaxDevices];

template <int kNR, int kNW>
int launch(const uint32_t* rk, const uint32_t* rv, const uint32_t* wk,
           const uint32_t* cur, const uint8_t* ok0, uint8_t* valid,
           int nblk, int b, int nr, int nw, size_t smem,
           cudaStream_t stream) {
  cudaError_t e = opt_in(mvcc_kernel<kNR, kNW>, smem, opted_cta[kNR ? 1 : 0]);
  if (e != cudaSuccess) return static_cast<int>(e);
  mvcc_kernel<kNR, kNW><<<nblk, kThreads, smem, stream>>>(
      rk, rv, wk, cur, ok0, valid, b, nr, nw);
  return static_cast<int>(cudaGetLastError());
}

template <int kNR, int kNW>
int launch_tiled(const uint32_t* rk, const uint32_t* rv, const uint32_t* wk,
                 const uint32_t* cur, const uint8_t* ok0, uint8_t* valid,
                 uint32_t* scratch, int nblk, int b, int nr, int nw,
                 cudaStream_t stream) {
  const int nch = (b + 31) / 32;
  uint32_t* conf = scratch;
  uint32_t* okw = scratch + static_cast<size_t>(nch) * b;
  const dim3 grid((b + kTileTx - 1) / kTileTx, nch, nblk);
  mvcc_conf_kernel<kNR, kNW><<<grid, kConfThreads, 0, stream>>>(
      rk, rv, wk, cur, ok0, conf, okw, b, nr, nw);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = (kThreads + 2 * static_cast<size_t>(nch)) * 4;
  e = opt_in(mvcc_scan_kernel, smem, opted_scan);
  if (e != cudaSuccess) return static_cast<int>(e);
  mvcc_scan_kernel<<<nblk, kThreads, smem, stream>>>(conf, okw, valid, b);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory a one-CTA launch with b, nr, nw needs.
size_t smem_bytes(int b, int nr, int nw) {
  const size_t nch = (static_cast<size_t>(b) + 31) / 32;
  return (static_cast<size_t>(b) * (nr + nw) * 2 + nch * b + nch) *
         sizeof(uint32_t);
}

}  // namespace

extern "C" long long mvcc_validate_smem(int b, int nr, int nw) {
  return static_cast<long long>(smem_bytes(b, nr, nw));
}

// The scratch words the tiled route needs a block: conflict words, then ok
// words (block n's slice starts at n times this).
extern "C" long long mvcc_validate_scratch_words(int b) {
  const long long nch = (static_cast<long long>(b) + 31) / 32;
  return nch * b + nch;
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

extern "C" int mvcc_validate_tiled(const uint32_t* rk, const uint32_t* rv,
                                   const uint32_t* wk, const uint32_t* cur,
                                   const uint8_t* ok0, uint8_t* valid,
                                   uint32_t* scratch, int nblk, int b, int nr,
                                   int nw, cudaStream_t stream) {
  if (nr == 2 && nw == 2)
    return launch_tiled<2, 2>(rk, rv, wk, cur, ok0, valid, scratch, nblk, b,
                              nr, nw, stream);
  return launch_tiled<0, 0>(rk, rv, wk, cur, ok0, valid, scratch, nblk, b, nr,
                            nw, stream);
}
