// Flash attention: GQA, optional causal mask, online softmax. The forward
// (below) and, since the training path needs it, the backward (after the
// forward's kernels; it replaces no Pallas kernel, see there).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention (_flash_kernel). For query head h (KV head h / (H/Hkv)):
//   s = (q / sqrt(D)) k^T in f32, -inf where causal and kpos > qpos (both
//   counted from 0) or kpos >= Skv; online softmax over KV tiles with a
//   running max m and sum l, alpha = exp(m_old - m_new);
//   out = acc / max(l, 1e-37), in the input's dtype.
// Unlike the Pallas kernel, which requires S % block == 0, the tail rows and
// keys of any S and Skv are masked here.
//
// Bound: matrix products. At the serving shape (Qwen2-7B prefill, S = 2048,
// H = 28, Hkv = 4, D = 128, bf16) the causal half is 4 S^2/2 H D = 30 GFLOP
// against 34 MB of Q, K, V and O: ~900 operations a byte, far above the
// ~295 at which the tensor cores, not memory, set the pace; 0.030 ms at
// 989 TFLOP/s. Only wgmma reaches that rate on Hopper, and only if the
// tensor cores never wait for a load. Three kernels, chosen by dtype and D
// in launch<D> (the one C entry's only dispatch):
//   * bf16, D = 64, 96, 128 (every full-width model): flash_fwd_wgmma_kernel.
//     One CTA per (128-row q tile, query head, batch), 384 threads, one CTA
//     an SM (225 KB of shared memory at D = 128):
//     - a producer warpgroup (setmaxnreg down to 24 registers) whose one
//       thread starts TMA loads (cp.async.bulk.tensor over 4-D maps of the
//       (B, S, H, D) tensors as they lie, so no copy is made) of Q once and
//       of 128-key K and V tiles into a 3-stage ring; each stage has full
//       barriers for K and V and an empty barrier (mbarrier);
//     - two consumer warpgroups of 64 q rows (setmaxnreg up to 240). Each
//       step starts S = Q K^T of tile j (wgmma m64n128k16, both operands in
//       shared memory, K-major) and O += P V of tile j - 1 (wgmma m64nDk16,
//       P rounded to bf16 in registers: S's accumulator layout is wgmma's A
//       register layout; V read as it lies under the transpose bit), then
//       runs tile j's online softmax (registers, log2 domain) while the
//       second product is in flight, then releases tile j - 1's stage. The
//       two warpgroups take turns to start products (ping-pong on named
//       barriers), so one's softmax (exp2 on the MUFU, about half the tensor
//       cores' time for a tile at D = 128) also overlaps the other's.
//     Tiles are TMA boxes of 64 (D % 64 == 0) or 32 (D = 96) columns under
//     the 128- or 64-byte swizzle that the wgmma descriptors name. TMA
//     zero-fills rows past S or Skv within each batch; the mask runs only on
//     tiles that cross the causal diagonal or Skv. The KV loop stops at the
//     causal limit (kernel.py:40-42), and the heaviest q tiles are scheduled
//     first, so they do not form the tail wave.
//   * bf16, D = 16, 32 (smoke configurations only): flash_fwd_bf16_kernel,
//     mma.sync m16n8k16 on 4 warps of 16 rows, K and transposed V staged
//     through padded shared memory, no copy/compute overlap.
//   * f32 (no f32 tensor-core path keeps the reference's digits): 4 threads
//     per q row, each holding a quarter of q and O (dims sub, sub + 4, ...),
//     dot products on the CUDA cores over 32-row K/V tiles in shared memory.

#include <cmath>
#include <cstdint>
#include <cuda.h>  // CUtensorMap; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlockM = 64;     // q rows per CTA
constexpr int kBlockNBf16 = 64;  // kv rows per tile, bf16
constexpr int kBlockNF32 = 32;   // kv rows per tile, f32
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// KV tiles a q tile visits: all of Skv, cut at the causal limit.
__device__ __forceinline__ int kv_tiles(int iq, int skv, int block_n,
                                        bool causal) {
  int n = (skv + block_n - 1) / block_n;
  if (causal) n = min(n, ((iq + 1) * kBlockM + block_n - 1) / block_n);
  return n;
}

__device__ __forceinline__ bool masked(int row, int col, int skv,
                                       bool causal) {
  return col >= skv || (causal && col > row);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layouts of m16n8k16 (lane = 4 g + t): A holds rows g and g + 8,
// columns 2t, 2t + 1 (+8); B holds rows (k) 2t, 2t + 1 (+8) of column g;
// C holds rows g (c0, c1) and g + 8 (c2, c3), columns 2t, 2t + 1.
template <int D>
__global__ void __launch_bounds__(128)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int s, int skv, int h,
                          int hkv, float scale, bool causal) {
  constexpr int kN = kBlockNBf16;
  constexpr int kStrideK = D + 8;   // padded rows: conflict-free B reads
  constexpr int kStrideV = kN + 8;
  __shared__ __align__(16) __nv_bfloat16 ks[kN * kStrideK];
  __shared__ __align__(16) __nv_bfloat16 vt[D * kStrideV];  // vt[d][kv]

  const int iq = blockIdx.x, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (h / hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t q_stride = static_cast<size_t>(h) * D;
  const size_t kv_stride = static_cast<size_t>(hkv) * D;
  const __nv_bfloat16* qh = q + static_cast<size_t>(b) * s * q_stride +
                            static_cast<size_t>(hq) * D;
  const __nv_bfloat16* kh = k + static_cast<size_t>(b) * skv * kv_stride +
                            static_cast<size_t>(hk) * D;
  const __nv_bfloat16* vh = v + static_cast<size_t>(b) * skv * kv_stride +
                            static_cast<size_t>(hk) * D;
  const int r0 = iq * kBlockM + warp * 16 + g, r1 = r0 + 8;

  auto q_pair = [&](int row, int col) -> uint32_t {
    return row < s ? *reinterpret_cast<const uint32_t*>(
                         qh + row * q_stride + col)
                   : 0u;
  };
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qf[kk][0] = q_pair(r0, kk * 16 + 2 * t);
    qf[kk][1] = q_pair(r1, kk * 16 + 2 * t);
    qf[kk][2] = q_pair(r0, kk * 16 + 8 + 2 * t);
    qf[kk][3] = q_pair(r1, kk * 16 + 8 + 2 * t);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nd][i] = 0.f;
  // Running max (log2 domain) and this thread's share of the row sums.
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  const float scale2 = scale * kLog2e;

  const int n_tiles = kv_tiles(iq, skv, kN, causal);
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * kN;
    // Stage K row-major (16-byte chunks, coalesced) and V transposed (a
    // warp covers 32 kv rows of one chunk column: conflict-free stores).
    for (int c = threadIdx.x; c < kN * D / 8; c += blockDim.x) {
      const int row = c / (D / 8), col = (c % (D / 8)) * 8;
      uint4 w = make_uint4(0, 0, 0, 0);
      if (kv0 + row < skv)
        w = *reinterpret_cast<const uint4*>(kh + (kv0 + row) * kv_stride +
                                            col);
      *reinterpret_cast<uint4*>(ks + row * kStrideK + col) = w;
    }
    for (int c = threadIdx.x; c < kN * D / 8; c += blockDim.x) {
      const int row = c % kN, col = (c / kN) * 8;
      uint4 w = make_uint4(0, 0, 0, 0);
      if (kv0 + row < skv)
        w = *reinterpret_cast<const uint4*>(vh + (kv0 + row) * kv_stride +
                                            col);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt[(col + i) * kStrideV + row] = e[i];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys, scaled to log2 units.
    float sc[kN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kp = ks + (nt * 8 + g) * kStrideK + kk * 16 +
                                  2 * t;
        mma_bf16(sc[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = kv0 + nt * 8 + 2 * t + (i & 1);
        sc[nt][i] = masked(i < 2 ? r0 : r1, col, skv, causal)
                        ? -CUDART_INF_F
                        : sc[nt][i] * scale2;
      }
    }

    // Online softmax: new row maxima, rescale, exponentiate.
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(sc[nt][0], sc[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[nt][2], sc[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
    }
    // A row with no key seen yet keeps max -inf; subtract 0 there, not -inf.
    const float base0 = mx0 == -CUDART_INF_F ? 0.f : mx0;
    const float base1 = mx1 == -CUDART_INF_F ? 0.f : mx1;
    const float alpha0 = exp2f(m0 - base0), alpha1 = exp2f(m1 - base1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
      sc[nt][0] = exp2f(sc[nt][0] - base0);
      sc[nt][1] = exp2f(sc[nt][1] - base0);
      sc[nt][2] = exp2f(sc[nt][2] - base1);
      sc[nt][3] = exp2f(sc[nt][3] - base1);
      l0 += sc[nt][0] + sc[nt][1];
      l1 += sc[nt][2] + sc[nt][3];
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] *= alpha0;
      acc[nd][1] *= alpha0;
      acc[nd][2] *= alpha1;
      acc[nd][3] *= alpha1;
    }

    // O += P V: the C fragments of two adjacent key blocks of S are the A
    // fragment of one 16-key step.
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
          pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const __nv_bfloat16* vp = vt + (nd * 8 + g) * kStrideV + kk * 16 +
                                  2 * t;
        mma_bf16(acc[nd], pa, *reinterpret_cast<const uint32_t*>(vp),
                 *reinterpret_cast<const uint32_t*>(vp + 8));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-37f), inv1 = 1.f / fmaxf(l1, 1e-37f);
  __nv_bfloat16* oh = o + static_cast<size_t>(b) * s * q_stride +
                      static_cast<size_t>(hq) * D;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (r0 < s)
      *reinterpret_cast<uint32_t*>(oh + r0 * q_stride + col) =
          pack_bf16(acc[nd][0] * inv0, acc[nd][1] * inv0);
    if (r1 < s)
      *reinterpret_cast<uint32_t*>(oh + r1 * q_stride + col) =
          pack_bf16(acc[nd][2] * inv1, acc[nd][3] * inv1);
  }
  if (lse != nullptr && t == 0) {  // m is in log2 units
    float* lh = lse + (static_cast<size_t>(b) * h + hq) * s;
    if (r0 < s) lh[r0] = m0 * kLn2 + logf(l0);
    if (r1 < s) lh[r1] = m1 * kLn2 + logf(l1);
  }
}

// f32: 4 threads per q row (adjacent lanes), thread `sub` holding dims
// sub, sub + 4, ...: a warp's reads of a K/V row are 4 consecutive words,
// each broadcast to 8 threads.
template <int D>
__global__ void __launch_bounds__(256)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int s, int skv, int h,
                         int hkv, float scale, bool causal) {
  constexpr int kN = kBlockNF32;
  constexpr int kPer = D / 4;
  __shared__ __align__(16) float ks[kN * D];
  __shared__ __align__(16) float vs[kN * D];

  const int iq = blockIdx.x, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (h / hkv);
  const int row = iq * kBlockM + threadIdx.x / 4, sub = threadIdx.x % 4;
  const size_t q_stride = static_cast<size_t>(h) * D;
  const size_t kv_stride = static_cast<size_t>(hkv) * D;
  const float* qh = q + static_cast<size_t>(b) * s * q_stride +
                    static_cast<size_t>(hq) * D;
  const float* kh = k + static_cast<size_t>(b) * skv * kv_stride +
                    static_cast<size_t>(hk) * D;
  const float* vh = v + static_cast<size_t>(b) * skv * kv_stride +
                    static_cast<size_t>(hk) * D;

  float qr[kPer], acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    qr[i] = row < s ? qh[row * q_stride + i * 4 + sub] * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f;

  const int n_tiles = kv_tiles(iq, skv, kN, causal);
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * kN;
    for (int c = threadIdx.x; c < kN * D / 4; c += blockDim.x) {
      const int r = c / (D / 4), col = (c % (D / 4)) * 4;
      float4 kw = make_float4(0.f, 0.f, 0.f, 0.f), vw = kw;
      if (kv0 + r < skv) {
        kw = *reinterpret_cast<const float4*>(kh + (kv0 + r) * kv_stride +
                                              col);
        vw = *reinterpret_cast<const float4*>(vh + (kv0 + r) * kv_stride +
                                              col);
      }
      *reinterpret_cast<float4*>(ks + r * D + col) = kw;
      *reinterpret_cast<float4*>(vs + r * D + col) = vw;
    }
    __syncthreads();

    float sc[kN];
    float mx = m;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) part += qr[i] * ks[n * D + i * 4 + sub];
      part += __shfl_xor_sync(kFull, part, 1);
      part += __shfl_xor_sync(kFull, part, 2);
      sc[n] = masked(row, kv0 + n, skv, causal) ? -CUDART_INF_F : part;
      mx = fmaxf(mx, sc[n]);
    }
    const float base = mx == -CUDART_INF_F ? 0.f : mx;
    const float alpha = expf(m - base);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] *= alpha;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const float p = expf(sc[n] - base);
      l += p;
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] += p * vs[n * D + i * 4 + sub];
    }
    __syncthreads();
  }

  if (row < s) {
    float* oh = o + static_cast<size_t>(b) * s * q_stride +
                static_cast<size_t>(hq) * D;
    const float denom = fmaxf(l, 1e-37f);
#pragma unroll
    for (int i = 0; i < kPer; ++i) oh[row * q_stride + i * 4 + sub] =
        acc[i] / denom;
    if (lse != nullptr && sub == 0)
      lse[(static_cast<size_t>(b) * h + hq) * s + row] = m + logf(l);
  }
}

// ---------------------------------------------------------------------------
// bf16 at D = 64, 96, 128: TMA ring, producer warp, wgmma consumers.
namespace hopper {

constexpr int kM = 128;        // q rows per CTA: two consumer warpgroups of 64
constexpr int kN = 128;        // keys per K/V tile
constexpr int kStages = 3;     // depth of the K/V ring
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kMaxDevices = 64;
constexpr int kThreads = 128 * (1 + kConsumers);
static_assert(kM == kN, "Q, K and V tiles share one box shape");

// A tile of D columns is D / CW TMA boxes of (R rows, CW columns), each
// row CW * 2 bytes under the swizzle of that span: 128 bytes (CW = 64)
// where D % 64 == 0, 64 bytes (CW = 32) for D = 96. Eight rows are one
// swizzle atom; boxes are 1,024-byte aligned. R is 128 but for the
// backward's 64-row Q and dO tiles.
template <int D, int R = kM>
struct Tile {
  static constexpr int kCW = D % 64 == 0 ? 64 : 32;
  static constexpr int kChunks = D / kCW;
  static constexpr int kRowBytes = kCW * 2;
  static constexpr int kAtom = 8 * kRowBytes;
  static constexpr int kChunkBytes = R * kRowBytes;
  static constexpr int kBytes = kChunks * kChunkBytes;  // one Q, K or V tile
  static constexpr uint64_t kLayout = kCW == 64 ? 1 : 2;  // wgmma B128 / B64
  static constexpr int kSmem = (1 + 2 * kStages) * kBytes + 1024;
  static_assert(kSmem <= 227 * 1024, "over a block's shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a 4-D map {D, H, S, B} at {c0, c1, c2, c3} into shared memory;
// completion (the box's full bytes, zero-filled past the tensor) on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

// d (64 x 128 f32) = A (64 x 16, shared, K-major) B^T (B: 128 x 16, shared,
// K-major); d is overwritten when scale_d == 0.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 f32) = A (64 x 16, shared, K-major) B^T (B: 64 x 16, shared,
// K-major); d is overwritten when scale_d == 0.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 f32) += A (64 x 16, registers) B (16 x 64, shared, MN-major:
// the transpose bit reads V as it lies, keys by rows).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 96 f32) += A (64 x 16, registers) B (16 x 96, shared, MN-major:
// the transpose bit reads V as it lies, keys by rows).
__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32) += A (64 x 16, registers) B (16 x 128, shared, MN-major:
// the transpose bit reads V as it lies, keys by rows).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Named barriers 1 and 2 pass the turn to start products between the two
// consumer warpgroups (256 threads: one syncs, the other arrives).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// d = A B^T along D: A the 64 rows at `a` of an RA-row tile, B all RB rows
// of an RB-row tile (the product's N, 64 or 128), both K-major as TMA left
// them; D / 16 steps, no commit. S = Q K^T (forward, dQ) is <D, 128, 128>,
// S^T = K Q^T (dK/dV) <D, 128, 64>.
template <int D, int RA, int RB>
__device__ __forceinline__ void mma_abt(float (&d)[RB / 2], uint32_t a,
                                        uint32_t b) {
  using TA = Tile<D, RA>;
  using TB = Tile<D, RB>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 / TA::kCW, x = (kk * 16 % TA::kCW) * 2;
    const uint64_t da =
        desc(a + c * TA::kChunkBytes + x, 16, TA::kAtom, TA::kLayout);
    const uint64_t db =
        desc(b + c * TB::kChunkBytes + x, 16, TB::kAtom, TB::kLayout);
    if constexpr (RB == 128)
      wgmma_ss_n128(d, da, db, kk > 0);
    else
      wgmma_ss_n64(d, da, db, kk > 0);
  }
}

// d (64 x D) += A B: A (64 x R) in registers as wgmma's A fragments, B an
// R-row tile read as it lies (MN-major, D contiguous) under the transpose
// bit (the forward's O += P V reads V so); R / 16 steps, no commit.
template <int D, int R>
__device__ __forceinline__ void mma_ab(float (&d)[D / 2],
                                       const uint32_t (&a)[R / 4],
                                       uint32_t b) {
  using T = Tile<D, R>;
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk)
    wgmma_rs(d, a + 4 * kk,
             desc(b + kk * 16 * T::kRowBytes, T::kChunkBytes, T::kAtom,
                  T::kLayout));
}

// 2^x on the MUFU, denormal results flushed to 0: a P below 2^-126 is far
// below f32 resolution against the row's largest P, which is 1.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax over score tiles, log2 domain: running row maxima m and
// this thread's share of the row sums l for its two rows.
struct Softmax {
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // Mask (where asked) the raw scores sc of the tile at key kv0, update m
  // and l, overwrite sc with P = exp2(s - m), and return the factors by
  // which O must be rescaled.
  __device__ __forceinline__ void step(float (&sc)[kN / 2], float& alpha0,
                                       float& alpha1, bool mask, int kv0,
                                       int r0, int r1, int qd, int skv,
                                       int causal, float scale2) {
    if (mask) {
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        const int col = kv0 + (i / 4) * 8 + 2 * qd + (i & 1);
        const int row = (i & 2) ? r1 : r0;
        if (col >= skv || (causal && col > row)) sc[i] = -INFINITY;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < kN / 8; ++nb) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * nb], sc[4 * nb + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * nb + 2], sc[4 * nb + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
    }
    mx0 = fmaxf(m0, mx0 * scale2);
    mx1 = fmaxf(m1, mx1 * scale2);
    // A row with no key seen yet keeps max -inf; subtract 0 there.
    const float base0 = mx0 == -INFINITY ? 0.f : mx0;
    const float base1 = mx1 == -INFINITY ? 0.f : mx1;
    alpha0 = exp2_ftz(m0 - base0);
    alpha1 = exp2_ftz(m1 - base1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int nb = 0; nb < kN / 8; ++nb) {
      sc[4 * nb] = exp2_ftz(fmaf(sc[4 * nb], scale2, -base0));
      sc[4 * nb + 1] = exp2_ftz(fmaf(sc[4 * nb + 1], scale2, -base0));
      sc[4 * nb + 2] = exp2_ftz(fmaf(sc[4 * nb + 2], scale2, -base1));
      sc[4 * nb + 3] = exp2_ftz(fmaf(sc[4 * nb + 3], scale2, -base1));
      l0 += sc[4 * nb] + sc[4 * nb + 1];
      l1 += sc[4 * nb + 2] + sc[4 * nb + 3];
    }
  }
};

// An accumulator (P, dS) rounded to bf16 as the next product's A
// fragments. Run only when no product that reads `a` is in flight: a write
// to its registers would serialize wgmma.
template <int N>
__device__ __forceinline__ void pack_frags(const float (&x)[N],
                                           uint32_t (&a)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) a[i] = pack_bf16(x[2 * i], x[2 * i + 1]);
}

template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2], float alpha0,
                                        float alpha1) {
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    acc[4 * nd] *= alpha0;
    acc[4 * nd + 1] *= alpha0;
    acc[4 * nd + 2] *= alpha1;
    acc[4 * nd + 3] *= alpha1;
  }
}

// Accumulator layout of wgmma m64nN f32 (and of P as its A operand): warp
// `warp` of the warpgroup holds rows 16 warp + g and 16 warp + g + 8
// (lane = 4 g + qd); register 4 nb + i holds column 8 nb + 2 qd + (i & 1)
// of the first row (i < 2) or the second (i >= 2).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int s, int skv, int h,
                           int hkv, int n_q_tiles, float scale2,
                           int causal) {
  using T = Tile<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + T::kBytes, sv = sk + kStages * T::kBytes;
  const uint32_t bq = smem_u32(bars), bk = bq + 8, bv = bk + 8 * kStages,
                 be = bv + 8 * kStages;

  // All heads and batches of the last (heaviest causal) q tile first.
  const int per_tile = gridDim.x / n_q_tiles;
  const int iq = n_q_tiles - 1 - static_cast<int>(blockIdx.x) / per_tile;
  const int hb = static_cast<int>(blockIdx.x) % per_tile;
  const int hq = hb % h, b = hb / h;
  const int hk = hq / (h / hkv);
  const int q0 = iq * kM;
  int n_tiles = (skv + kN - 1) / kN;
  if (causal) n_tiles = min(n_tiles, (q0 + kM + kN - 1) / kN);

  if (threadIdx.x == 0) {
    mbar_init(bq, 1);
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(bk + 8 * i, 1);
      mbar_init(bv + 8 * i, 1);
      mbar_init(be + 8 * i, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      prefetch_map(&tq);
      prefetch_map(&tk);
      prefetch_map(&tv);
      mbar_expect_tx(bq, T::kBytes);
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c)
        tma_load(sq + c * T::kChunkBytes, &tq, bq, c * T::kCW, hq, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        // The stage's previous use has been released (passes at once on
        // the first use: the phase before the first counts as complete).
        mbar_wait(be + 8 * st, ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(bk + 8 * st, T::kBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(sk + st * T::kBytes + c * T::kChunkBytes, &tk, bk + 8 * st,
                   c * T::kCW, hk, j * kN, b);
        mbar_expect_tx(bv + 8 * st, T::kBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(sv + st * T::kBytes + c * T::kChunkBytes, &tv, bv + 8 * st,
                   c * T::kCW, hk, j * kN, b);
      }
    }
  } else {
    // Consumers: 64 q rows each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int w = wg - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, qd = lane % 4;
    const int row_first = q0 + 64 * w;
    const int r0 = row_first + 16 * warp + g, r1 = r0 + 8;
    const uint32_t q_wg = sq + 64 * w * T::kRowBytes;
    // The mask, only on a tile that crosses the diagonal or Skv (zero-
    // filled keys past Skv score 0, not -inf).
    auto needs_mask = [&](int kv0) {
      return kv0 + kN > skv || (causal && kv0 + kN - 1 > row_first);
    };

    float acc[D / 2], sc[kN / 2];
    uint32_t pa[kN / 4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) sc[i] = 0.f;
    // Running max (log2 domain) and this thread's share of the row sums.
    Softmax sm;
    float alpha0, alpha1;

    mbar_wait(bq, 0);
    if (n_tiles > 0) {
      // Tile 0: S alone. Then each step starts S of tile j and O += P V
      // of tile j - 1, and runs tile j's softmax while the second product
      // is in flight. The two warpgroups take turns to start them (ping-pong on
      // named barriers 1 and 2), so one's softmax also overlaps the
      // other's products.
      if (w == 1) bar_arrive(1, 256);  // warpgroup 0 first
      mbar_wait(bk, 0);
      bar_sync(1 + w, 256);
      fence_regs(sc);
      wgmma_fence();
      mma_abt<D, kM, kN>(sc, q_wg, sk);
      wgmma_commit();
      bar_arrive(2 - w, 256);
      wgmma_wait<0>();
      fence_regs(sc);
      sm.step(sc, alpha0, alpha1, needs_mask(0), 0, r0, r1, qd, skv, causal,
              scale2);
      pack_frags(sc, pa);
      for (int j = 1; j < n_tiles; ++j) {
        const int st = j % kStages, sp = (j - 1) % kStages;
        mbar_wait(bk + 8 * st, (j / kStages) & 1);
        mbar_wait(bv + 8 * sp, ((j - 1) / kStages) & 1);
        bar_sync(1 + w, 256);
        fence_regs(sc);
        wgmma_fence();
        mma_abt<D, kM, kN>(sc, q_wg, sk + st * T::kBytes);
        wgmma_commit();
        rescale<D>(acc, alpha0, alpha1);  // while S is in flight
        fence_regs(acc);
        wgmma_fence();
        mma_ab<D, kN>(acc, pa, sv + sp * T::kBytes);
        wgmma_commit();
        bar_arrive(2 - w, 256);
        wgmma_wait<1>();
        fence_regs(sc);
        sm.step(sc, alpha0, alpha1, needs_mask(j * kN), j * kN, r0, r1, qd,
                skv, causal, scale2);
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(be + 8 * sp);
        pack_frags(sc, pa);
      }
      const int sl = (n_tiles - 1) % kStages;
      mbar_wait(bv + 8 * sl, ((n_tiles - 1) / kStages) & 1);
      bar_sync(1 + w, 256);
      rescale<D>(acc, alpha0, alpha1);
      fence_regs(acc);
      wgmma_fence();
      mma_ab<D, kN>(acc, pa, sv + sl * T::kBytes);
      wgmma_commit();
      if (w == 0) bar_arrive(2 - w, 256);  // no turn after
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(be + 8 * sl);
    }
    float l0 = sm.l0, l1 = sm.l1;

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(kFull, l0, off);
      l1 += __shfl_xor_sync(kFull, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-37f);
    const float inv1 = 1.f / fmaxf(l1, 1e-37f);
    const size_t q_stride = static_cast<size_t>(h) * D;
    __nv_bfloat16* o0 = o + (static_cast<size_t>(b) * s + r0) * q_stride +
                        static_cast<size_t>(hq) * D;
    __nv_bfloat16* o1 = o0 + 8 * q_stride;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int col = nd * 8 + 2 * qd;
      if (r0 < s)
        *reinterpret_cast<uint32_t*>(o0 + col) =
            pack_bf16(acc[4 * nd] * inv0, acc[4 * nd + 1] * inv0);
      if (r1 < s)
        *reinterpret_cast<uint32_t*>(o1 + col) =
            pack_bf16(acc[4 * nd + 2] * inv1, acc[4 * nd + 3] * inv1);
    }
    if (lse != nullptr && qd == 0) {  // m is in log2 units
      float* lh = lse + (static_cast<size_t>(b) * h + hq) * s;
      if (r0 < s) lh[r0] = sm.m0 * kLn2 + logf(l0);
      if (r1 < s) lh[r1] = sm.m1 * kLn2 + logf(l1);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: found through the
// runtime, so the library links no -lcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (batch, rows, heads, D) bf16 tensor as it lies, as a 4-D map
// {D, heads, rows, batch}; boxes of (CW, 1, box_rows, 1).
template <int D>
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int batch,
            int rows, int heads, int box_rows = kM) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(heads) * D * 2,
      static_cast<cuuint64_t>(rows) * heads * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Tile<D>::kCW), 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             Tile<D>::kCW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int s, int skv, int h, int hkv,
                   bool causal, cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap mq, mk, mv;
  if (!encode<D>(enc, &mq, q, b, s, h)) return cudaErrorInvalidValue;
  if (skv > 0) {
    if (!encode<D>(enc, &mk, k, b, skv, hkv) ||
        !encode<D>(enc, &mv, v, b, skv, hkv))
      return cudaErrorInvalidValue;
  } else {
    mk = mv = mq;  // no key: the kernel loads no K or V tile
  }
  // Shared memory above 48 KB: opted into once per device.
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tile<D>::kSmem);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  const int n_q_tiles = (s + kM - 1) / kM;
  const float scale2 =
      static_cast<float>(1.0 / std::sqrt(double(D))) * kLog2e;
  flash_fwd_wgmma_kernel<D>
      <<<n_q_tiles * h * b, kThreads, Tile<D>::kSmem, stream>>>(
          mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, s, skv, h, hkv,
          n_q_tiles, scale2, causal);
  return cudaGetLastError();
}

}  // namespace hopper

// The one place that picks a kernel, by dtype and D (see the header).
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int s, int skv, int h, int hkv,
                   bool bf16, bool causal, cudaStream_t stream) {
  const dim3 grid((s + kBlockM - 1) / kBlockM, h, b);
  const float scale = static_cast<float>(1.0 / std::sqrt(double(D)));
  if (bf16) {
    if constexpr (D >= 64) {
      return hopper::launch<D>(q, k, v, o, lse, b, s, skv, h, hkv, causal,
                               stream);
    } else {
      flash_fwd_bf16_kernel<D><<<grid, 128, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<__nv_bfloat16*>(o), lse, s, skv, h, hkv, scale,
          causal);
    }
  } else {
    flash_fwd_f32_kernel<D><<<grid, 256, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, s, skv, h,
        hkv, scale, causal);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward (no Pallas kernel: the JAX package differentiates attn_naive, or
// attn_chunked past 2 q_chunk; these kernels compute the same gradient). From
// the forward's O and each row's log-sum-exp (natural log, (B, H, S) f32):
//   delta = rowsum(dO o O);  P = exp(S - lse), recomputed from Q and K;
//   dV = P^T dO;  dP = dO V^T;  dS = P o (dP - delta);
//   dQ = dS K / sqrt(D);  dK = dS^T Q / sqrt(D);
// dK and dV sum over the query heads that share a KV head (GQA). Three
// launches by flash_attention_bwd, the kernels chosen by dtype and D in
// launch_bwd<D> (the C entry's only dispatch):
//   * flash_bwd_delta_kernel: one warp a (b, row, head), f32 sum; it reads
//     O and dO once (117 MB at the training shape);
//   * dQ: one CTA per q tile, query head and batch; it loops over the key
//     tiles up to the causal limit, as the forward does;
//   * dK/dV: one CTA per key tile, KV head and batch; it loops over the
//     group's query heads and, for each, over the q tiles that the causal
//     mask lets see the key tile, holding dK and dV in f32 registers, and
//     writes them once.
// No atomics and no split across CTAs: every output element is summed by
// one thread in a fixed order, so a launch is bit-for-bit repeatable (the
// training step chains a digest of its gradients into the ledger, and its
// restarts must repeat a run to the bit). The price: dQ and dK/dV each
// recompute S and dP, 7 products where one pass with an ordered dQ
// reduction would run 5.
//
// Bound: matrix products. At the training shape (4, 2048, 28, 4, 128) bf16
// causal the 5 products of the gradient are 2.5x the forward's causal
// FLOPs, 300.8 GFLOP, 0.304 ms at 989 TFLOP/s; the 7 this split runs take
// 0.426 ms there. Only wgmma reaches that rate, and only if the tensor
// cores never wait for a load:
//   * bf16, D = 64, 96, 128 (every full-width model): the hopper kernels
//     below the f32 ones, built from the forward's parts (TMA maps of the
//     tensors as they lie, an mbarrier ring fed by a producer warpgroup,
//     two consumer warpgroups under setmaxnreg, SS and RS wgmma with the
//     transpose bit, a product's accumulator layout as the next one's A
//     fragments):
//     - flash_bwd_dkdv_wgmma_kernel: a CTA owns 128 keys (a consumer 64),
//       K and V loaded once by TMA; the producer streams 64-row Q and dO
//       tiles through a 3-stage ring, its second warp copying each tile's
//       lse (log2 units, +inf past S, so those rows get P = 0) and delta
//       beside them. A step runs keys by queries: S^T = K Q^T and dP^T =
//       V dO^T (SS m64n64k16, both K-major), P^T and dS^T in registers,
//       then dV += P^T dO and dK += dS^T Q (RS, Q and dO read as they lie
//       under the transpose bit). 64 q rows a step keep a consumer at dK
//       and dV (2 x D / 2 registers) plus S^T and dP^T (2 x 32). Key tile
//       0, which the causal mask lets the most q tiles see, runs first.
//     - flash_bwd_dq_wgmma_kernel: the forward's kernel with the online
//       softmax taken out and a product added: a CTA owns 128 q rows (a
//       consumer 64), Q and dO loaded once, 128-key K and V tiles through a
//       2-stage ring (3 at D < 128); S = Q K^T and dP = dO V^T (SS
//       m64n128k16), dS from the stored lse, dQ += dS K (RS). The heaviest
//       q tiles run first.
//     The causal mask runs only on tiles that cross the diagonal (dQ: or
//     Skv); rows of dK and dV past Skv and of dQ past S are not stored.
//   * bf16, D = 16, 32 (smoke configurations only): flash_bwd_dq_bf16_kernel
//     and flash_bwd_dkdv_bf16_kernel, mma.sync m16n8k16 on 4 warps of 16
//     rows, tiles staged through padded shared memory, row-major where a
//     product reads along D and transposed where it reads along the rows,
//     no copy/compute overlap.
//   * f32: CUDA cores, 4 threads a row, each holding a quarter of D, as the
//     forward's f32 kernel.
// Every bf16 kernel rounds P and dS to bf16 for their products, and dQ,
// dK, dV to bf16 at the end, and accumulates in f32.

constexpr int kBwdM = 64;  // q rows of a dQ CTA; keys of a dK/dV CTA
constexpr int kBwdN = 64;  // keys of a dQ step
constexpr int kBwdQ = 32;  // q rows of a dK/dV step

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// delta[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d], f32; warp `row` of
// the (B, S, H) rows, lanes strided over D.
template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                           float* __restrict__ delta, int rows, int s, int h,
                           int d) {
  const int row = blockIdx.x * 8 + static_cast<int>(threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp
  const T* op = o + static_cast<size_t>(row) * d;
  const T* dp = dout + static_cast<size_t>(row) * d;
  float acc = 0.f;
  for (int i = lane; i < d; i += 32) acc += to_f32(op[i]) * to_f32(dp[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) {
    const int hq = row % h, bi = row / h;
    delta[(static_cast<size_t>(bi / s) * h + hq) * s + bi % s] = acc;
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 x 16) of a row-major tile (`stride` elements a row): rows
// r .. r + 15, columns k0 .. k0 + 15 (layouts above flash_fwd_bf16_kernel).
__device__ __forceinline__ void frag_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int stride,
                                       int r, int k0, int g, int t) {
  const __nv_bfloat16* p = tile + (r + g) * stride + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * stride);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * stride + 8);
}

// B fragment (16 x 8) of a tile stored [n][k] (`stride` elements a row of
// n): columns n0 .. n0 + 7, rows k0 .. k0 + 15.
__device__ __forceinline__ void frag_b(uint32_t& b0, uint32_t& b1,
                                       const __nv_bfloat16* tile, int stride,
                                       int n0, int k0, int g, int t) {
  const __nv_bfloat16* p = tile + (n0 + g) * stride + k0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// Rows r0 .. r0 + n - 1 of one head of a (B, S, H, D) tensor (`stride`
// elements a row) into a row-major tile of D + 8 columns, zero from row
// `limit` on; 16 bytes a thread, coalesced.
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           size_t stride, int r0, int n,
                                           int limit) {
  for (int c = threadIdx.x; c < n * D / 8; c += blockDim.x) {
    const int row = c / (D / 8), col = (c % (D / 8)) * 8;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (r0 + row < limit)
      w = *reinterpret_cast<const uint4*>(src + (r0 + row) * stride + col);
    *reinterpret_cast<uint4*>(dst + row * (D + 8) + col) = w;
  }
}

// The same rows transposed, dst[d][row] with n + 8 columns; a warp covers
// 32 rows of one 8-column chunk (conflict-free stores).
template <int D>
__device__ __forceinline__ void stage_cols(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           size_t stride, int r0, int n,
                                           int limit) {
  for (int c = threadIdx.x; c < n * D / 8; c += blockDim.x) {
    const int row = c % n, col = (c / n) * 8;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (r0 + row < limit)
      w = *reinterpret_cast<const uint4*>(src + (r0 + row) * stride + col);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(col + i) * (n + 8) + row] = e[i];
  }
}

// Dynamic shared memory of the bf16 backward kernels, in bytes.
template <int D>
struct BwdSmem {
  static constexpr int kRow = D + 8;
  // dQ: Q and dO (kBwdM rows), K and V (kBwdN rows), K^T (D x kBwdN + 8).
  static constexpr int kDq =
      (2 * kBwdM * kRow + 2 * kBwdN * kRow + D * (kBwdN + 8)) * 2;
  // dK/dV: K and V (kBwdM rows), Q and dO (kBwdQ rows), Q^T and dO^T
  // (D x kBwdQ + 8), then lse and delta of the kBwdQ rows (f32).
  static constexpr int kDkv =
      (2 * kBwdM * kRow + 2 * kBwdQ * kRow + 2 * D * (kBwdQ + 8)) * 2 +
      2 * kBwdQ * 4;
  static_assert(kDq <= 227 * 1024 && kDkv <= 227 * 1024,
                "over a block's shared memory");
};

// dQ, bf16: warp w holds q rows q0 + 16 w .. + 15 of the CTA's 64.
template <int D>
__global__ void __launch_bounds__(128)
    flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int s, int skv,
                             int h, int hkv, float scale, bool causal) {
  constexpr int kRow = D + 8, kRowT = kBwdN + 8;
  extern __shared__ __align__(16) uint8_t smem_bwd[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_bwd);
  __nv_bfloat16* dos = qs + kBwdM * kRow;
  __nv_bfloat16* ks = dos + kBwdM * kRow;
  __nv_bfloat16* vs = ks + kBwdN * kRow;
  __nv_bfloat16* kt = vs + kBwdN * kRow;  // kt[d][key]

  const int iq = blockIdx.x, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (h / hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t q_stride = static_cast<size_t>(h) * D;
  const size_t kv_stride = static_cast<size_t>(hkv) * D;
  const size_t q_off = static_cast<size_t>(b) * s * q_stride +
                       static_cast<size_t>(hq) * D;
  const size_t kv_off = static_cast<size_t>(b) * skv * kv_stride +
                        static_cast<size_t>(hk) * D;
  const int q0 = iq * kBwdM;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float scale2 = scale * kLog2e;
  const float* lh = lse + (static_cast<size_t>(b) * h + hq) * s;
  const float* dh = delta + (static_cast<size_t>(b) * h + hq) * s;
  const float lse0 = r0 < s ? lh[r0] * kLog2e : 0.f;
  const float lse1 = r1 < s ? lh[r1] * kLog2e : 0.f;
  const float dl0 = r0 < s ? dh[r0] : 0.f, dl1 = r1 < s ? dh[r1] : 0.f;

  stage_rows<D>(qs, q + q_off, q_stride, q0, kBwdM, s);
  stage_rows<D>(dos, dout + q_off, q_stride, q0, kBwdM, s);

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nd][i] = 0.f;

  int n_tiles = (skv + kBwdN - 1) / kBwdN;
  if (causal) n_tiles = min(n_tiles, (q0 + kBwdM + kBwdN - 1) / kBwdN);
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * kBwdN;
    __syncthreads();  // the previous tile's reads are done
    stage_rows<D>(ks, k + kv_off, kv_stride, kv0, kBwdN, skv);
    stage_rows<D>(vs, v + kv_off, kv_stride, kv0, kBwdN, skv);
    stage_cols<D>(kt, k + kv_off, kv_stride, kv0, kBwdN, skv);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys.
    float sc[kBwdN / 8][4], dp[kBwdN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBwdN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      frag_a(qa, qs, kRow, warp * 16, kk * 16, g, t);
      frag_a(da, dos, kRow, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < kBwdN / 8; ++nt) {
        uint32_t b0, b1;
        frag_b(b0, b1, ks, kRow, nt * 8, kk * 16, g, t);
        mma_bf16(sc[nt], qa, b0, b1);
        frag_b(b0, b1, vs, kRow, nt * 8, kk * 16, g, t);
        mma_bf16(dp[nt], da, b0, b1);
      }
    }
    // dS = P o (dP - delta), P = exp2(s scale log2e - lse log2e); 0 where
    // masked and on rows past S.
#pragma unroll
    for (int nt = 0; nt < kBwdN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i < 2 ? r0 : r1;
        const int col = kv0 + nt * 8 + 2 * t + (i & 1);
        const float p =
            row >= s || masked(row, col, skv, causal)
                ? 0.f
                : exp2f(fmaf(sc[nt][i], scale2, i < 2 ? -lse0 : -lse1));
        sc[nt][i] = p * (dp[nt][i] - (i < 2 ? dl0 : dl1));
      }
    // dQ += dS K: dS's C fragments of two key blocks are one A fragment.
#pragma unroll
    for (int kk = 0; kk < kBwdN / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
          pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        uint32_t b0, b1;
        frag_b(b0, b1, kt, kRowT, nd * 8, kk * 16, g, t);
        mma_bf16(acc[nd], pa, b0, b1);
      }
    }
  }

  __nv_bfloat16* oh = dq + q_off;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (r0 < s)
      *reinterpret_cast<uint32_t*>(oh + r0 * q_stride + col) =
          pack_bf16(acc[nd][0] * scale, acc[nd][1] * scale);
    if (r1 < s)
      *reinterpret_cast<uint32_t*>(oh + r1 * q_stride + col) =
          pack_bf16(acc[nd][2] * scale, acc[nd][3] * scale);
  }
}

// dK and dV, bf16: warp w holds keys k0 + 16 w .. + 15 of the CTA's 64; the
// products run keys by q rows (S^T = K Q^T, dP^T = V dO^T), so P^T and dS^T
// are the A operands of dV += P^T dO and dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(128)
    flash_bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int s, int skv,
                               int h, int hkv, float scale, bool causal) {
  constexpr int kRow = D + 8, kRowT = kBwdQ + 8;
  extern __shared__ __align__(16) uint8_t smem_bwd[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_bwd);
  __nv_bfloat16* vs = ks + kBwdM * kRow;
  __nv_bfloat16* qs = vs + kBwdM * kRow;
  __nv_bfloat16* dos = qs + kBwdQ * kRow;
  __nv_bfloat16* qt = dos + kBwdQ * kRow;   // qt[d][q]
  __nv_bfloat16* dot = qt + D * kRowT;      // dot[d][q]
  float* ls = reinterpret_cast<float*>(dot + D * kRowT);
  float* dls = ls + kBwdQ;

  const int ik = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = h / hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t q_stride = static_cast<size_t>(h) * D;
  const size_t kv_stride = static_cast<size_t>(hkv) * D;
  const size_t kv_off = static_cast<size_t>(b) * skv * kv_stride +
                        static_cast<size_t>(hk) * D;
  const int k0 = ik * kBwdM;
  const int kr0 = k0 + warp * 16 + g, kr1 = kr0 + 8;
  const float scale2 = scale * kLog2e;

  stage_rows<D>(ks, k + kv_off, kv_stride, k0, kBwdM, skv);
  stage_rows<D>(vs, v + kv_off, kv_stride, k0, kBwdM, skv);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[nd][i] = dva[nd][i] = 0.f;

  const int n_q = (s + kBwdQ - 1) / kBwdQ;
  // Causal: the first q tile with a row at or past the tile's first key.
  const int i_first = causal ? min(k0 / kBwdQ, n_q) : 0;
  for (int hq = hk * group; hq < (hk + 1) * group; ++hq) {
    const size_t q_off = static_cast<size_t>(b) * s * q_stride +
                         static_cast<size_t>(hq) * D;
    const float* lh = lse + (static_cast<size_t>(b) * h + hq) * s;
    const float* dh = delta + (static_cast<size_t>(b) * h + hq) * s;
    for (int i = i_first; i < n_q; ++i) {
      const int q0 = i * kBwdQ;
      __syncthreads();  // the previous q tile's reads are done
      stage_rows<D>(qs, q + q_off, q_stride, q0, kBwdQ, s);
      stage_rows<D>(dos, dout + q_off, q_stride, q0, kBwdQ, s);
      stage_cols<D>(qt, q + q_off, q_stride, q0, kBwdQ, s);
      stage_cols<D>(dot, dout + q_off, q_stride, q0, kBwdQ, s);
      for (int c = threadIdx.x; c < kBwdQ; c += blockDim.x) {
        ls[c] = q0 + c < s ? lh[q0 + c] * kLog2e : 0.f;
        dls[c] = q0 + c < s ? dh[q0 + c] : 0.f;
      }
      __syncthreads();

      float st[kBwdQ / 8][4], dpt[kBwdQ / 8][4];
#pragma unroll
      for (int nt = 0; nt < kBwdQ / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        frag_a(ka, ks, kRow, warp * 16, kk * 16, g, t);
        frag_a(va, vs, kRow, warp * 16, kk * 16, g, t);
#pragma unroll
        for (int nt = 0; nt < kBwdQ / 8; ++nt) {
          uint32_t b0, b1;
          frag_b(b0, b1, qs, kRow, nt * 8, kk * 16, g, t);
          mma_bf16(st[nt], ka, b0, b1);
          frag_b(b0, b1, dos, kRow, nt * 8, kk * 16, g, t);
          mma_bf16(dpt[nt], va, b0, b1);
        }
      }
      // P^T and dS^T = P^T o (dP^T - delta); 0 where masked, on q rows
      // past S and on keys past Skv.
#pragma unroll
      for (int nt = 0; nt < kBwdQ / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? kr0 : kr1;
          const int qi = nt * 8 + 2 * t + (e & 1), qrow = q0 + qi;
          const float p = qrow >= s || masked(qrow, key, skv, causal)
                              ? 0.f
                              : exp2f(fmaf(st[nt][e], scale2, -ls[qi]));
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - dls[qi]);
        }
      // dV += P^T dO, dK += dS^T Q, 16 q rows a step.
#pragma unroll
      for (int kk = 0; kk < kBwdQ / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(st[2 * kk][0], st[2 * kk][1]),
            pack_bf16(st[2 * kk][2], st[2 * kk][3]),
            pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
            pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
        const uint32_t sa[4] = {
            pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
            pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
            pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
            pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          uint32_t b0, b1;
          frag_b(b0, b1, dot, kRowT, nd * 8, kk * 16, g, t);
          mma_bf16(dva[nd], pa, b0, b1);
          frag_b(b0, b1, qt, kRowT, nd * 8, kk * 16, g, t);
          mma_bf16(dka[nd], sa, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (kr0 < skv) {
      const size_t at = kv_off + kr0 * kv_stride + col;
      *reinterpret_cast<uint32_t*>(dk + at) =
          pack_bf16(dka[nd][0] * scale, dka[nd][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at) =
          pack_bf16(dva[nd][0], dva[nd][1]);
    }
    if (kr1 < skv) {
      const size_t at = kv_off + kr1 * kv_stride + col;
      *reinterpret_cast<uint32_t*>(dk + at) =
          pack_bf16(dka[nd][2] * scale, dka[nd][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + at) =
          pack_bf16(dva[nd][2], dva[nd][3]);
    }
  }
}

// dQ, f32: 4 threads a q row (thread `sub` holds dims sub, sub + 4, ...),
// 32-key K/V tiles in shared memory, as flash_fwd_f32_kernel.
template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int s, int skv, int h,
                            int hkv, float scale, bool causal) {
  constexpr int kN = kBlockNF32;
  constexpr int kPer = D / 4;
  __shared__ __align__(16) float ks[kN * D];
  __shared__ __align__(16) float vs[kN * D];

  const int iq = blockIdx.x, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (h / hkv);
  const int row = iq * kBlockM + threadIdx.x / 4, sub = threadIdx.x % 4;
  const size_t q_stride = static_cast<size_t>(h) * D;
  const size_t kv_stride = static_cast<size_t>(hkv) * D;
  const size_t q_off = static_cast<size_t>(b) * s * q_stride +
                       static_cast<size_t>(hq) * D;
  const float* kh = k + static_cast<size_t>(b) * skv * kv_stride +
                    static_cast<size_t>(hk) * D;
  const float* vh = v + static_cast<size_t>(b) * skv * kv_stride +
                    static_cast<size_t>(hk) * D;
  const size_t lrow = (static_cast<size_t>(b) * h + hq) * s + row;
  const float lr = row < s ? lse[lrow] : 0.f;
  const float dl = row < s ? delta[lrow] : 0.f;

  float qr[kPer], dor[kPer], acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const size_t at = q_off + row * q_stride + i * 4 + sub;
    qr[i] = row < s ? q[at] * scale : 0.f;  // as the forward scales it
    dor[i] = row < s ? dout[at] : 0.f;
    acc[i] = 0.f;
  }

  const int n_tiles = kv_tiles(iq, skv, kN, causal);
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * kN;
    for (int c = threadIdx.x; c < kN * D / 4; c += blockDim.x) {
      const int r = c / (D / 4), col = (c % (D / 4)) * 4;
      float4 kw = make_float4(0.f, 0.f, 0.f, 0.f), vw = kw;
      if (kv0 + r < skv) {
        kw = *reinterpret_cast<const float4*>(kh + (kv0 + r) * kv_stride +
                                              col);
        vw = *reinterpret_cast<const float4*>(vh + (kv0 + r) * kv_stride +
                                              col);
      }
      *reinterpret_cast<float4*>(ks + r * D + col) = kw;
      *reinterpret_cast<float4*>(vs + r * D + col) = vw;
    }
    __syncthreads();
#pragma unroll 4
    for (int n = 0; n < kN; ++n) {
      float sp = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        sp += qr[i] * ks[n * D + i * 4 + sub];
        dp += dor[i] * vs[n * D + i * 4 + sub];
      }
      sp += __shfl_xor_sync(kFull, sp, 1);
      sp += __shfl_xor_sync(kFull, sp, 2);
      dp += __shfl_xor_sync(kFull, dp, 1);
      dp += __shfl_xor_sync(kFull, dp, 2);
      const float p =
          row >= s || masked(row, kv0 + n, skv, causal) ? 0.f
                                                        : expf(sp - lr);
      const float ds = p * (dp - dl);
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] += ds * ks[n * D + i * 4 + sub];
    }
    __syncthreads();
  }
  if (row < s) {
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      dq[q_off + row * q_stride + i * 4 + sub] = acc[i] * scale;
  }
}

// dK and dV, f32: 4 threads a key row of the CTA's 64, q tiles of 32 rows
// (Q pre-scaled as the forward scales it, so dK comes out scaled) in shared
// memory.
template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int s, int skv, int h, int hkv, float scale,
                              bool causal) {
  constexpr int kPer = D / 4;
  __shared__ __align__(16) float qs[kBwdQ * D];
  __shared__ __align__(16) float dos[kBwdQ * D];
  __shared__ float ls[kBwdQ], dls[kBwdQ];

  const int ik = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = h / hkv;
  const int key = ik * kBwdM + threadIdx.x / 4, sub = threadIdx.x % 4;
  const size_t q_stride = static_cast<size_t>(h) * D;
  const size_t kv_stride = static_cast<size_t>(hkv) * D;
  const size_t kv_at = static_cast<size_t>(b) * skv * kv_stride +
                       static_cast<size_t>(hk) * D + key * kv_stride;

  float kr[kPer], vr[kPer], dka[kPer], dva[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    kr[i] = key < skv ? k[kv_at + i * 4 + sub] : 0.f;
    vr[i] = key < skv ? v[kv_at + i * 4 + sub] : 0.f;
    dka[i] = dva[i] = 0.f;
  }

  const int n_q = (s + kBwdQ - 1) / kBwdQ;
  const int i_first = causal ? min(ik * kBwdM / kBwdQ, n_q) : 0;
  for (int hq = hk * group; hq < (hk + 1) * group; ++hq) {
    const float* qh = q + static_cast<size_t>(b) * s * q_stride +
                      static_cast<size_t>(hq) * D;
    const float* doh = dout + static_cast<size_t>(b) * s * q_stride +
                       static_cast<size_t>(hq) * D;
    const size_t lh = (static_cast<size_t>(b) * h + hq) * s;
    for (int i = i_first; i < n_q; ++i) {
      const int q0 = i * kBwdQ;
      __syncthreads();
      for (int c = threadIdx.x; c < kBwdQ * D / 4; c += blockDim.x) {
        const int r = c / (D / 4), col = (c % (D / 4)) * 4;
        float4 qw = make_float4(0.f, 0.f, 0.f, 0.f), dw = qw;
        if (q0 + r < s) {
          qw = *reinterpret_cast<const float4*>(qh + (q0 + r) * q_stride +
                                                col);
          dw = *reinterpret_cast<const float4*>(doh + (q0 + r) * q_stride +
                                                col);
        }
        qw.x *= scale;
        qw.y *= scale;
        qw.z *= scale;
        qw.w *= scale;
        *reinterpret_cast<float4*>(qs + r * D + col) = qw;
        *reinterpret_cast<float4*>(dos + r * D + col) = dw;
      }
      for (int c = threadIdx.x; c < kBwdQ; c += blockDim.x) {
        ls[c] = q0 + c < s ? lse[lh + q0 + c] : 0.f;
        dls[c] = q0 + c < s ? delta[lh + q0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int n = 0; n < kBwdQ; ++n) {
        float sp = 0.f, dp = 0.f;
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          sp += kr[e] * qs[n * D + e * 4 + sub];
          dp += vr[e] * dos[n * D + e * 4 + sub];
        }
        sp += __shfl_xor_sync(kFull, sp, 1);
        sp += __shfl_xor_sync(kFull, sp, 2);
        dp += __shfl_xor_sync(kFull, dp, 1);
        dp += __shfl_xor_sync(kFull, dp, 2);
        const int qrow = q0 + n;
        const float p = qrow >= s || masked(qrow, key, skv, causal)
                            ? 0.f
                            : expf(sp - ls[n]);
        const float ds = p * (dp - dls[n]);
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          dva[e] += p * dos[n * D + e * 4 + sub];
          dka[e] += ds * qs[n * D + e * 4 + sub];
        }
      }
    }
  }
  if (key < skv) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      dk[kv_at + i * 4 + sub] = dka[i];
      dv[kv_at + i * 4 + sub] = dva[i];
    }
  }
}

// Shared memory above 48 KB: opted into once per device and kernel.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes, bool (&done)[hopper::kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= hopper::kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// bf16 backward at D = 64, 96, 128: TMA rings, producer warps, wgmma
// consumers (the backward's header says what and why).
namespace hopper {

constexpr int kBwdRows = 64;  // q rows of a dK/dV step
// The backward's consumers need up to ~220 registers (dK and dV, or dQ,
// beside S and dP); the producer's second warp copies lse and delta.
constexpr int kBwdProducerRegs = 40, kBwdConsumerRegs = 232;

// dK/dV's dynamic shared memory: K and V (128 rows) once, then a ring of Q
// and dO tiles (64 rows each a stage), 1 KB of alignment slack.
template <int D>
struct DkvSmem {
  using KV = Tile<D, kN>;
  using QO = Tile<D, kBwdRows>;
  static constexpr int kStages = 3;
  static constexpr int kStage = 2 * QO::kBytes;
  static constexpr int kBytes = 2 * KV::kBytes + kStages * kStage + 1024;
  static_assert(kBytes + kStages * kBwdRows * 8 <= 227 * 1024,
                "over a block's shared memory");
};

// dQ's: Q and dO (128 rows) once, then a ring of K and V tiles (128 keys).
template <int D>
struct DqSmem {
  using T = Tile<D, kM>;
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kBytes = (2 + 2 * kStages) * T::kBytes + 1024;
  static_assert(kBytes <= 227 * 1024, "over a block's shared memory");
};

// dK and dV of 128 keys of one KV head (a consumer warpgroup 64 keys: rows
// of S^T and dP^T, the accumulator layout above flash_fwd_wgmma_kernel with
// q in place of keys), summed over the group's query heads and their causal
// q tiles in that order.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                __nv_bfloat16* __restrict__ dk,
                                __nv_bfloat16* __restrict__ dv, int s,
                                int skv, int h, int hkv, int n_k_tiles,
                                float scale, int causal) {
  using L = DkvSmem<D>;
  using KV = typename L::KV;
  using QO = typename L::QO;
  constexpr int kS = L::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kS];
  // Each stage's lse (log2 units) and delta, by the tile's q row.
  __shared__ float ls[kS][kBwdRows], dls[kS][kBwdRows];
  const uint32_t sk = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sv = sk + KV::kBytes, sq = sv + KV::kBytes;
  const uint32_t bkv = smem_u32(bars), bf = bkv + 8, be = bf + 8 * kS;

  // Key tile 0 of every KV head and batch first.
  const int per_tile = gridDim.x / n_k_tiles;
  const int ik = static_cast<int>(blockIdx.x) / per_tile;
  const int hb = static_cast<int>(blockIdx.x) % per_tile;
  const int hk = hb % hkv, b = hb / hkv;
  const int group = h / hkv;
  const int k0 = ik * kN;
  const int n_q = (s + kBwdRows - 1) / kBwdRows;
  // Causal: the first q tile with a row at or past the tile's first key.
  const int i_first = causal ? min(k0 / kBwdRows, n_q) : 0;
  // Step n: query head hk * group + n / per_head, q tile i_first + n %
  // per_head.
  const int per_head = n_q - i_first, n_steps = group * per_head;

  if (threadIdx.x == 0) {
    mbar_init(bkv, 1);
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      mbar_init(bf + 8 * i, 1 + 32);  // TMA's expect_tx + warp 1's lanes
      mbar_init(be + 8 * i, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kBwdProducerRegs));
    const int pw = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0 && n_steps > 0) {
      // Warp 0, one thread: K and V once, then Q and dO a step.
      prefetch_map(&tq);
      prefetch_map(&tk);
      prefetch_map(&tv);
      prefetch_map(&tdo);
      mbar_expect_tx(bkv, 2 * KV::kBytes);
#pragma unroll
      for (int c = 0; c < KV::kChunks; ++c) {
        tma_load(sk + c * KV::kChunkBytes, &tk, bkv, c * KV::kCW, hk, k0, b);
        tma_load(sv + c * KV::kChunkBytes, &tv, bkv, c * KV::kCW, hk, k0, b);
      }
      for (int n = 0; n < n_steps; ++n) {
        const int st = n % kS;
        const int hq = hk * group + n / per_head;
        const int q0 = (i_first + n % per_head) * kBwdRows;
        const uint32_t dst = sq + st * L::kStage;
        mbar_wait(be + 8 * st, ((n / kS) & 1) ^ 1);
        mbar_expect_tx(bf + 8 * st, L::kStage);
#pragma unroll
        for (int c = 0; c < QO::kChunks; ++c) {
          tma_load(dst + c * QO::kChunkBytes, &tq, bf + 8 * st, c * QO::kCW,
                   hq, q0, b);
          tma_load(dst + QO::kBytes + c * QO::kChunkBytes, &tdo, bf + 8 * st,
                   c * QO::kCW, hq, q0, b);
        }
      }
    } else if (pw == 1) {
      // Warp 1: each step's lse and delta into the same stage; rows past S
      // get lse +inf (P = 0) and delta 0.
      for (int n = 0; n < n_steps; ++n) {
        const int st = n % kS;
        const int hq = hk * group + n / per_head;
        const int q0 = (i_first + n % per_head) * kBwdRows;
        const size_t at = (static_cast<size_t>(b) * h + hq) * s;
        mbar_wait(be + 8 * st, ((n / kS) & 1) ^ 1);
#pragma unroll
        for (int r = lane; r < kBwdRows; r += 32) {
          const bool in = q0 + r < s;
          ls[st][r] = in ? lse[at + q0 + r] * kLog2e : INFINITY;
          dls[st][r] = in ? delta[at + q0 + r] : 0.f;
        }
        mbar_arrive(bf + 8 * st);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kBwdConsumerRegs));
    const int w = wg - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, qd = lane % 4;
    const int kw0 = k0 + 64 * w;  // this warpgroup's first key
    const int kr0 = kw0 + 16 * warp + g, kr1 = kr0 + 8;
    const uint32_t k_wg = sk + 64 * w * KV::kRowBytes;
    const uint32_t v_wg = sv + 64 * w * KV::kRowBytes;
    const float scale2 = scale * kLog2e;

    float dka[D / 2], dva[D / 2], sct[kBwdRows / 2], dpt[kBwdRows / 2];
    uint32_t pa[kBwdRows / 4], sa[kBwdRows / 4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kBwdRows / 2; ++i) sct[i] = dpt[i] = 0.f;

    if (n_steps > 0) mbar_wait(bkv, 0);
    for (int n = 0; n < n_steps; ++n) {
      const int st = n % kS;
      const int q0 = (i_first + n % per_head) * kBwdRows;
      const uint32_t q_st = sq + st * L::kStage, do_st = q_st + QO::kBytes;
      mbar_wait(bf + 8 * st, (n / kS) & 1);
      fence_regs(sct);
      fence_regs(dpt);
      wgmma_fence();
      mma_abt<D, kN, kBwdRows>(sct, k_wg, q_st);   // S^T = K Q^T
      mma_abt<D, kN, kBwdRows>(dpt, v_wg, do_st);  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sct);
      fence_regs(dpt);
      // P^T and dS^T = P^T o (dP^T - delta); the causal mask only where
      // the tile crosses the diagonal (a key past its q row).
      const bool diag = causal && kw0 + 63 > q0;
#pragma unroll
      for (int i = 0; i < kBwdRows / 2; ++i) {
        const int col = (i / 4) * 8 + 2 * qd + (i & 1);
        const int key = (i & 2) ? kr1 : kr0;
        float p = exp2_ftz(fmaf(sct[i], scale2, -ls[st][col]));
        if (diag && key > q0 + col) p = 0.f;
        sct[i] = p;
        dpt[i] = p * (dpt[i] - dls[st][col]);
      }
      pack_frags(sct, pa);
      pack_frags(dpt, sa);
      wgmma_fence();
      mma_ab<D, kBwdRows>(dva, pa, do_st);  // dV += P^T dO
      mma_ab<D, kBwdRows>(dka, sa, q_st);   // dK += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      mbar_arrive(be + 8 * st);
    }

    const size_t kv_stride = static_cast<size_t>(hkv) * D;
    const size_t off0 = (static_cast<size_t>(b) * skv + kr0) * kv_stride +
                        static_cast<size_t>(hk) * D;
    const size_t off1 = off0 + 8 * kv_stride;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int col = nd * 8 + 2 * qd;
      if (kr0 < skv) {
        *reinterpret_cast<uint32_t*>(dk + off0 + col) =
            pack_bf16(dka[4 * nd] * scale, dka[4 * nd + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off0 + col) =
            pack_bf16(dva[4 * nd], dva[4 * nd + 1]);
      }
      if (kr1 < skv) {
        *reinterpret_cast<uint32_t*>(dk + off1 + col) =
            pack_bf16(dka[4 * nd + 2] * scale, dka[4 * nd + 3] * scale);
        *reinterpret_cast<uint32_t*>(dv + off1 + col) =
            pack_bf16(dva[4 * nd + 2], dva[4 * nd + 3]);
      }
    }
  }
}

// dQ of 128 q rows of one query head (a consumer warpgroup 64 rows), summed
// over the key tiles up to the causal limit in order.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int s, int skv,
                              int h, int hkv, int n_q_tiles, float scale,
                              int causal) {
  using L = DqSmem<D>;
  using T = typename L::T;
  constexpr int kS = L::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kS];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sdo = sq + T::kBytes, skv_ring = sdo + T::kBytes;
  const uint32_t bq = smem_u32(bars), bf = bq + 8, be = bf + 8 * kS;

  // All heads and batches of the last (heaviest causal) q tile first.
  const int per_tile = gridDim.x / n_q_tiles;
  const int iq = n_q_tiles - 1 - static_cast<int>(blockIdx.x) / per_tile;
  const int hb = static_cast<int>(blockIdx.x) % per_tile;
  const int hq = hb % h, b = hb / h;
  const int hk = hq / (h / hkv);
  const int q0 = iq * kM;
  int n_kv = (skv + kN - 1) / kN;
  if (causal) n_kv = min(n_kv, (q0 + kM - 1) / kN + 1);  // to the diagonal

  if (threadIdx.x == 0) {
    mbar_init(bq, 1);
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      mbar_init(bf + 8 * i, 1);
      mbar_init(be + 8 * i, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kBwdProducerRegs));
    if (threadIdx.x == 0) {
      // Q and dO once, then K and V a step.
      prefetch_map(&tq);
      prefetch_map(&tk);
      prefetch_map(&tv);
      prefetch_map(&tdo);
      mbar_expect_tx(bq, 2 * T::kBytes);
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c) {
        tma_load(sq + c * T::kChunkBytes, &tq, bq, c * T::kCW, hq, q0, b);
        tma_load(sdo + c * T::kChunkBytes, &tdo, bq, c * T::kCW, hq, q0, b);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % kS;
        const uint32_t dst = skv_ring + st * 2 * T::kBytes;
        mbar_wait(be + 8 * st, ((j / kS) & 1) ^ 1);
        mbar_expect_tx(bf + 8 * st, 2 * T::kBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
          tma_load(dst + c * T::kChunkBytes, &tk, bf + 8 * st, c * T::kCW,
                   hk, j * kN, b);
          tma_load(dst + T::kBytes + c * T::kChunkBytes, &tv, bf + 8 * st,
                   c * T::kCW, hk, j * kN, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kBwdConsumerRegs));
    const int w = wg - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, qd = lane % 4;
    const int row_first = q0 + 64 * w;
    const int r0 = row_first + 16 * warp + g, r1 = r0 + 8;
    const uint32_t q_wg = sq + 64 * w * T::kRowBytes;
    const uint32_t do_wg = sdo + 64 * w * T::kRowBytes;
    const float scale2 = scale * kLog2e;
    // This thread's two rows' lse (log2 units) and delta; a row past S is
    // never stored, so it reads none.
    const float* lh = lse + (static_cast<size_t>(b) * h + hq) * s;
    const float* dh = delta + (static_cast<size_t>(b) * h + hq) * s;
    const float lse0 = r0 < s ? lh[r0] * kLog2e : 0.f;
    const float lse1 = r1 < s ? lh[r1] * kLog2e : 0.f;
    const float dl0 = r0 < s ? dh[r0] : 0.f, dl1 = r1 < s ? dh[r1] : 0.f;

    float acc[D / 2], sc[kN / 2], dp[kN / 2];
    uint32_t sa[kN / 4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) sc[i] = dp[i] = 0.f;

    mbar_wait(bq, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int st = j % kS, kv0 = j * kN;
      const uint32_t k_st = skv_ring + st * 2 * T::kBytes;
      const uint32_t v_st = k_st + T::kBytes;
      mbar_wait(bf + 8 * st, (j / kS) & 1);
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      mma_abt<D, kM, kN>(sc, q_wg, k_st);   // S = Q K^T
      mma_abt<D, kM, kN>(dp, do_wg, v_st);  // dP = dO V^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      // dS = P o (dP - delta); the mask only on a tile that crosses the
      // diagonal or Skv (zero-filled keys past Skv score 0, not -inf).
      const bool edge =
          kv0 + kN > skv || (causal && kv0 + kN - 1 > row_first);
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        const int col = kv0 + (i / 4) * 8 + 2 * qd + (i & 1);
        const int row = (i & 2) ? r1 : r0;
        float p = exp2_ftz(fmaf(sc[i], scale2, (i & 2) ? -lse1 : -lse0));
        if (edge && (col >= skv || (causal && col > row))) p = 0.f;
        dp[i] = p * (dp[i] - ((i & 2) ? dl1 : dl0));
      }
      pack_frags(dp, sa);
      wgmma_fence();
      mma_ab<D, kN>(acc, sa, k_st);  // dQ += dS K
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(be + 8 * st);
    }

    const size_t q_stride = static_cast<size_t>(h) * D;
    __nv_bfloat16* o0 = dq + (static_cast<size_t>(b) * s + r0) * q_stride +
                        static_cast<size_t>(hq) * D;
    __nv_bfloat16* o1 = o0 + 8 * q_stride;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int col = nd * 8 + 2 * qd;
      if (r0 < s)
        *reinterpret_cast<uint32_t*>(o0 + col) =
            pack_bf16(acc[4 * nd] * scale, acc[4 * nd + 1] * scale);
      if (r1 < s)
        *reinterpret_cast<uint32_t*>(o1 + col) =
            pack_bf16(acc[4 * nd + 2] * scale, acc[4 * nd + 3] * scale);
    }
  }
}

// The bf16 dQ and dK/dV launches at D = 64, 96, 128 (after the delta
// pass). Q and dO are mapped twice: 128-row boxes for dQ, 64-row boxes for
// dK/dV's steps.
template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dq, void* dk, void* dv,
                       int b, int s, int skv, int h, int hkv, bool causal,
                       cudaStream_t stream) {
  if (b == 0 || s == 0 || skv == 0) {  // no (row, key) pair: zero gradients
    const size_t nq = static_cast<size_t>(b) * s * h * D * 2;
    const size_t nkv = static_cast<size_t>(b) * skv * hkv * D * 2;
    cudaError_t err = cudaMemsetAsync(dq, 0, nq, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(dk, 0, nkv, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, nkv, stream);
    return err;
  }
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap mq, mdo, mq64, mdo64, mk, mv;
  if (!encode<D>(enc, &mq, q, b, s, h) ||
      !encode<D>(enc, &mdo, dout, b, s, h) ||
      !encode<D>(enc, &mq64, q, b, s, h, kBwdRows) ||
      !encode<D>(enc, &mdo64, dout, b, s, h, kBwdRows) ||
      !encode<D>(enc, &mk, k, b, skv, hkv) ||
      !encode<D>(enc, &mv, v, b, skv, hkv))
    return cudaErrorInvalidValue;
  static bool dq_opted[kMaxDevices] = {};
  static bool dkv_opted[kMaxDevices] = {};
  cudaError_t err =
      opt_in(flash_bwd_dq_wgmma_kernel<D>, DqSmem<D>::kBytes, dq_opted);
  if (err == cudaSuccess)
    err = opt_in(flash_bwd_dkdv_wgmma_kernel<D>, DkvSmem<D>::kBytes,
                 dkv_opted);
  if (err != cudaSuccess) return err;
  const float scale = static_cast<float>(1.0 / std::sqrt(double(D)));
  const int n_q_tiles = (s + kM - 1) / kM, n_k_tiles = (skv + kN - 1) / kN;
  flash_bwd_dq_wgmma_kernel<D>
      <<<n_q_tiles * h * b, kThreads, DqSmem<D>::kBytes, stream>>>(
          mq, mk, mv, mdo, lse, delta, static_cast<__nv_bfloat16*>(dq), s,
          skv, h, hkv, n_q_tiles, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_wgmma_kernel<D>
      <<<n_k_tiles * hkv * b, kThreads, DkvSmem<D>::kBytes, stream>>>(
          mq64, mk, mv, mdo64, lse, delta, static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), s, skv, h, hkv, n_k_tiles, scale,
          causal);
  return cudaGetLastError();
}

}  // namespace hopper

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv, int b,
                       int s, int skv, int h, int hkv, bool bf16, bool causal,
                       cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const int rows = b * s * h;
  const float scale = static_cast<float>(1.0 / std::sqrt(double(D)));
  const dim3 grid_q((s + kBwdM - 1) / kBwdM, h, b);
  const dim3 grid_kv((skv + kBwdM - 1) / kBwdM, hkv, b);
  if (rows > 0) {
    if (bf16)
      flash_bwd_delta_kernel<bf><<<(rows + 7) / 8, 256, 0, stream>>>(
          static_cast<const bf*>(o), static_cast<const bf*>(dout), delta,
          rows, s, h, D);
    else
      flash_bwd_delta_kernel<float><<<(rows + 7) / 8, 256, 0, stream>>>(
          static_cast<const float*>(o), static_cast<const float*>(dout),
          delta, rows, s, h, D);
  }
  if (bf16) {
    if constexpr (D >= 64) {
      const cudaError_t err = cudaGetLastError();  // the delta pass's
      if (err != cudaSuccess) return err;
      return hopper::launch_bwd<D>(q, k, v, dout, lse, delta, dq, dk, dv, b,
                                   s, skv, h, hkv, causal, stream);
    } else {
      static bool dq_opted[hopper::kMaxDevices] = {};
      static bool dkv_opted[hopper::kMaxDevices] = {};
      cudaError_t err = opt_in(flash_bwd_dq_bf16_kernel<D>, BwdSmem<D>::kDq,
                               dq_opted);
      if (err == cudaSuccess)
        err = opt_in(flash_bwd_dkdv_bf16_kernel<D>, BwdSmem<D>::kDkv,
                     dkv_opted);
      if (err != cudaSuccess) return err;
      if (rows > 0)
        flash_bwd_dq_bf16_kernel<D>
            <<<grid_q, 128, BwdSmem<D>::kDq, stream>>>(
                static_cast<const bf*>(q), static_cast<const bf*>(k),
                static_cast<const bf*>(v), static_cast<const bf*>(dout), lse,
                delta, static_cast<bf*>(dq), s, skv, h, hkv, scale, causal);
      if (skv > 0 && b > 0)
        flash_bwd_dkdv_bf16_kernel<D>
            <<<grid_kv, 128, BwdSmem<D>::kDkv, stream>>>(
                static_cast<const bf*>(q), static_cast<const bf*>(k),
                static_cast<const bf*>(v), static_cast<const bf*>(dout), lse,
                delta, static_cast<bf*>(dk), static_cast<bf*>(dv), s, skv, h,
                hkv, scale, causal);
    }
  } else {
    if (rows > 0)
      flash_bwd_dq_f32_kernel<D><<<grid_q, 256, 0, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(dout), lse,
          delta, static_cast<float*>(dq), s, skv, h, hkv, scale, causal);
    if (skv > 0 && b > 0)
      flash_bwd_dkdv_f32_kernel<D><<<grid_kv, 256, 0, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(dout), lse,
          delta, static_cast<float*>(dk), static_cast<float*>(dv), s, skv, h,
          hkv, scale, causal);
  }
  return cudaGetLastError();
}

}  // namespace

// q (B, S, H, D), k/v (B, Skv, Hkv, D), o (B, S, H, D), all contiguous and
// 16-byte aligned; bf16 != 0 for bfloat16, else float32. lse, when not null,
// receives each row's log-sum-exp of the scaled, masked scores, (B, H, S)
// f32 in natural-log units (the backward's input); O is the same either
// way. Returns nonzero when the launch is refused or, for the wgmma
// kernel, the tensor maps cannot be encoded.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse, int b,
                                   int s, int skv, int h, int hkv, int d,
                                   int bf16, int causal,
                                   cudaStream_t stream) {
  switch (d) {
#define FLASH_FWD_CASE(D)                                                  \
  case D:                                                                  \
    return launch<D>(q, k, v, o, lse, b, s, skv, h, hkv, bf16, causal,     \
                     stream);
    FLASH_FWD_CASE(16)
    FLASH_FWD_CASE(32)
    FLASH_FWD_CASE(64)
    FLASH_FWD_CASE(96)
    FLASH_FWD_CASE(128)
#undef FLASH_FWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward: q, o, dout, dq (B, S, H, D), k, v, dk, dv (B, Skv, Hkv, D),
// lse (the forward's) and delta (scratch) (B, H, S) f32; contiguous and
// 16-byte aligned, bf16 as for the forward. Writes every element of dq, dk
// and dv. Returns nonzero when a launch is refused.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv,
                                   int b, int s, int skv, int h, int hkv,
                                   int d, int bf16, int causal,
                                   cudaStream_t stream) {
  switch (d) {
#define FLASH_BWD_CASE(D)                                                  \
  case D:                                                                  \
    return launch_bwd<D>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, s,   \
                         skv, h, hkv, bf16, causal, stream);
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(96)
    FLASH_BWD_CASE(128)
#undef FLASH_BWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of the wgmma kernel at head dim d (the Q tile, the
// K/V ring and 1 KB of alignment slack), or 0 for a d it does not take.
extern "C" int flash_attention_wgmma_smem(int d) {
  switch (d) {
    case 64:
      return hopper::Tile<64>::kSmem;
    case 96:
      return hopper::Tile<96>::kSmem;
    case 128:
      return hopper::Tile<128>::kSmem;
    default:
      return 0;
  }
}
