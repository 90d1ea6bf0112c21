// Flash-attention forward: GQA, optional causal mask, online softmax.
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
// Bound: matrix products. At the serving shapes (Qwen2-7B prefill, S = 2048,
// H = 28, Hkv = 4, D = 128, bf16) the causal half is 4 S^2/2 H D = 30 GFLOP
// against 34 MB of Q, K, V and O: ~900 operations a byte, far above the
// ~295 at which the tensor cores, not memory, set the pace. So bf16 runs on
// the tensor cores (mma.sync m16n8k16, f32 accumulate) and never writes the
// scores to memory. Design, simple first (no TMA, wgmma or pipelining yet):
//   * one CTA per (64-row q tile, head, batch); the KV loop stops at the
//     causal limit (kernel.py:40-42), so the work is the causal half;
//   * bf16: 4 warps of 16 q rows; Q fragments stay in registers; each 64-row
//     K tile and transposed V tile is staged through padded shared memory
//     (35 KB at D = 128, conflict-free fragment reads); S = Q K^T and
//     O += P V are mma.sync, P rounded to bf16 for the second product;
//     row max and sum by quad shuffles; m, l and O in registers;
//   * f32 (no f32 tensor-core path keeps the reference's digits): 4 threads
//     per q row, each holding a quarter of q and O (dims sub, sub + 4, ...),
//     dot products on the CUDA cores over 32-row K/V tiles in shared memory.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlockM = 64;     // q rows per CTA
constexpr int kBlockNBf16 = 64;  // kv rows per tile, bf16
constexpr int kBlockNF32 = 32;   // kv rows per tile, f32
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

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
                          __nv_bfloat16* __restrict__ o, int s, int skv,
                          int h, int hkv, float scale, bool causal) {
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
}

// f32: 4 threads per q row (adjacent lanes), thread `sub` holding dims
// sub, sub + 4, ...: a warp's reads of a K/V row are 4 consecutive words,
// each broadcast to 8 threads.
template <int D>
__global__ void __launch_bounds__(256)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int s, int skv, int h, int hkv, float scale,
                         bool causal) {
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
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int s, int skv, int h, int hkv, bool bf16,
                   bool causal, cudaStream_t stream) {
  const dim3 grid((s + kBlockM - 1) / kBlockM, h, b);
  const float scale = static_cast<float>(1.0 / std::sqrt(double(D)));
  if (bf16) {
    flash_fwd_bf16_kernel<D><<<grid, 128, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        s, skv, h, hkv, scale, causal);
  } else {
    flash_fwd_f32_kernel<D><<<grid, 256, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), s, skv, h, hkv,
        scale, causal);
  }
  return cudaGetLastError();
}

}  // namespace

// q (B, S, H, D), k/v (B, Skv, Hkv, D), o (B, S, H, D), all contiguous and
// 16-byte aligned; bf16 != 0 for bfloat16, else float32.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int b, int s,
                                   int skv, int h, int hkv, int d, int bf16,
                                   int causal, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<16>(q, k, v, o, b, s, skv, h, hkv, bf16, causal, stream);
    case 32:
      return launch<32>(q, k, v, o, b, s, skv, h, hkv, bf16, causal, stream);
    case 64:
      return launch<64>(q, k, v, o, b, s, skv, h, hkv, bf16, causal, stream);
    case 96:
      return launch<96>(q, k, v, o, b, s, skv, h, hkv, bf16, causal, stream);
    case 128:
      return launch<128>(q, k, v, o, b, s, skv, h, hkv, bf16, causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
